"""PyTorch port parity: the student model's modules of thinktwice_tpu_torch
against their flax modules in thinktwice_tpu, on the CPU, in float32.

Each flax module is built with dtype=None (float32 compute), initialised,
its parameters perturbed with seeded noise (so a bias or a scale mapped to
the wrong place shows), converted with the port's own converter
(`weights.student_state_dict_from_flax`) and run on the same numpy inputs.
Outputs agree to 1e-4 of their scale (float32 sums in another order).
The shapes hit the hazards: stride-2 "SAME" convs on even inputs (flax pads
(0, 1)), on odd inputs ((1, 1)), group norms (epsilon 1e-6), the
rematerialized backbone names. The decoder and the archive's conversion are
held in tests/test_torch_decoder.py, the whole model in bfloat16 in
tests/test_torch_model_full.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinktwice_tpu.config import ModelConfig as JaxModelConfig
from thinktwice_tpu.models import decoder as jdec
from thinktwice_tpu.models import layers as jlayers
from thinktwice_tpu.models import lidarnet as jlidar
from thinktwice_tpu.models import lss as jlss
from thinktwice_tpu.models import resnet as jresnet
from thinktwice_tpu.models.encoder_decoder import bev_to_bird as jax_bev_to_bird
from thinktwice_tpu.ops.deform_attn import ms_deform_attn as jax_ms_deform_attn
from thinktwice_tpu.ops.grid_sample import grid_sample_norm as jax_grid_sample_norm
from thinktwice_tpu.ops.voxel_pool import lift_splat_pool as jax_lift_splat_pool
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.models import decoder as dec
from thinktwice_tpu_torch.models import layers
from thinktwice_tpu_torch.models import lidarnet
from thinktwice_tpu_torch.models import lss
from thinktwice_tpu_torch.models import resnet
from thinktwice_tpu_torch.models.encoder_decoder import bev_to_bird
from thinktwice_tpu_torch.ops.deform_attn import ms_deform_attn
from thinktwice_tpu_torch.ops.grid_sample import grid_sample_norm
from thinktwice_tpu_torch.ops.voxel_pool import lift_splat_pool
from thinktwice_tpu_torch.weights import student_state_dict_from_flax

torch.set_num_threads(1)

TOL = 1e-4   # of the output's scale
SMALL = dict(img_height=32, img_width=64, refine_num=2, pred_len=2, bev_channels=64,
             n_depth_bins=16, lidar_pillar_grid=84, n_z_anchors=5, n_attn_heads=4)


def nchw(a):
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, (err, scale)


def paired(fmod, tmod, *args, seed=0, **kw):
    """Init fmod on args, perturb its params, load them into tmod. ->
    (variables, flax output). Init and apply run jitted: one trace and one
    compile each, where op-by-op dispatch compiles every primitive."""
    variables = jax.jit(functools.partial(fmod.init, **kw))(jax.random.key(seed), *args)
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
        variables)
    tmod.load_state_dict(student_state_dict_from_flax(variables, tmod), strict=True)
    tmod.eval()
    return variables, jax.jit(functools.partial(fmod.apply, **kw))(variables, *args)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("hw,stride,kernel", [((16, 24), 2, 3), ((15, 21), 2, 3),
                                              ((16, 24), 1, 3), ((15, 21), 2, 1)])
def test_conv_gn(hw, stride, kernel):
    x = rand(2, *hw, 24)
    t = layers.ConvGN(24, 32, kernel=kernel, stride=stride)
    _, ref = paired(jlayers.ConvGN(32, kernel=kernel, stride=stride), t, jnp.asarray(x))
    assert_close(nhwc(t(nchw(x))), ref)


def test_se_basic_block_and_mlp():
    x = rand(2, 9, 9, 24)
    t = layers.SEBasicBlock(24, 32)
    _, ref = paired(jlayers.SEBasicBlock(32), t, jnp.asarray(x))
    assert_close(nhwc(t(nchw(x))), ref)
    v = rand(3, 20)
    t = layers.MLP(20, [16, 8, 4], final_act=True)
    _, ref = paired(jlayers.MLP([16, 8, 4], final_act=True), t, jnp.asarray(v))
    assert_close(t(torch.as_tensor(v)).detach(), ref)


@pytest.mark.parametrize("block,cin,f", [("BasicBlock", 32, 64), ("Bottleneck", 64, 128)])
def test_residual_blocks(block, cin, f):
    x = rand(2, 12, 18, cin)
    t = getattr(resnet, block)(cin, f, stride=2)
    _, ref = paired(getattr(jresnet, block)(f, stride=2), t, jnp.asarray(x))
    assert_close(nhwc(t(nchw(x))), ref)


def test_resnet10_and_pafpn():
    x = rand(2, 32, 64, 3)
    t = resnet.ResNet(10)
    _, refs = paired(jresnet.ResNet(10), t, jnp.asarray(x))
    outs = t(nchw(x))
    for o, r in zip(outs, refs):
        assert_close(nhwc(o), r)
    feats = [rand(2, 16 // 2 ** i, 32 // 2 ** i, w, seed=i) for i, w in
             enumerate((32, 64, 128, 256))]
    t = resnet.PAFPN([32, 64, 128, 256], 64)
    _, refs = paired(jresnet.PAFPN(64), t, [jnp.asarray(f) for f in feats])
    for o, r in zip(t([nchw(f) for f in feats]), refs):
        assert_close(nhwc(o), r)


def test_depthnet_aspp_seghead():
    x = rand(2, 4, 8, 64)
    cam = rand(2, 27, seed=1)
    t = lss.DepthNet(64, 16, 48, mid_channels=32)
    _, (rd, rc) = paired(jlss.DepthNet(16, 48, mid_channels=32), t, jnp.asarray(x),
                         jnp.asarray(cam))
    d, c = t(nchw(x), torch.as_tensor(cam))
    assert_close(nhwc(d), rd)
    assert_close(nhwc(c), rc)
    feats = [rand(2, 8 // 2 ** i, 16 // 2 ** i, 256, seed=i) for i in range(4)]
    t = lss.SegHead(12, 256)
    _, (rs, rf) = paired(jlss.SegHead(12), t, [jnp.asarray(f) for f in feats])
    s, f = t([nchw(f) for f in feats])
    assert_close(nhwc(s), rs)
    assert_close(nhwc(f), rf)


def test_frustum_and_pool():
    jm, m = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    np.testing.assert_allclose(lss.make_frustum(m, 2, 4).numpy(),
                               np.asarray(jlss.make_frustum(jm, 2, 4)), rtol=1e-6)
    from thinktwice_tpu.models import rig as jrig
    from thinktwice_tpu.config import CameraConfig as JaxCameraConfig

    jc = JaxCameraConfig(height=32, width=64)
    c2e, K = jrig.cam_to_ego(jc), jrig.intrinsics(jc)
    fr = jlss.make_frustum(jm, 2, 4)
    ref = np.stack([np.asarray(jlss.frustum_to_ego(fr, jnp.asarray(c), jnp.linalg.inv(K)))
                    for c in c2e])
    port = lss.frustum_to_ego(torch.as_tensor(np.asarray(fr)), torch.as_tensor(c2e),
                              torch.linalg.inv(torch.as_tensor(K)))
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-4)
    rng = np.random.default_rng(3)
    N, D, HW, C = 2, 16, 8, 24
    geom = np.concatenate([rng.uniform(-12, 34, (N, D, HW, 2)),
                           rng.uniform(-6, 12, (N, D, HW, 1))], -1).astype(np.float32)
    dp = rng.uniform(size=(2, N, D, HW)).astype(np.float32)
    ctx = rand(2, N, HW, C)
    cell = (m.bev_x_max - m.bev_x_min) / m.bev_size
    kw = dict(x_min=m.bev_x_min, y_min=m.bev_y_min, cell=cell, nx=21, ny=21,
              z_min=-4.0, z_max=10.0)
    port = lift_splat_pool(torch.as_tensor(geom)[None], torch.as_tensor(dp),
                           torch.as_tensor(ctx), **kw)
    for b in range(2):
        ref = jax_lift_splat_pool(jnp.asarray(geom), jnp.asarray(dp[b]), jnp.asarray(ctx[b]), **kw)
        assert_close(port[b], ref)


def test_pillarize_matches_jax():
    m, jm = ModelConfig(**SMALL), JaxModelConfig(**SMALL)
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(-10, 32, (2, 600, 2)), rng.uniform(-2, 3, (2, 600, 3))],
                         -1).astype(np.float32)
    mask = rng.uniform(size=(2, 600)) > 0.2
    port = lidarnet.pillarize(torch.as_tensor(pts), torch.as_tensor(mask), m)
    for b in range(2):
        ref = jlidar.pillarize(jnp.asarray(pts[b]), jnp.asarray(mask[b]), jm)
        np.testing.assert_allclose(port[b].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_sampling_ops_match_jax():
    img = rand(2, 6, 9, 5)
    coords = np.random.default_rng(5).uniform(-1.3, 1.3, (2, 7, 2)).astype(np.float32)
    port = grid_sample_norm(torch.as_tensor(img), torch.as_tensor(coords))
    for b in range(2):
        assert_close(port[b], jax_grid_sample_norm(jnp.asarray(img[b]), jnp.asarray(coords[b])))
    shapes = ((4, 6), (2, 3))
    value = rand(2, 30, 16)
    rng = np.random.default_rng(6)
    locs = rng.uniform(-0.1, 1.1, (2, 5, 4, 2, 3, 2)).astype(np.float32)
    w = rng.uniform(size=(2, 5, 4, 2, 3)).astype(np.float32)
    port = ms_deform_attn(torch.as_tensor(value), shapes, torch.as_tensor(locs),
                          torch.as_tensor(w))
    assert_close(port, jax_ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(locs),
                                          jnp.asarray(w)))
    bev = rand(2, 5, 7, 3)
    np.testing.assert_array_equal(nhwc(bev_to_bird(nchw(bev))),
                                  np.asarray(jax_bev_to_bird(jnp.asarray(bev))))
    x = np.linspace(-1, 30, 50).astype(np.float32)
    np.testing.assert_allclose(dec.inv_softplus(torch.as_tensor(x)).numpy(),
                               np.asarray(jdec.inv_softplus(jnp.asarray(x))), rtol=1e-5)
