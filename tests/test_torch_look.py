"""PyTorch port parity: the look module's all-camera ops of
thinktwice_tpu_torch against the JAX package's per-camera functions, on the
CPU, in float32.

The port samples every camera in one call of each op (`ops/deform_attn.py`
`deform_attn_cams`, `ops/grid_sample.py` `sample_levels`; K3 and K4 on the
card, their plain versions here), where the JAX package loops over the
cameras and levels. Locations and points reach outside the maps: the image's
corners, a pixel off each edge and far away. Outputs agree to 1e-4 of their
scale, as tests/test_torch_model.py's modules; the decoder's cascade is held
in tests/test_torch_decoder.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import assert_close, paired, rand
from thinktwice_tpu.models import decoder as jdec
from thinktwice_tpu.ops.deform_attn import ms_deform_attn as jax_ms_deform_attn
from thinktwice_tpu.ops.grid_sample import grid_sample_norm as jax_grid_sample_norm
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.models import decoder as dec
from thinktwice_tpu_torch.ops import deform_attn, grid_sample

torch.set_num_threads(1)

SHAPES = ((6, 10), (3, 5), (2, 3), (1, 2))


def points(B, N, Q, seed):
    """(B, N, Q, 2) float32 over [-0.3, 1.3]; camera 0 of world 0 holds the
    corners (0, 0) and (1, 1), a pixel of the finest level off the left and
    right edges, and a point far outside."""
    p = np.random.default_rng(seed).uniform(-0.3, 1.3, (B, N, Q, 2)).astype(np.float32)
    w0 = SHAPES[0][1]
    p[0, 0, :5] = [[0.0, 0.0], [1.0, 1.0], [-1.0 / w0, 0.5], [1.0 + 1.0 / w0, 0.5],
                   [1e6, -1e6]]
    return p


def value_cams(B, N, C, seed):
    """(N, B, sum HW, C) as the student makes it: a transposed view of
    (B, N, sum HW, C)."""
    rows = sum(h * w for h, w in SHAPES)
    return torch.as_tensor(rand(B, N, rows, C, seed=seed)).transpose(0, 1)


@pytest.mark.parametrize("heads,n_points", [(4, 3), (2, 1)])
def test_deform_attn_cams_matches_jax_per_camera(heads, n_points):
    B, N, Q, C = 2, 3, 7, 16
    value = value_cams(B, N, C, 0)
    ref = points(B, N, Q, 1)
    off = rand(B, N, Q, heads, len(SHAPES), n_points, 2, seed=2, scale=3.0)
    w = np.random.default_rng(3).uniform(size=(B, N, Q, heads, len(SHAPES), n_points)) \
        .astype(np.float32)
    before = deform_attn.K3.launches
    port = deform_attn.deform_attn_cams(value, SHAPES, torch.as_tensor(ref),
                                        torch.as_tensor(off), torch.as_tensor(w))
    assert deform_attn.K3.launches == before          # the plain version on the CPU
    assert port.shape == (B, N, Q, C)
    norm = jnp.asarray([[wl, hl] for hl, wl in SHAPES], jnp.float32)
    for c in range(N):
        locs = jnp.asarray(ref[:, c])[:, :, None, None, None, :] \
            + jnp.asarray(off[:, c]) / norm[None, None, None, :, None, :]
        want = jax_ms_deform_attn(jnp.asarray(value[c].numpy()), SHAPES, locs,
                                  jnp.asarray(w[:, c]))
        assert_close(port[:, c], want)


def test_ms_deform_attn_module_all_cameras_matches_flax():
    """One MSDeformAttn call over every camera (one GEMM each for the
    offsets, the weights and the output projection) against the flax module
    applied camera by camera."""
    B, N, Q, dim = 2, 3, 5, 32
    value = value_cams(B, N, dim, 4)
    q = rand(B, N, Q, dim, seed=5)
    ref = points(B, N, Q, 6)
    fmod = jdec.MSDeformAttn(dim, n_heads=4, n_levels=len(SHAPES), n_points=2)
    t = dec.MSDeformAttn(dim, 4, len(SHAPES), 2)
    variables, _ = paired(fmod, t, jnp.asarray(q[:, 0]), jnp.asarray(ref[:, 0]),
                          jnp.asarray(value[0].numpy()), spatial_shapes=SHAPES)
    port = t(torch.as_tensor(q), torch.as_tensor(ref), value, SHAPES).detach()
    apply = jax.jit(functools.partial(fmod.apply, spatial_shapes=SHAPES))
    for c in range(N):
        assert_close(port[:, c], apply(variables, jnp.asarray(q[:, c]), jnp.asarray(ref[:, c]),
                                       jnp.asarray(value[c].numpy())))


def test_spatial_cross_attention_matches_flax():
    """The all-camera lookup, the masked camera reduction and the query
    pooling against the flax module's camera loop; one query seen by no
    camera and one world's camera 1 seeing nothing."""
    B, N, Q, Dq, dim = 2, 3, 6, 24, 32
    queries = rand(B, N, Q, Dq, seed=7)
    ref = points(B, N, Q, 8)
    valid = (np.random.default_rng(9).uniform(size=(B, N, Q)) > 0.3).astype(np.float32)
    valid[:, :, 0] = 0.0
    valid[1, 1] = 0.0
    value = value_cams(B, N, dim, 10)
    fmod = jdec.SpatialCrossAttention(dim, n_heads=4)
    t = dec.SpatialCrossAttention(Dq, dim, 4)
    _, want = paired(fmod, t, jnp.asarray(queries), jnp.asarray(ref), jnp.asarray(valid),
                     jnp.asarray(np.ascontiguousarray(value.numpy())), spatial_shapes=SHAPES)
    port = t(torch.as_tensor(queries), torch.as_tensor(ref), torch.as_tensor(valid), value,
             SHAPES)
    assert_close(port.detach(), want)


def test_sample_levels_matches_jax_per_camera_and_level():
    B, N, Q, C = 2, 3, 9, 5
    maps = [rand(B, N, h, w, C, seed=11 + i) for i, (h, w) in enumerate(SHAPES)]
    ref = points(B, N, Q, 12)
    before = grid_sample.K4.launches
    port = grid_sample.sample_levels([torch.as_tensor(m) for m in maps], torch.as_tensor(ref))
    assert grid_sample.K4.launches == before          # the plain version on the CPU
    assert port.dtype == torch.float32 and port.shape == (B, N, Q, len(SHAPES) * C)
    for b in range(B):
        for c in range(N):
            want = np.concatenate([np.asarray(jax_grid_sample_norm(
                jnp.asarray(m[b, c]), jnp.asarray(ref[b, c]) * 2.0 - 1.0)) for m in maps], -1)
            assert_close(port[b, c], want)
    assert not bool(port[0, 0, 4].any())              # far outside: every tap zero


def test_look_anchors_are_built_once_a_device():
    """The look module's static anchor points and Z heights are made at its
    first call on a device and reused after (on the card a tensor made from
    a list is a blocking copy)."""
    look = dec.LookModule(ModelConfig(n_z_anchors=5))
    pts, zs = look.anchors(torch.device("cpu"))
    again = look.anchors(torch.device("cpu"))
    assert again[0] is pts and again[1] is zs
    assert pts.tolist() == [list(p) for p in dec.STATIC_PTS]
    np.testing.assert_allclose(zs.numpy(), np.linspace(-4.0, 10.0, 5), rtol=1e-6)
