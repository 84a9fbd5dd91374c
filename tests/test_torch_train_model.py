"""PyTorch port parity: the student's training forward of
thinktwice_tpu_torch against thinktwice_tpu's on the CPU.

- float32 (flax dtype=None): `frustum_to_ego` and `project_to_cams` with
  IDA matrices, and the decoder cascade of 2 refine layers with the teacher
  pass (teacher waypoints and controls) and IDA. Outputs, the teacher's
  included, and the gradients of a fixed random projection of every output
  with respect to every parameter agree to 1e-4 of their scale. The same
  check on a copy of the cascade without the detach of each layer's input
  waypoints and controls fails: the detach is what the reference's
  stop_gradient does.

The whole model's training forward and gradients are held in
tests/test_torch_train_model_full.py.
"""

from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_model import SMALL, assert_close, nchw, rand
from thinktwice_tpu.config import CameraConfig as JaxCameraConfig
from thinktwice_tpu.config import ModelConfig as JaxModelConfig
from thinktwice_tpu.models import decoder as jdec
from thinktwice_tpu.models import lss as jlss
from thinktwice_tpu.models import rig as jrig
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.models import decoder as dec
from thinktwice_tpu_torch.models import lss
from thinktwice_tpu_torch.weights import student_state_dict_from_flax

torch.set_num_threads(1)

TOL = 1e-4
CAMS = dict(height=32, width=64, n_cams=2, cam_yaws=(0.0, 180.0))


def ida_mats(B, N, H, W, seed=0):
    """Seeded IDA matrices: scale in [1, 1.15), crops, some flipped."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(1.0, 1.15, (B, N))
    crop_w = rng.uniform(size=(B, N)) * (s * W - W)
    flip = rng.uniform(size=(B, N)) < 0.5
    flip.flat[0] = True
    ida = np.zeros((B, N, 4, 4), np.float32)
    ida[..., 0, 0] = np.where(flip, -s, s)
    ida[..., 1, 1] = s
    ida[..., 0, 3] = np.where(flip, (W - 1.0) + crop_w, -crop_w)
    ida[..., 1, 3] = -(s * H - H)
    ida[..., 2, 2] = ida[..., 3, 3] = 1.0
    return ida


def random_params(shapes, seed=0):
    """Seeded parameters for a flax tree of ShapeDtypeStructs, at the scale
    of flax's init, every leaf nonzero (so a bias or a scale mapped to the
    wrong place shows): kernels normal / sqrt(fan_in), norm scales 1 + noise,
    biases noise, embeddings 0.02 normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = getattr(path[-1], "key", "")
        z = rng.standard_normal(x.shape).astype(np.float32)
        if name == "kernel":
            return z / np.sqrt(np.prod(x.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.05 * z
        if name == "bias":
            return 0.05 * z
        return 0.02 * z

    return jax.tree_util.tree_map_with_path(lambda p, x: leaf(p, x).astype(np.float32), shapes)


def test_frustum_and_projection_with_ida_match_jax():
    jm, m = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    jc = JaxCameraConfig(**CAMS)
    c2e, K, e2i = jrig.cam_to_ego(jc), jrig.intrinsics(jc), jrig.ego_to_img(jc)
    ida = ida_mats(2, 2, 32, 64)
    fr = jlss.make_frustum(jm, 2, 4)
    ref = jax.vmap(jax.vmap(lambda c, a: jlss.frustum_to_ego(fr, c, jnp.linalg.inv(K), a),
                            in_axes=(0, 0)), in_axes=(None, 0))(jnp.asarray(c2e), jnp.asarray(ida))
    port = lss.frustum_to_ego(torch.tensor(np.asarray(fr)), torch.as_tensor(c2e),
                              torch.linalg.inv(torch.as_tensor(K)), torch.as_tensor(ida))
    assert_close(port, ref, 1e-6)
    pts = rand(2, 30, 3, seed=4, scale=10.0)
    ref_uv, ref_valid = jdec.project_to_cams(jnp.asarray(pts), jnp.asarray(e2i), (32, 64),
                                             ida=jnp.asarray(ida))
    uv, valid = dec.project_to_cams(torch.as_tensor(pts), torch.as_tensor(e2i), (32, 64),
                                    ida=torch.as_tensor(ida))
    assert_close(uv, ref_uv, 1e-6)
    assert np.array_equal(valid.numpy(), np.asarray(ref_valid))
    assert 0 < valid.sum() < valid.numel()


class _JaxDecoder(fnn.Module):
    """The flax decoder with the BEV pyramid it shares, as the model holds
    them, with the teacher pass and IDA."""

    cfg: JaxModelConfig

    @fnn.compact
    def __call__(self, flat, bev32, meas, e2i, maps, flat_vals, lidar_hr, twp, tctrl, ida):
        pyramid = jdec.BEVPyramid(name="bev_pyramid")
        shapes = tuple((m.shape[2], m.shape[3]) for m in maps)
        return jdec.ThinkTwiceDecoder(self.cfg, name="decoder")(
            flat, bev32, meas, e2i, {"maps": maps, "flat": flat_vals}, shapes, pyramid,
            lidar_hr, teacher_wp=twp, teacher_ctrl_sp=tctrl, ida=ida)


class _Decoder(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.bev_pyramid = dec.BEVPyramid()
        self.decoder = dec.ThinkTwiceDecoder(cfg)

    def forward(self, flat, bev32, meas, e2i, maps, flat_vals, twp, tctrl, ida):
        shapes = tuple(tuple(m.shape[2:4]) for m in maps)
        return self.decoder(flat, bev32, meas, e2i, {"maps": maps, "flat": flat_vals},
                            shapes, self.bev_pyramid, teacher_wp=twp, teacher_ctrl_sp=tctrl,
                            ida=ida)


BEV_KEYS = ("refine_BEV_feature", "refine_future_BEV_feature",
            "teacher_future_BEV_feature", "teacher_refine_BEV_feature")


def _bird_last(key, t):
    """The port's NCHW feature stacks in the JAX package's channels-last."""
    return t.movedim(-3, -1) if key in BEV_KEYS else t


def _projection(outs, keys, xp):
    """A fixed random projection of every output to one scalar."""
    total = 0.0
    for i, k in enumerate(keys):
        w = np.random.default_rng(100 + i).standard_normal(tuple(outs[k].shape))
        total = total + xp.sum(outs[k] * xp.asarray(w.astype(np.float32), dtype=outs[k].dtype))
    return total


def test_decoder_teacher_pass_and_gradients_match_flax():
    jm, m = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    B, N, T = 2, 2, SMALL["pred_len"]
    e2i = jrig.ego_to_img(JaxCameraConfig(**CAMS))
    shapes = ((8, 16), (4, 8), (2, 4), (1, 2))
    maps = [rand(B, N, h, w, 256, seed=i) for i, (h, w) in enumerate(shapes)]
    flat_vals = np.ascontiguousarray(
        np.concatenate([mp.reshape(B, N, -1, 256) for mp in maps], 2).swapaxes(0, 1))
    twp = rand(B, T, 2, seed=11, scale=4.0)
    tctrl = np.abs(rand(B, T, 4, seed=12)) + 0.3
    ida = ida_mats(B, N, 32, 64, seed=3)
    args = [rand(B, 256, seed=7), rand(B, 21, 21, 32, seed=8), rand(B, 128, seed=9), e2i,
            maps, flat_vals, rand(B, 84, 84, 512, seed=10), twp, tctrl, ida]
    fmod = _JaxDecoder(jm)
    variables = random_params(jax.eval_shape(fmod.init, jax.random.key(0),
                                             *jax.tree.map(jnp.asarray, args)))
    # the reference in float64: flax's GroupNorm takes the variance as
    # E[x^2] - E[x]^2, whose float32 rounding moves some conv gradients of
    # the pyramid by 1% (torch's group_norm does not cancel that way)
    with jax.enable_x64(True):
        j64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), (variables, args))
        keys = sorted(k for k in jax.eval_shape(fmod.apply, *j64[:1], *j64[1])
                      if k.startswith(("pred_", "mu_", "sigma_", "future_", "refine_",
                                       "teacher_")))
        ref_grads, ref = jax.jit(jax.grad(
            lambda v: (lambda o: (_projection(o, keys, jnp), o))(fmod.apply(v, *j64[1])),
            has_aux=True))(j64[0])
        ref = jax.tree.map(np.asarray, ref)
        ref_grads = jax.tree.map(lambda x: np.asarray(x, np.float32), ref_grads)
    assert {"teacher_pred_wp_offset", "teacher_pred_ctrl_offset", "teacher_future_BEV_feature",
            "teacher_refine_BEV_feature", "teacher_refine_flat_feature"} <= set(keys)

    t = _Decoder(m)
    want = student_state_dict_from_flax(variables, t)
    t.load_state_dict(want, strict=True)
    ref_g = student_state_dict_from_flax(ref_grads, t)

    def run():
        targs = [torch.as_tensor(a) for a in args[:4]]
        targs[1] = nchw(args[1])
        out = t(*targs, [torch.as_tensor(mp) for mp in maps], torch.as_tensor(flat_vals),
                *(torch.as_tensor(a) for a in (twp, tctrl, ida)))
        out = {k: _bird_last(k, v) for k, v in out.items()}
        t.zero_grad()
        _projection(out, keys, torch).backward()
        return out, {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                     for k, p in t.named_parameters()}

    def grads_match(grads):
        for k, g_ref in ref_g.items():
            scale = float(np.abs(g_ref.numpy()).max())
            if scale == 0.0:                        # the zeroed lidar look branch
                assert not grads[k].any(), k
            elif float(np.abs(grads[k] - g_ref.numpy()).max()) > TOL * scale:
                return False
        return True

    out, grads = run()
    for k in keys:
        assert_close(out[k].detach(), ref[k])
    assert grads_match(grads)
    # without the detach at each refine layer the gradients differ
    with mock.patch.object(torch.Tensor, "detach", lambda self: self):
        _, grads_no_detach = run()
    assert not grads_match(grads_no_detach)
