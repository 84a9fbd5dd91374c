"""PyTorch port parity: the whole ThinkTwice student of thinktwice_tpu_torch
against thinktwice_tpu's on the CPU, with bfloat16 where the flax model
computes in bfloat16.

The shapes are the JAX package's frozen dry-run shapes
(`__graft_entry__._DRYRUN_FROZEN`: 2 cameras of 32 x 64, ResNet-10, 16
depth bins, a pillar grid of 84, one refine layer, 2 future steps) with two
sweeps, the history sweep moved by a sweep-to-key transform. The
parameters come from a flax init through the port's converter. Both
packages round to bfloat16 at the same places but in other orders (a
torch conv adds its bias before rounding, XLA after), so pred_wp,
mu_branches, sigma_branches and the depth and segmentation logits agree to
5e-2 of their scale; the measurement encoder, which is float32 in both,
to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from thinktwice_tpu.config import CameraConfig as JaxCameraConfig
from thinktwice_tpu.config import ModelConfig as JaxModelConfig
from thinktwice_tpu.models import rig as jrig
from thinktwice_tpu.models.encoder_decoder import ThinkTwiceModel as JaxThinkTwiceModel
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel
from thinktwice_tpu_torch.weights import student_state_dict_from_flax

torch.set_num_threads(1)

FROZEN = dict(img_height=32, img_width=64, refine_num=1, pred_len=2, bev_channels=64,
              n_depth_bins=16, lidar_pillar_grid=84, n_z_anchors=5, n_attn_heads=4)
CAMS = dict(height=32, width=64, n_cams=2, cam_yaws=(0.0, 180.0))
BF16_TOL = 5e-2      # of each output's scale
F32_TOL = 1e-5


def inputs(B=2, T=2, N=2, P=256, seed=0):
    rng = np.random.default_rng(seed)
    jc = JaxCameraConfig(**CAMS)
    pts = np.concatenate([rng.uniform(-10, 32, (B, P, 2)), rng.uniform(-2, 3, (B, P, 1)),
                          rng.uniform(0, 1, (B, P, 2))], -1).astype(np.float32)
    s2k = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    s2k[:, 0, 0, 3] = -1.5
    s2k[:, 0, :2, :2] = [[0.995, -0.0998], [0.0998, 0.995]]
    return [
        rng.standard_normal((B, T, N, 32, 64, 3)).astype(np.float32),
        pts,
        rng.uniform(size=(B, P)) > 0.2,
        rng.uniform(0, 5, B).astype(np.float32),
        rng.uniform(-5, 20, (B, 2)).astype(np.float32),
        np.eye(6, dtype=np.float32)[[3, 1]][:B],
        jrig.cam_to_ego(jc), jrig.intrinsics(jc), jrig.ego_to_img(jc),
    ], s2k


def test_student_model_matches_flax_in_bf16():
    args, s2k = inputs()
    jmodel = JaxThinkTwiceModel(JaxModelConfig(**FROZEN), backbone_depth=10, n_sweeps=2)
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(lambda *a: jmodel.init(jax.random.key(0), *a[:-1], sweep2key=a[-1]))(
        *jargs, jnp.asarray(s2k))
    ref = jax.jit(lambda p, *a: jmodel.apply(p, *a[:-1], sweep2key=a[-1]))(
        params, *jargs, jnp.asarray(s2k))

    model = ThinkTwiceModel(ModelConfig(**FROZEN), backbone_depth=10, n_sweeps=2, n_cams=2)
    model.load_state_dict(student_state_dict_from_flax(jax.tree.map(np.asarray, params),
                                                       model), strict=True)
    with torch.no_grad():
        out = model.eval()(*[torch.as_tensor(a) for a in args],
                           sweep2key=torch.as_tensor(s2k))

    for key in ("pred_wp", "mu_branches", "sigma_branches", "depth", "seg"):
        a, b = out[key].numpy(), np.asarray(ref[key])
        assert a.shape == b.shape and a.dtype == np.float32, key
        assert np.isfinite(a).all(), key
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert err <= BF16_TOL * scale, (key, err, scale)
    np.testing.assert_allclose(out["measurement"].numpy(), np.asarray(ref["measurement"]),
                               rtol=0, atol=F32_TOL * float(np.abs(ref["measurement"]).max()))
