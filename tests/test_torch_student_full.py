"""PyTorch port parity at full width: the student_rl6 archive loaded into the
ThinkTwice model of both packages, on one world's full-width inputs (4
cameras of 256 x 512, two sweeps, a 64 x 1024 lidar's two sweeps of
points), on the CPU.

pred_wp, mu_branches and sigma_branches must agree to the bfloat16 bound
of tests/test_torch_model_full.py (5e-2 of each output's scale: both
packages round to bfloat16 at the same places but in other orders). The
model is ResNet-50 with 84.8 M parameters, so this takes minutes on one
core and is marked slow (Tier-1 deselects it):

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_student_full.py
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model_full import BF16_TOL
from thinktwice_tpu.config import CameraConfig as JaxCameraConfig
from thinktwice_tpu.config import ModelConfig as JaxModelConfig
from thinktwice_tpu.models import rig as jrig
from thinktwice_tpu.models.encoder_decoder import ThinkTwiceModel as JaxThinkTwiceModel
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.weights import load_flax_msgpack, load_student_model, student_arch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT_RL6 = os.path.join(REPO, "runs", "student_rl6", "params.msgpack")


def full_width_inputs(seed=0):
    """One world's inputs at the archive's widths: images (1, 2, 4, 256,
    512, 3), two sweeps of 64 x 1024 lidar points (1, 2 x 65,536, 5), and
    the rig of the default CameraConfig."""
    rng = np.random.default_rng(seed)
    jc = JaxCameraConfig()
    T, N, H, W = 2, jc.n_cams, jc.height, jc.width
    P = 2 * 64 * 1024
    pts = np.concatenate([rng.uniform(-40, 40, (1, P, 2)), rng.uniform(-2, 3, (1, P, 1)),
                          rng.uniform(0, 1, (1, P, 1)),
                          np.repeat([0.0, 1.0], P // 2)[None, :, None]], -1).astype(np.float32)
    s2k = np.tile(np.eye(4, dtype=np.float32), (1, T, 1, 1))
    s2k[:, 0, 0, 3] = -0.4
    return [
        rng.uniform(0, 1, (1, T, N, H, W, 3)).astype(np.float32),
        pts,
        rng.uniform(size=(1, P)) > 0.3,
        np.array([3.5], np.float32),
        np.array([[12.0, -1.5]], np.float32),
        np.eye(6, dtype=np.float32)[[3]],
        jrig.cam_to_ego(jc), jrig.intrinsics(jc), jrig.ego_to_img(jc),
    ], s2k


@pytest.mark.slow
def test_student_rl6_full_width_matches_flax():
    tree = load_flax_msgpack(STUDENT_RL6)
    depth, n_sweeps = student_arch(tree)
    assert (depth, n_sweeps) == (50, 2)
    args, s2k = full_width_inputs()

    jmodel = JaxThinkTwiceModel(JaxModelConfig(), backbone_depth=depth, n_sweeps=n_sweeps)
    ref = jax.jit(lambda p, *a: jmodel.apply(p, *a[:-1], sweep2key=a[-1]))(
        jax.tree.map(jnp.asarray, tree), *[jnp.asarray(a) for a in args], jnp.asarray(s2k))
    ref = {k: np.asarray(ref[k]) for k in ("pred_wp", "mu_branches", "sigma_branches")}
    del tree

    model = load_student_model(STUDENT_RL6, Config(), device="cpu")
    with torch.no_grad():
        out = model(*[torch.as_tensor(a) for a in args], sweep2key=torch.as_tensor(s2k))
    for key, b in ref.items():
        a = out[key].float().numpy()
        assert a.shape == b.shape, key
        assert np.isfinite(a).all(), key
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"{key}: max abs err {err:.4g}, scale {scale:.4g}, ratio {err / scale:.4g}")
        assert err <= BF16_TOL * scale, (key, err, scale)
