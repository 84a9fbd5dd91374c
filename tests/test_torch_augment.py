"""PyTorch port parity: training augmentation of thinktwice_tpu_torch
against thinktwice_tpu's on the CPU.

- `ida_augment` with the IDA matrices the JAX package draws from its key:
  images (every sweep, bilinear) within 1e-5, gt_depth and gt_seg
  (nearest) equal, the matrices handed on as `ida`.
- `maybe_mirror` with the JAX package's per-example coins: every key equal;
  mirroring twice gives the batch back.
- `augment_images` with the JAX package's draws, at full strength: within
  1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinktwice_tpu.train import augment as jaug
from thinktwice_tpu_torch.train import augment as aug

torch.set_num_threads(1)

B, T, N, H, W = 3, 2, 4, 16, 32


def make_batch(seed=0):
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    pos = lambda *s: np.abs(f(*s)) + 0.3                           # noqa: E731
    s2k = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    s2k[:, 0, :2, :2] = [[0.99, -0.14], [0.14, 0.99]]
    s2k[:, 0, :2, 3] = [-1.5, 0.4]
    return {
        "imgs": rng.uniform(0, 1, (B, T, N, H, W, 3)).astype(np.float32),
        "points": f(B, 64, 5), "points_mask": rng.uniform(size=(B, 64)) > 0.3,
        "speed": pos(B), "target_point": f(B, 2), "command": np.eye(6, dtype=np.float32)[[0, 4, 3]],
        "gt_waypoints": f(B, 4, 2), "teacher_wp": f(B, 4, 2),
        "action_alpha": pos(B, 2), "action_beta": pos(B, 2),
        "future_action_alpha": pos(B, 3, 2), "future_action_beta": pos(B, 3, 2),
        "teacher_ctrl_sp": pos(B, 4, 4), "sweep2key": s2k,
        "roach_cnn": (f(B, 21, 21, 32), f(B, 2, 2, 256)),
        "gt_depth": rng.uniform(0, 40, (B * N, H, W)).astype(np.float32),
        "gt_seg": rng.integers(0, 12, (B * N, H // 4, W // 4)).astype(np.int32),
    }


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_torch(v) for v in tree)
    return torch.as_tensor(np.asarray(tree))


def assert_same(got: dict, ref: dict, atol=0.0):
    assert set(got) == set(ref)
    for k in ref:
        pairs = zip(got[k], ref[k]) if isinstance(ref[k], tuple) else [(got[k], ref[k])]
        for a, b in pairs:
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape, k
            if atol:
                np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_ida_augment_matches_jax():
    batch = make_batch()
    key = jax.random.key(3)
    ida = jaug.sample_ida_mats(key, B, N, H, W)
    assert bool((ida[..., 0, 0] < 0).any()) and bool((ida[..., 0, 0] > 0).any())
    ref = jaug.ida_augment(key, jax.tree.map(jnp.asarray, batch))
    got = aug.ida_augment(to_torch(batch), ida=torch.as_tensor(np.asarray(ida)))
    np.testing.assert_allclose(got["imgs"].numpy(), np.asarray(ref["imgs"]), rtol=0, atol=1e-5)
    for k in ("gt_depth", "gt_seg", "ida"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert got["gt_seg"].dtype == torch.int32
    assert not np.array_equal(got["imgs"].numpy(), batch["imgs"])


@pytest.mark.parametrize("distil_weight", [None, 0.5])
def test_maybe_mirror_matches_jax(distil_weight):
    batch = make_batch(seed=1)
    if distil_weight is not None:
        batch["distil_weight"] = np.float32(distil_weight)
    key = jax.random.key(7)
    do = jax.random.bernoulli(key, 0.5, (B,))
    assert 0 < int(do.sum()) < B
    ref = jaug.maybe_mirror(key, jax.tree.map(jnp.asarray, batch))
    got = aug.maybe_mirror(to_torch(batch), do=torch.as_tensor(np.asarray(do)))
    assert_same(got, ref)


def test_mirror_twice_is_the_identity():
    batch = to_torch(make_batch(seed=2))
    twice = aug.mirror_batch(aug.mirror_batch(batch))
    assert float(twice.pop("distil_weight")) == 0.0
    assert_same(twice, batch)
    once = aug.mirror_batch(batch)
    assert not torch.equal(once["imgs"], batch["imgs"])
    assert torch.equal(once["imgs"][:, :, 1], batch["imgs"][:, :, 2].flip(-2))


def test_augment_images_matches_jax():
    imgs = np.random.default_rng(4).uniform(0, 1, (2, N, H, W, 3)).astype(np.float32)
    fired = set()
    for seed in range(4):
        key = jax.random.key(seed)
        k = jax.random.split(key, 6)
        draws = aug.ImageDraws(
            bright_u=float(jax.random.uniform(k[0], (), minval=-1.0, maxval=1.0)),
            contrast_u=float(jax.random.uniform(k[1], (), minval=-1.0, maxval=1.0)),
            sigma_u=float(jax.random.uniform(k[2], ())),
            noise=torch.as_tensor(np.asarray(jax.random.normal(k[3], imgs.shape))),
            blur_u=float(jax.random.uniform(k[4], ())),
            drop_u=float(jax.random.uniform(k[5], ())),
            channel=int(jax.random.randint(jax.random.fold_in(k[5], 1), (), 0, 3)))
        ref = np.asarray(jaug.augment_images(key, jnp.asarray(imgs), 1.0))
        got = aug.augment_images(torch.as_tensor(imgs), 1.0, draws=draws).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=f"seed {seed}")
        fired |= {"blur"} if draws.blur_u < 0.3 else set()
        fired |= {"drop"} if draws.drop_u < 0.2 else set()
    assert fired == {"blur", "drop"}
