"""PyTorch port parity: the student's training losses of
thinktwice_tpu_torch against thinktwice_tpu's on the CPU.

The same numpy model outputs and batch (made from a seed, at small widths,
with values that reach both branches of smooth-L1, the clamp at 5 of the
distillation terms, invalid and out-of-range depth, and every case of the
Beta mode) go through `beta_kl`, `beta_mode_01`, `decoder_loss` (without a
distil_weight, with a scalar and with one per example), `depth_loss`,
`seg_focal_loss` and `total_loss` of both packages. Every term agrees to
1e-5 of its value, and the gradient of the total loss with respect to every
output (jax.grad against autograd) to 1e-5 of that gradient's scale.

The JAX functions run in float64 (jax's x64 mode, on the same numbers): a
float32 mean of the ~1e5 elements of a distillation grid comes out of XLA
on the CPU up to 1.3e-5 off the exact value (the port's float32, summed
pairwise, within 1e-7), so float32 against float32 would test the two
libraries' summation orders rather than the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinktwice_tpu.config import ModelConfig as JaxModelConfig
from thinktwice_tpu.models import encoder_decoder as jed
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.models import encoder_decoder as ted

torch.set_num_threads(1)

TOL = 1e-5
B, R, T, N = 2, 2, 4, 2            # examples, refine layers, steps, cameras
GRIDS = ((21, 21, 32), (10, 10, 64), (4, 4, 128), (2, 2, 256))
MCFG = dict(n_depth_bins=16)


def make_outs_and_batch(seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, lo=None):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return np.abs(x) + lo if lo is not None else x

    h, w, D, K = 2, 4, 16, 12
    outs = {
        "pred_wp": f(B, R + 1, T, 2, scale=3.0),
        "mu_branches": f(B, R + 1, 2, lo=0.2),
        "sigma_branches": f(B, R + 1, 2, lo=0.2),
        "future_mu": f(B, R + 1, T - 1, 2, lo=0.2),
        "future_sigma": f(B, R + 1, T - 1, 2, lo=0.2),
        "pred_speed": f(B, 1, scale=3.0),
        "pred_value_traj": f(B, 1, scale=5.0),
        "pred_value_ctrl": f(B, 1, scale=5.0),
        "pred_features_traj": f(B, 256),
        "pred_features_ctrl": f(B, 256),
        "mid_feature": tuple(f(B, *g) for g in GRIDS),
        "refine_BEV_feature": f(B, R, *GRIDS[0], scale=4.0),
        "refine_flat_feature": f(B, R, 256, scale=4.0),
        "teacher_pred_wp_offset": f(B, R, T, 2),
        "teacher_pred_ctrl_offset": f(B, R, T, 4),
        "teacher_future_BEV_feature": f(B, R, T, *GRIDS[0], scale=4.0),
        "teacher_refine_BEV_feature": f(B, R, *GRIDS[0], scale=4.0),
        "teacher_refine_flat_feature": f(B, R, 256, scale=4.0),
        "depth": f(B * N, h, w, D, scale=2.0),
        "seg": f(B * N, h, w, K, scale=2.0),
    }
    depth = rng.uniform(0.0, 50.0, (B * N, h * 16, w * 16)).astype(np.float32)
    depth[:, :16, :16] = 0.0                          # a cell with no valid pixel
    depth[:, 16:32, :16] = 0.5                        # a cell nearer than depth_min
    batch = {
        "gt_waypoints": f(B, T, 2, scale=3.0),
        "action_alpha": f(B, 2, lo=0.0005),
        "action_beta": f(B, 2, lo=0.3),
        "future_action_alpha": f(B, T - 1, 2, lo=0.2),
        "future_action_beta": f(B, T - 1, 2, lo=0.2),
        "gt_speed": f(B, scale=3.0),
        "gt_value": f(B, scale=5.0),
        "roach_features": f(B, 256),
        "roach_cnn": tuple(f(B, *g) for g in GRIDS),
        "future_roach_cnn21": f(B, T, *GRIDS[0]),
        "gt_depth": depth,
        "gt_seg": rng.integers(0, K, (B * N, h, w)).astype(np.int32),
    }
    return outs, batch


def to_jax(tree):
    """numpy -> jax arrays, floats as float64 (call under jax.enable_x64)."""
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f"
                              else x), tree)


def to_torch(tree, grad=False):
    def one(x):
        t = torch.as_tensor(np.asarray(x))
        if t.dtype == torch.int32:
            t = t.to(torch.int64)
        return t.requires_grad_(grad) if grad and t.is_floating_point() else t

    if isinstance(tree, dict):
        return {k: to_torch(v, grad) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_torch(v, grad) for v in tree)
    return one(tree)


def assert_term(port, ref, name):
    port, ref = float(torch.as_tensor(port).detach()), float(ref)
    assert abs(port - ref) <= TOL * max(abs(ref), 1e-6), (name, port, ref)


def test_beta_kl_and_mode_match_jax():
    rng = np.random.default_rng(1)
    a1, b1, a2, b2 = (rng.uniform(0.05, 8.0, (64,)).astype(np.float32) for _ in range(4))
    with jax.enable_x64(True):
        ref = np.asarray(jed.beta_kl(*to_jax((a1, b1, a2, b2))))
    got = ted.beta_kl(*(torch.as_tensor(x) for x in (a1, b1, a2, b2))).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * np.abs(ref).max())
    # every branch of the mode: both > 1, alpha <= 1 < beta, beta <= 1 < alpha,
    # both <= 1, and the edges at 1
    a = np.array([2.0, 0.5, 3.0, 0.7, 1.0, 1.0, 5.5], np.float32)
    b = np.array([3.0, 2.0, 0.5, 0.9, 1.0, 4.0, 1.0], np.float32)
    np.testing.assert_allclose(ted.beta_mode_01(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(jed.beta_mode_01(a, b)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("distil_weight", [None, 0.5, "per_example"])
def test_decoder_loss_matches_jax(distil_weight):
    outs, batch = make_outs_and_batch()
    if distil_weight == "per_example":
        batch["distil_weight"] = np.array([0.0, 1.0], np.float32)
    elif distil_weight is not None:
        batch["distil_weight"] = np.float32(distil_weight)
    with jax.enable_x64(True):
        ref = jed.decoder_loss(JaxModelConfig(**MCFG), to_jax(outs), to_jax(batch))
    got = ted.decoder_loss(ModelConfig(**MCFG), to_torch(outs), to_torch(batch))
    assert set(got) == set(ref)
    assert len(ref) == 17
    for k in ref:
        assert_term(got[k], ref[k], k)
    # the clamp of the distillation terms is reached
    assert float(ted.clamped_sl1(to_torch(outs)["refine_flat_feature"]
                                 - to_torch(batch)["roach_features"][:, None]).max()) == 5.0


def test_depth_and_seg_losses_match_jax():
    outs, batch = make_outs_and_batch(seed=2)
    jcfg, tcfg = JaxModelConfig(**MCFG), ModelConfig(**MCFG)
    with jax.enable_x64(True):
        jo, jb = to_jax(outs), to_jax(batch)
        ref_depth = jed.depth_loss(jcfg, jo["depth"], jb["gt_depth"])
        ref_seg = jed.seg_focal_loss(jo["seg"], jb["gt_seg"])
    assert_term(ted.depth_loss(tcfg, torch.as_tensor(outs["depth"]),
                               torch.as_tensor(batch["gt_depth"])), ref_depth, "depth_loss")
    assert_term(ted.seg_focal_loss(torch.as_tensor(outs["seg"]),
                                   torch.as_tensor(batch["gt_seg"]).long()), ref_seg, "seg_loss")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("distil_weight", [None, "per_example"])
def test_total_loss_and_gradients_match_jax(distil_weight):
    outs, batch = make_outs_and_batch(seed=3)
    if distil_weight == "per_example":
        batch["distil_weight"] = np.array([1.0, 0.25], np.float32)
    jcfg, tcfg = JaxModelConfig(**MCFG), ModelConfig(**MCFG)
    with jax.enable_x64(True):
        jb = to_jax(batch)
        (_, ref_terms), ref_grads = jax.value_and_grad(
            lambda o: jed.total_loss(jcfg, o, jb), has_aux=True)(to_jax(outs))
    touts = to_torch(outs, grad=True)
    total, terms = ted.total_loss(tcfg, touts, to_torch(batch))
    total.backward()
    assert set(terms) == set(ref_terms)
    for k in ref_terms:
        assert_term(terms[k], ref_terms[k], k)
    assert not any(terms[k].requires_grad for k in terms if k.startswith("metric_"))
    got = dict(_flat({k: (tuple(x.grad for x in v) if isinstance(v, tuple) else v.grad)
                      for k, v in touts.items()}))
    for name, g_ref in _flat(ref_grads):
        g_ref = np.asarray(g_ref)
        scale = max(float(np.abs(g_ref).max()), 1e-12)
        err = float(np.abs(got[name].numpy() - g_ref).max())
        assert err <= TOL * scale, (name, err, scale)
