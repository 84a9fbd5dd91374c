"""PyTorch port parity: the data-parallel train step of thinktwice_tpu_torch
over a 2-rank gloo group on the CPU, against the JAX package's
make_train_step over a 2-device data mesh and against the port's own
one-process step.

- Port vs JAX mesh: total_loss of a tiny differentiable stand-in
  (`parallel.ranks.LinearStandIn`, every output a linear map of the
  batch's features), 8 examples, grad_accum K = 1 and K = 2. In every
  microbatch the two ranks' rows hold unequal sums of distil_weight (the
  mirrored example, weight 0, lies on rank 0) and unequal counts of valid
  depth cells. Everything runs in float64. The loss, every metric and
  grad_norm agree with the JAX step's to 1e-6 of their value, and every
  updated parameter leaf to 1e-6 of its largest element: an element near
  zero cannot be held to 1e-6 of itself, because the port's AdamW rounds
  its bias corrections in float32 as optax does in float32, while optax
  under x64 keeps them in float64, which moves a step by some 2e-5 of its
  size (lr 2^-10). The naive variant, each rank normalizing its terms by
  its own rows and the gradients then averaged, fails the same check: a
  mutation computed here, rank by rank, with the port's functions.
- DDP vs one process, the student at `_DRYRUN_FROZEN`: a 2-rank step on a
  seeded batch of 4 examples (the mirrored one on rank 0) against the
  port's one-process step on the same batch and weights, both in float32
  compute. Float32 sums taken in another order (each rank's rows, then the
  all-reduce) differ by rounding only: the loss terms and grad_norm agree
  to 1e-5 of their value, the gradient to 1e-4 of its norm, every leaf
  whose gradient exceeds 1e-3 of the global norm at a cosine of at least
  0.9999, and each updated leaf to 1e-3 of its change by the one-process
  optimizer applied to the ranks' reduced gradient (lr 1e-3); both ranks
  hold the same parameters after the step (`train.crosscheck.step_agreement`,
  which says why the update is not held to the one-process step's own).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_losses import to_jax, to_torch
from thinktwice_tpu.config import Config as JConfig
from thinktwice_tpu.config import ModelConfig as JModelConfig
from thinktwice_tpu.config import TrainConfig as JTrain
from thinktwice_tpu.models import encoder_decoder as jed
from thinktwice_tpu.train import train_step as jts
from thinktwice_tpu_torch import dryrun
from thinktwice_tpu_torch.config import Config, ModelConfig, TrainConfig
from thinktwice_tpu_torch.parallel import ranks
from thinktwice_tpu_torch.parallel.launch import Group, spawn
from thinktwice_tpu_torch.train import loop
from thinktwice_tpu_torch.train.crosscheck import step_agreement
from thinktwice_tpu_torch.train.train_step import (
    create_train_state,
    global_norm,
    make_optimizer,
    make_train_step,
    shard_batch,
)

torch.set_num_threads(1)

TOL = 1e-6
LR = 2.0 ** -10           # exact in float32, so both optimizers take the same rate
B, N, T, R, NF = 8, 2, 2, 1, 3
H, W, D, KSEG = 2, 4, 16, 12      # depth and seg cells per camera, bins, classes
GRIDS = ((21, 21, 32), (10, 10, 64), (4, 4, 128), (2, 2, 256))
SHAPES = {
    "pred_wp": (R + 1, T, 2), "mu_branches": (R + 1, 2), "sigma_branches": (R + 1, 2),
    "future_mu": (R + 1, T - 1, 2), "future_sigma": (R + 1, T - 1, 2),
    "pred_speed": (1,), "pred_value_traj": (1,), "pred_value_ctrl": (1,),
    "pred_features_traj": (256,), "pred_features_ctrl": (256,),
    **{f"mid_feature.{i}": g for i, g in enumerate(GRIDS)},
    "refine_BEV_feature": (R, *GRIDS[0]), "refine_flat_feature": (R, 256),
    "teacher_pred_wp_offset": (R, T, 2), "teacher_pred_ctrl_offset": (R, T, 4),
    "teacher_future_BEV_feature": (R, T, *GRIDS[0]),
    "teacher_refine_BEV_feature": (R, *GRIDS[0]), "teacher_refine_flat_feature": (R, 256),
    "depth": (H, W, D), "seg": (H, W, KSEG),
}
# rank 0 holds the mirrored example; with K = 2 the ranks' sums per
# microbatch are 1 vs 2 and 1.5 vs 2, with K = 1 3 vs 3.5
DISTIL_WEIGHT = np.array([0.0, 1.0, 1.0, 1.0, 1.0, 0.5, 1.0, 1.0])


@pytest.fixture(autouse=True)
def one_thread_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def standin_batch(seed=0):
    """The global batch, floats in float64."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float64)

    def pos(*shape):
        return np.abs(f(*shape)) + 0.3

    # image i has i % 5 of its 8 depth cells empty: unequal valid counts
    depth = rng.uniform(2.0, 50.0, (B * N, H * 16, W * 16)).astype(np.float64)
    for i in range(B * N):
        for c in range(i % 5):
            depth[i, (c // W) * 16:(c // W + 1) * 16, (c % W) * 16:(c % W + 1) * 16] = 0.0
    return {
        "features": f(B, NF), "gt_waypoints": f(B, T, 2, scale=3.0),
        "action_alpha": pos(B, 2), "action_beta": pos(B, 2),
        "future_action_alpha": pos(B, T - 1, 2), "future_action_beta": pos(B, T - 1, 2),
        "gt_speed": f(B, scale=3.0), "gt_value": f(B, scale=5.0),
        "roach_features": f(B, 256), "roach_cnn": tuple(f(B, *g) for g in GRIDS),
        "future_roach_cnn21": f(B, T, *GRIDS[0]), "gt_depth": depth,
        "gt_seg": rng.integers(0, KSEG, (B * N, H, W)).astype(np.int32),
        "distil_weight": DISTIL_WEIGHT,
    }


def standin_params(seed=1):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((NF, int(np.prod(s)))) * 0.3).astype(np.float64)
            for k, s in SHAPES.items()}


def jax_outs(params, batch):
    """The stand-in's outputs, as ranks.LinearStandIn computes them."""
    f = batch["features"]
    outs = {}
    for k, s in SHAPES.items():
        x = jnp.repeat(f, N, axis=0) if k in ranks.PER_CAMERA else f
        y = (x @ params[k]).reshape((x.shape[0],) + s)
        outs[k] = jax.nn.softplus(y) + 0.2 if k in ranks.POSITIVE else y
    outs["mid_feature"] = tuple(outs.pop(f"mid_feature.{i}") for i in range(len(GRIDS)))
    return outs


def configs(K):
    train = dict(lr=LR, warmup_steps=0, total_steps=10, grad_accum=K)
    return (JConfig(model=JModelConfig(n_depth_bins=D), train=JTrain(**train)),
            Config(model=ModelConfig(n_depth_bins=D), train=TrainConfig(**train)))


def jax_mesh_step(jcfg, params, batch):
    with jax.enable_x64(True):
        mesh = jts.data_mesh(jax.devices()[:2])
        state = jts.replicate(mesh, jts.create_train_state(
            jcfg, {k: jnp.asarray(v) for k, v in params.items()}))

        def loss_fn(p, b):
            return jed.total_loss(jcfg.model, jax_outs(p, b), b)

        new, metrics = jts.make_train_step(jcfg, loss_fn)(state, jts.shard_batch(
            mesh, to_jax(batch)))
        return ({k: float(v) for k, v in metrics.items()},
                {k: np.asarray(v) for k, v in new.params.items()})


def state_dict_of(params):
    return {"w." + k.replace(".", "_"): torch.tensor(v) for k, v in params.items()}


def mismatches(metrics, params, ref_metrics, ref_params):
    """Names of the values that differ from the reference by more than TOL
    (metrics of their value, parameter leaves of their largest element)."""
    assert set(metrics) == set(ref_metrics)
    bad = [k for k, v in ref_metrics.items() if abs(metrics[k] - v) > TOL * max(abs(v), 1e-12)]
    for k, v in ref_params.items():
        got = params["w." + k.replace(".", "_")].numpy()
        if np.abs(got - v).max() > TOL * np.abs(v).max():
            bad.append(k)
    return bad


def naive_step(cfg, params, batch):
    """The mutation: each rank's terms normalized by its own rows (the
    one-process loss on its shard), the metrics and gradients averaged
    over the ranks, then the optimizer."""
    K = cfg.train.grad_accum
    got = []
    for r in range(2):
        local = shard_batch(Group(r, 2, torch.device("cpu"), "gloo"), to_torch(batch), K)
        model = ranks.LinearStandIn(SHAPES, NF, N)
        model.load_state_dict(state_dict_of(params))
        grads = {}
        step = make_train_step(cfg, ranks.standin_loss_fn(cfg, model),
                               lambda stage, v: grads.update(v) if stage == "backward" else None)
        _, m = step(create_train_state(cfg, dict(model.named_parameters())), local)
        got.append(({k: float(v) for k, v in m.items()}, grads))
    metrics = {k: (got[0][0][k] + got[1][0][k]) / 2 for k in got[0][0]}
    grads = {k: (got[0][1][k] + got[1][1][k]) / 2 for k in got[0][1]}
    metrics["grad_norm"] = float(global_norm(list(grads.values())))
    model = ranks.LinearStandIn(SHAPES, NF, N)
    model.load_state_dict(state_dict_of(params))
    p = dict(model.named_parameters())
    tx = make_optimizer(cfg)
    tx.step(p, grads, tx.init(p))
    return metrics, {k: v.detach() for k, v in p.items()}


def valid_depth_cells(gt_depth):
    cells = gt_depth.reshape(gt_depth.shape[0], H, 16, W, 16).max(dim=4).values.max(dim=2).values
    return int((cells > 0).sum())


@pytest.mark.parametrize("K", [1, 2])
def test_ddp_step_matches_jax_mesh(K, tmp_path):
    jcfg, cfg = configs(K)
    params, batch = standin_params(), standin_batch()
    # the shards are unequal in every microbatch
    parts = [shard_batch(Group(r, 2, torch.device("cpu"), "gloo"), to_torch(batch), K)
             for r in range(2)]
    for k in range(K):
        rows = slice(k * B // (2 * K), (k + 1) * B // (2 * K))
        cams = slice(rows.start * N, rows.stop * N)
        dw = [float(p["distil_weight"][rows].sum()) for p in parts]
        valid = [valid_depth_cells(p["gt_depth"][cams]) for p in parts]
        assert dw[0] != dw[1] and valid[0] != valid[1], (k, dw, valid)

    ref_metrics, ref_params = jax_mesh_step(jcfg, params, batch)
    path = str(tmp_path / "data.pt")
    torch.save({"state_dict": state_dict_of(params), "batch": to_torch(batch)}, path)
    out = spawn(ranks.train_step_rank, 2,
                args=(cfg, functools.partial(ranks.LinearStandIn, SHAPES, NF, N),
                      functools.partial(ranks.standin_loss_fn, cfg), path),
                devices=["cpu", "cpu"], timeout=120)
    assert torch.equal(out[0]["leaf_sums"], out[1]["leaf_sums"])
    assert out[0]["metrics"] == out[1]["metrics"]
    assert mismatches(out[0]["metrics"], out[0]["params"], ref_metrics, ref_params) == []
    assert abs(ref_metrics["loss"]) > 0.1 and ref_metrics["grad_norm"] > 0.1

    naive = mismatches(*naive_step(cfg, params, batch), ref_metrics, ref_params)
    assert "loss" in naive and "depth_loss" in naive and "distil_loss" in naive, naive
    assert "wp_loss" not in naive             # a plain mean over equal shards


def frozen_batch(cfg, seed=3):
    """dryrun.zero_batch's 4 examples filled from a seed (the Beta targets
    positive, some depth empty, the first example mirrored)."""
    rng = np.random.default_rng(seed)
    batch = dryrun.zero_batch(cfg, dryrun._DRYRUN_FROZEN["n_points"], 4, "cpu")

    def fill(key, x):
        if x.dtype == torch.bool:
            return torch.as_tensor(rng.uniform(size=x.shape) > 0.2)
        if x.dtype == torch.int64:
            return torch.as_tensor(rng.integers(0, cfg.model.n_seg_classes, x.shape))
        v = rng.standard_normal(x.shape).astype(np.float32)
        if "alpha" in key or "beta" in key or key == "teacher_ctrl_sp":
            v = np.abs(v) + 0.5
        if key == "gt_depth":
            v = rng.uniform(0.0, 45.0, x.shape).astype(np.float32)
            v[:, :, :24] = 0.0
        return torch.as_tensor(v)

    out = {k: tuple(fill(k, y) for y in v) if isinstance(v, tuple) else fill(k, v)
           for k, v in batch.items()}
    out["distil_weight"] = torch.tensor([0.0, 1.0, 1.0, 1.0])
    return out


def test_ddp_step_matches_one_process_at_frozen_shapes(tmp_path):
    fz = dryrun._DRYRUN_FROZEN
    cfg = dryrun.dryrun_config(fz).replace(train=TrainConfig(lr=1e-3, warmup_steps=0))
    make_model = functools.partial(loop.make_model, cfg, fz["backbone"], 1)
    model = make_model(device="cpu")
    loop.init_model_params(cfg, model, torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "data.pt")
    torch.save({"state_dict": start, "batch": frozen_batch(cfg)}, path)
    make_loss = functools.partial(loop.model_loss_fn, cfg)

    one = ranks.train_step_rank(None, cfg, make_model, make_loss, path, float32=True,
                                device="cpu")
    out = spawn(ranks.train_step_rank, 2, args=(cfg, make_model, make_loss, path, True),
                devices=["cpu", "cpu"], timeout=180)
    agree = step_agreement(out, one, start, cfg, term_tol=1e-5, grad_tol=1e-4,
                           grad_cos=0.9999, update_tol=1e-3, cos_floor=1e-3)
    assert not agree["bad"], agree["bad"]
    assert agree["moved"] > 0.9 * agree["n_leaves"], (agree["moved"], agree["n_leaves"])
