"""Checks of one run of the port against another: the expert trainers on
one device against another, a data-parallel train step against the
one-process step, and the float32 switch both compare under.

The expert trainers: one small PPO or BC iterate from the same weights and
the same draws (made on the CPU), and the comparison of the two runs. PPO
runs 2 worlds x 8 macro steps of 2 ticks with an anchor; BC runs 2 worlds x
16 ticks with perturbation and a DAgger mix of 0.5, then its held-out probe.
Both on the 2-block grid town with 4 vehicles.

Two float32 runs agree when their dones are equal, every metric is within
METRIC_TOL (absolute plus relative), the first minibatch's gradient is
within GRAD_TOL of its norm and every leaf is at a cosine of at least
GRAD_COS. The optimizer is not held here: Adam's m/sqrt(v) is +-1 on
near-zero gradients whatever their size, so equal-in-tolerance gradients can
move a leaf by +-lr either way (tests/test_torch_optim.py holds it against
optax on the same gradients).

The data-parallel step (`step_agreement`) is held, with tolerances its
caller states, against the one-process step on the same global batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.models import encoder_decoder, lidarnet, lss
from thinktwice_tpu_torch.ops.birdview_cuda import K1
from thinktwice_tpu_torch.scripts.train_roach_ppo import build_routes
from thinktwice_tpu_torch.train.bc import BCConfig, make_bc
from thinktwice_tpu_torch.train.draws import GeneratorTrainDraws
from thinktwice_tpu_torch.train.ppo import PPOConfig, make_policy, make_ppo
from thinktwice_tpu_torch.train.train_step import make_optimizer

SMALL_PPO = PPOConfig(n_envs=2, n_steps=8, n_epochs=1, minibatch=8, lr=3e-5, n_vehicles=4,
                      policy_every=2, anchor_coef=0.05)
SMALL_BC = BCConfig(n_envs=2, n_steps=16, minibatch=8, n_epochs=1, n_vehicles=4,
                    perturb_prob=0.5, eval_envs=2, eval_steps=8)
DAGGER_MIX = 0.5
METRIC_TOL = 1e-3
GRAD_TOL, GRAD_COS = 1e-2, 0.99


@contextlib.contextmanager
def tf32_off():
    """The card's TF32 for matrix products and convolutions off while the
    block runs: float32 in full, as a check on the card compares it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def float32_compute():
    """The student's bfloat16 compute switched to float32, and TF32 off
    (tf32_off), while the block runs: build and run the model inside it
    (its modules read the dtype when built and when run). The card-vs-CPU
    and rank-vs-one-process checks compare in float32."""
    mods = (encoder_decoder, lidarnet, lss)
    saved = [m.BF16 for m in mods]
    for m in mods:
        m.BF16 = torch.float32
    try:
        with tf32_off():
            yield
    finally:
        for m, v in zip(mods, saved):
            m.BF16 = v


@dataclasses.dataclass
class IterateRun:
    metrics: dict[str, float]          # the iterate's, and BC's probe's
    grads: dict[str, torch.Tensor]     # the first minibatch's, float64 on the CPU
    done: torch.Tensor                 # the rollout's dones, on the CPU
    launches: int                      # K1 launches in the iterate (not the probe)
    seconds: float


def small_iterate(kind: str, cfg: Config, device, start: dict, anchor: dict | None = None,
                  seed: int = 5) -> IterateRun:
    """One iterate of SMALL_PPO (anchored to the state dict `anchor`) or
    SMALL_BC on `device` from the RoachPolicy state dict `start`, the draws
    from a CPU generator seeded with `seed`; for BC, then its probe."""
    device = torch.device(device)
    town = make_grid_town(2, 100.0, device=device)
    policy = make_policy(cfg, device)
    policy.load_state_dict(start)
    if kind == "ppo":
        ref = make_policy(cfg, device)
        ref.load_state_dict(anchor)
        init_fn, it = make_ppo(cfg, SMALL_PPO, town, build_routes(4),
                               anchor=ref.requires_grad_(False))
        kw = {}
    else:
        init_fn, it = make_bc(cfg, SMALL_BC, town, build_routes(6))
        kw = {"dagger_mix": DAGGER_MIX}
    draws = GeneratorTrainDraws(town, seed, device="cpu")
    _, opt, env = init_fn(draws)
    seen = {}

    def probe(stage, value):
        if stage == "rollout":
            seen["done"] = value["done"].cpu()
        elif "grads" not in seen:
            seen["grads"] = {k: g.detach().cpu().double() for k, g in value[1].items()}

    t0 = time.perf_counter()
    before = K1.launches
    policy, _, _, m = it(policy, opt, env, draws, probe=probe, **kw)
    launches = K1.launches - before
    metrics = {k: float(v) for k, v in m.items()}
    if kind == "bc":
        metrics.update({k: float(v) for k, v in it.eval_fn(policy, draws).items()})
    return IterateRun(metrics, seen["grads"], seen["done"], launches, time.perf_counter() - t0)


def leaf_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine of two gradient leaves: 1 where both are zero, 0 where one is."""
    a, b = a.double(), b.double()
    na, nb = float(a.norm()), float(b.norm())
    if na == 0 or nb == 0:
        return float(na == nb)
    return float((a * b).sum()) / (na * nb)


def compare(run: IterateRun, ref: IterateRun) -> dict:
    """`run` against `ref`: "dones_equal"; "metric_err", the largest
    |run - ref| / (1 + |ref|), at the metric "worst"; "grad_err", the
    gradient's difference over its norm; "cos", the least leaf cosine, at
    the leaf "leaf"; "ok" when all are within the module's tolerances."""
    m, r = run.metrics, ref.metrics
    worst = max(r, key=lambda k: abs(m[k] - r[k]) / (1 + abs(r[k])))
    err = abs(m[worst] - r[worst]) / (1 + abs(r[worst]))
    g, h = run.grads, ref.grads
    grad = (math.sqrt(sum(float(((g[k] - h[k]) ** 2).sum()) for k in h))
            / math.sqrt(sum(float((h[k] ** 2).sum()) for k in h)))
    cos = {k: leaf_cosine(g[k], h[k]) for k in h}
    leaf = min(cos, key=cos.get)
    dones = torch.equal(run.done, ref.done)
    return {"dones_equal": dones, "metric_err": err, "worst": worst, "grad_err": grad,
            "cos": cos[leaf], "leaf": leaf, "n_metrics": len(r), "n_leaves": len(cos),
            "ok": dones and err <= METRIC_TOL and grad <= GRAD_TOL and cos[leaf] >= GRAD_COS}


def _norm(leaves) -> float:
    return math.sqrt(sum(float((x.double() ** 2).sum()) for x in leaves))


def step_agreement(out: list[dict], one: dict, start: dict, cfg: Config, term_tol: float,
                   grad_tol: float, grad_cos: float, update_tol: float,
                   cos_floor: float = 0.0) -> dict:
    """A data-parallel step against the one-process step from the state
    dict `start`: `out` holds `parallel.ranks.train_step_rank`'s results,
    one a rank; `one` its result with no group. Held:
    - each loss term and grad_norm to term_tol of its value;
    - rank 0's reduced gradient to grad_tol of the one-process gradient's
      norm, and each leaf whose gradient's norm is at least cos_floor of
      that norm at a cosine of at least grad_cos;
    - rank 0's parameters to update_tol of each leaf's change by cfg's
      optimizer applied to the reduced gradient from `start`. Not to the
      one-process step's own change: Adam divides a gradient element by its
      magnitude plus 1e-8, so an element near 1e-8 turns a rounding of the
      gradient into a change of the update's size;
    - some leaf moved, and every rank holds the same parameters.

    -> "terms", each term's difference relative to its value; "grad";
    "cos", each held leaf's cosine; "update", each leaf's difference
    relative to its largest change; "moved", the leaves that changed, of
    "n_leaves"; "direct" and "direct_all", rank 0's parameters against the
    one-process step's, relative to a leaf's largest change and to the
    whole change's norm; "same"; "bad", the failures (empty when all
    hold)."""
    m, ref = out[0]["metrics"], one["metrics"]
    terms = {k: abs(m[k] - v) / max(abs(v), 1e-12) for k, v in ref.items()
             if not k.startswith("metric_")}
    g, gref = out[0]["grads"], one["grads"]
    norm = _norm(gref.values())
    grad = _norm(g[k] - gref[k] for k in gref) / norm
    cos = {k: leaf_cosine(g[k], v) for k, v in gref.items()
           if _norm([v]) >= cos_floor * norm}
    upd = {k: start[k].clone() for k in g}
    tx = make_optimizer(cfg)
    tx.step(upd, g, tx.init(upd))
    params, own = out[0]["params"], one["params"]
    change = {k: float((upd[k] - start[k]).abs().max()) for k in upd}
    update = {k: float((params[k] - upd[k]).abs().max()) / max(change[k], 1e-30) for k in upd}
    direct = max(float((params[k] - own[k]).abs().max())
                 / max(float((own[k] - start[k]).abs().max()), 1e-30) for k in upd)
    direct_all = (_norm(params[k] - own[k] for k in upd)
                  / _norm(own[k] - start[k] for k in upd))
    moved = sum(c > 0 for c in change.values())
    same = all(torch.equal(o["leaf_sums"], out[0]["leaf_sums"]) for o in out)
    bad = ([f"{k} {v:.2e}" for k, v in terms.items() if v > term_tol]
           + ([f"gradient {grad:.2e}"] if grad > grad_tol else [])
           + [f"{k} cosine {v:.6f}" for k, v in cos.items() if v < grad_cos]
           + [f"{k} update {v:.2e}" for k, v in update.items() if v > update_tol]
           + ([] if moved else ["no leaf moved"]) + ([] if same else ["the ranks differ"]))
    return {"terms": terms, "grad": grad, "cos": cos, "update": update, "moved": moved,
            "n_leaves": len(upd), "direct": direct, "direct_all": direct_all, "same": same,
            "bad": bad}
