"""What every rank runs in the checks of the multi-process paths. The tests
and `chip_smoke.py` start them with `parallel.launch.spawn`, which pickles a
rank function by its import path, so they live in the package.

- `train_step_rank`: one data-parallel step of a model and a global batch
  read from a file, with the gradients, the parameters and the step's
  times; with no group, the one-process step it is held against.
- `LinearStandIn`, `standin_loss_fn`: a differentiable stand-in for the
  student whose every output is a linear map of the batch's features, to
  hold the step's reductions over ranks against the JAX mesh's without the
  model's cost.
- `roach_rollout_rank`: the Roach rollout of the grid town's worlds,
  sharded over the ranks (K1 on every rank).
- `autopilot_rollout_rank`: `batched_rollout` of given worlds and draws,
  sharded, with the autopilot, its summary and the worlds gathered.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch
from torch import nn
from torch.nn import functional as F

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.models.encoder_decoder import total_loss
from thinktwice_tpu_torch.parallel.launch import Group
from thinktwice_tpu_torch.parallel.worlds import (
    batched_rollout,
    gather_worlds,
    shard_worlds,
    summarize_events,
    world_slice,
)
from thinktwice_tpu_torch.sim.state import state_from_arrays, state_to_arrays, tree_map
from thinktwice_tpu_torch.train.crosscheck import float32_compute, tf32_off
from thinktwice_tpu_torch.train.train_step import (
    create_train_state,
    make_train_step,
    replicate,
    shard_batch,
)


def _to(x, device):
    if isinstance(x, tuple):
        return tuple(_to(y, device) for y in x)
    return x.to(device) if torch.is_tensor(x) else x


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_step_rank(group: Group | None, cfg: Config, make_model, make_loss, data_path: str,
                    float32: bool = False, timed: int = 0, device=None) -> dict:
    """One train step (cfg.train's optimizer and grad_accum) of
    make_model(device=...) loaded with the state_dict of data_path's
    {"state_dict", "batch"}, on the global batch: with a group, this rank's
    shard of it (the state replicated from rank 0, the loss
    make_loss(model, group)); without, the one-process step on `device`.
    float32 switches the student's bfloat16 compute to float32. Then
    `timed` more steps, timed.

    -> metrics (floats); on rank 0 (or without a group) the gradients the
    optimizer took and the parameters after the first step, on the CPU;
    "leaf_sums", each parameter's float64 sum after it (equal on every
    rank); "first_s"; the timed steps' mean "ms" and, with a group, mean
    "reduce_ms" of the all-reduce; "peak_gib" on a card."""
    dev = torch.device(device) if group is None else group.device
    lead = group is None or group.rank == 0
    with float32_compute() if float32 else contextlib.nullcontext():
        data = torch.load(data_path, map_location=dev, weights_only=False)
        model = make_model(device=dev)
        model.load_state_dict(data["state_dict"])
        state = create_train_state(cfg, dict(model.named_parameters()))
        if group is None:
            batch = _to(data["batch"], dev)
        else:
            state = replicate(group, state)
            batch = shard_batch(group, data["batch"], cfg.train.grad_accum)
        del data
        out, stamps = {}, {}

        def probe(stage, value):
            if stage in ("backward", "reduce"):
                if dev.type == "cuda":
                    stamps[stage] = torch.cuda.Event(enable_timing=True)
                    stamps[stage].record()
                else:
                    stamps[stage] = time.perf_counter()
            if lead and "grads" not in out and stage == ("backward" if group is None else "reduce"):
                out["grads"] = {k: g.detach().cpu() for k, g in value.items()}

        step = make_train_step(cfg, make_loss(model, group), probe, group)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        _sync(dev)
        out["first_s"] = time.perf_counter() - t0
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        out["leaf_sums"] = torch.stack([p.detach().double().sum()
                                        for p in state.params.values()]).cpu()
        if lead:
            out["params"] = {k: p.detach().cpu().clone() for k, p in state.params.items()}
        ms, reduce_ms = [], []
        for _ in range(timed):
            _sync(dev)
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if group is not None:
                a, b = stamps["backward"], stamps["reduce"]
                reduce_ms.append(a.elapsed_time(b) if dev.type == "cuda" else (b - a) * 1e3)
        out["ms"] = sum(ms) / len(ms) if ms else None
        out["reduce_ms"] = sum(reduce_ms) / len(reduce_ms) if reduce_ms else None
        out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                           if dev.type == "cuda" else None)
    return out


# outputs of the stand-in with a row per camera image, and its Beta parameters
PER_CAMERA = ("depth", "seg")
POSITIVE = ("mu_branches", "sigma_branches", "future_mu", "future_sigma")


class LinearStandIn(nn.Module):
    """Every output that total_loss reads as a linear map of the batch's
    "features" (B, n_features): output name -> its shape after the leading
    axis, "mid_feature.i" the i-th grid of the mid_feature tuple. The
    per-camera outputs (depth, seg) map each example's features to each of
    its n_cams rows; the Beta parameters are softplus(.) + 0.2."""

    def __init__(self, shapes: dict, n_features: int, n_cams: int, device=None,
                 dtype=torch.float64):
        super().__init__()
        self.shapes, self.n_cams = dict(shapes), n_cams
        self.w = nn.ParameterDict({
            k.replace(".", "_"): nn.Parameter(torch.zeros(n_features, math.prod(s),
                                                          device=device, dtype=dtype))
            for k, s in self.shapes.items()})

    def forward(self, batch: dict) -> dict:
        f = batch["features"]
        outs = {}
        for k, s in self.shapes.items():
            x = f.repeat_interleave(self.n_cams, 0) if k in PER_CAMERA else f
            y = (x @ self.w[k.replace(".", "_")]).reshape(x.shape[0], *s)
            outs[k] = F.softplus(y) + 0.2 if k in POSITIVE else y
        grids = sorted(k for k in outs if k.startswith("mid_feature."))
        outs["mid_feature"] = tuple(outs.pop(k) for k in grids)
        return outs


def standin_loss_fn(cfg: Config, model: LinearStandIn, group: Group | None = None):
    """-> loss_fn(batch): total_loss of the stand-in's outputs (with a group,
    this rank's share of the global batch's loss)."""

    def loss_fn(batch):
        return total_loss(cfg.model, model(batch), batch, group)

    return loss_fn


@torch.no_grad()
@tf32_off()
def roach_rollout_rank(group: Group | None, cfg: Config, weights: str, n_worlds: int,
                       n_vehicles: int, n_ticks: int, seed: int, device=None) -> dict:
    """The Roach rollout (rollout.rollout) of n_worlds grid-town worlds for
    n_ticks ticks: the worlds reset from a generator seeded with seed on
    the device, each rank stepping its share with the global draws cut to
    its rows (with no group, all of them on `device`). TF32 is off, so
    the policy's float32 convolutions of a rank and of the one-process run
    differ by their summation order only.

    -> "bits0", K1's masks of the first tick's policy call, and "ctrl0",
    its controls; "launches" of K1 and "k2_launches" of K2 (the ray
    caster, which the Roach rollout does not run) in the rollout;
    "seconds"; "summary"
    (over every rank) and "local" (this rank's worlds); on the last frame,
    "last_off" pixels where K1 differs from its plain version and
    "last_nonzero" nonzero pixels of the plain version; "peak_gib"."""
    from thinktwice_tpu_torch.ops.birdview_cuda import K1, birdview_bits, birdview_bits_plain
    from thinktwice_tpu_torch.ops.raycast_cuda import K2
    from thinktwice_tpu_torch.rollout import grid_world, rollout
    from thinktwice_tpu_torch.sensors.birdview import birdview_inputs
    from thinktwice_tpu_torch.weights import load_roach_policy

    dev = torch.device(device) if group is None else group.device
    policy = load_roach_policy(weights, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    town, states = grid_world(cfg, n_worlds, n_vehicles, device=dev, generator=g)
    worlds = None
    if group is not None:
        states = shard_worlds(group, states)
        worlds = world_slice(group, states.n_worlds)
    bits0 = birdview_bits(cfg.birdview, *birdview_inputs(cfg.birdview, town, states))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    K1.launches = K2.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    final, _, controls = rollout(cfg, policy, town, states, n_ticks, generator=g,
                                 worlds=worlds)
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches, k2_launches = K1.launches, K2.launches
    prims, ego = birdview_inputs(cfg.birdview, town, final)
    bits_k = birdview_bits(cfg.birdview, prims, ego)
    bits_p = birdview_bits_plain(cfg.birdview, prims, ego)
    _sync(dev)
    return {"bits0": bits0.cpu(), "ctrl0": controls[0].cpu(), "launches": launches,
            "k2_launches": k2_launches, "seconds": seconds, "summary": summarize_events(final, group),
            "local": summarize_events(final), "last_off": int((bits_k != bits_p).sum()),
            "last_nonzero": int((bits_p != 0).sum()), "pixels": bits_p.numel(),
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None)}


def autopilot_rollout_rank(group: Group, cfg: Config, town, state_arrays: dict,
                           draws: list | None, n_steps: int, seed: int = 0) -> dict:
    """batched_rollout with the autopilot over the group: each rank takes
    its share of the worlds in state_arrays (state_to_arrays' layout) and
    its rows of each tick's draws of all the worlds: those given, or else a
    generator's seeded with seed on the rank's device. -> "summary" (over
    every rank), and on rank 0 "final", every rank's final worlds gathered,
    as arrays."""
    from thinktwice_tpu_torch.agents.autopilot import autopilot_control

    dev = group.device
    states = shard_worlds(group, state_from_arrays(state_arrays, device=dev))
    if draws is not None:
        draws = [tree_map(lambda x: x.to(dev), d) for d in draws]
    final = batched_rollout(cfg, town.to(dev), states, autopilot_control, n_steps,
                            draws=draws, generator=torch.Generator(device=dev).manual_seed(seed),
                            group=group)
    full = gather_worlds(group, final)
    return {"summary": summarize_events(final, group),
            "final": None if full is None else state_to_arrays(full)}
