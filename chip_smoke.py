"""Chip smoke test of the PyTorch port: builds every CUDA kernel of the
closed-loop rollouts from the sources in this checkout (one nvcc per
source, all at once), holds each against its plain PyTorch version on the
card at the shapes its rollout gives it, checks the port on the card
against its CPU run on small inputs, and drives both rollouts:

- the Roach rollout at the bench's shape (64 worlds on the 2-block grid
  town, 120 vehicles, 15 x 192 x 192 birdview through K1, the roach_rl6
  expert, policy every 2 ticks);
- the ThinkTwice student's closed loop at the full width of the
  student_rl6 archive (8 worlds, 4 cameras of 256 x 512 and a 64 x 1024
  lidar through K2, ResNet-50 two-sweep model, policy every tick, 40 ticks,
  K3 and K4 in each refine layer); then K3 and K4 against their plain
  versions and timed on one policy call's inputs at the closed loop's
  shape (8 worlds, 448 x 896 cameras);
- the student's training: the roach_rl6 expert collects in the loop (K1 in
  the expert, K2 in the cameras and the lidar) one world's chunks of 13
  frames, 8 two-sweep examples each, and `loop.train` takes 3 AdamW steps
  of student_rl6 at full width on them; then one train step of a small
  student on the card against the CPU, and the parameter archive read
  back;
- the Roach expert's training on the grid town: PPO at the fine-tune
  recipe (24 worlds x 128 macro steps of 2 ticks, 48 vehicles, roach_bc5
  anchored to itself, 4 epochs of minibatches of 512) for two iterations,
  K1 against its plain version on a rollout frame, a small PPO iterate on
  the card against the CPU, the breakdown of a macro step; then BC at its
  recipe (24 worlds x 256 ticks, 96 vehicles, perturbation 0.05) for one
  iteration and the held-out probe (8 worlds x 384 ticks), and a small BC
  iterate on the card against the CPU;
- several processes (`parallel/launch.py`, one joined within a time limit
  for each rank): the data-parallel step of student_rl6 on the collected
  batch (its first example mirrored) over 2 gloo ranks sharing the card,
  against the one-process step in float32 (at the end of the training
  phases); the dry run of `thinktwice_tpu_torch.dryrun` with NCCL on one
  rank at the frozen and the mid shapes; and the Roach rollout at the
  bench's shape split over 2 gloo ranks sharing the card (32 worlds each,
  K1 on every rank) against the one-process run with the same draws;
- an imported town through the bench's entry point (`bench.town05_world`):
  the 6 x 6-block grid town's rasters as the town's file, lane-graph
  routes and the town's lane loops as route XMLs, planned by the
  RasterPlanner, compiled at the bench's Town05 capacities and cached, the
  cache file read back; the Roach rollout
  at the bench's shape on it with Scenario3 and Scenario7 armed (K1 on
  ~26,000 table rows a world, above the kernel's 4096-row chunk), K1
  against its plain version and timed there, one route cut to 30 m
  evaluated on the card against the CPU; then one world's collection on it
  exported in the reference's dataset layout and read back, without PIL
  or cv2 (K2 against its plain version on its last frame);
- the Longest6 evaluation of scripts/eval_longest6.py on that town: its
  Config with 500 background vehicles (508 slots, 302 active: Town05's
  spawn points), the six longest lane-graph routes planned to 3,584
  points with map-derived scenarios, 6 worlds in 256-tick segments to
  1,024 ticks, stop penalty 1.0; K1 against its plain version on the last
  policy call's 508-slot table, timed, and render_birdview_rgb of K1's
  masks against the plain version's.

Depths cut to keep the run within its clock: the expert evaluation stops
at 1,024 ticks, the BC probe at 384, the small card-vs-CPU train step
takes one example. A `[phase seconds]` line gives each phase's wall
seconds.

    python3 chip_smoke.py                       # on a machine with one card
    python3 chip_smoke.py --device cpu --small  # CPU rehearsal, plain versions

It imports torch, numpy, the standard library and thinktwice_tpu_torch
only. Any failed phase raises and the script exits non-zero. Output: progress
lines, then one JSON line of the kernels, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "runs", "roach_rl6", "params.msgpack")
STUDENT_WEIGHTS = os.path.join(REPO, "runs", "student_rl6", "params.msgpack")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
K1_FLOP_PER_PAIR = 15      # float operations of one pixel-primitive test
K1_FLOP_PER_PIXEL = 8      # the pixel's world coordinates
MISMATCH_LIMIT = 1e-4      # share of pixels where K1 may differ from plain
N_WORLDS, N_VEHICLES = 64, 120   # the bench's shape (bench.py:38-41)
N_TICKS = 200              # ticks of the timed rollout, policy every 2
K2_FLOP_PER_PAIR = 45      # float operations of one ray-box slab test
K2_FLOP_PER_CULL = 42      # float operations of one (tile, box) cone-sphere test
K2_RTOL = 1e-5             # t of K2 against its plain version (see compare_k2)
STUDENT_WORLDS, STUDENT_TICKS = 8, 40   # policy every tick; the ring warms at 10
STUDENT_WARMUP = 3         # untimed student ticks before the timed run
SPARSE_TICKS = 4           # timed ticks of the student with the sparse LiDAR encoder
STUDENT_CTRL_TOL = 5e-2    # card vs CPU controls of the bfloat16 student
EVAL_TOL = 1e-2            # card vs CPU record floats (scores, route_length, duration_game)
EVAL_SEGMENT = 256         # ticks between the expert evaluation's done checks
EVAL_EXPERT_TICKS = 1024   # the expert evaluation's tick bound, cut from its timeout's 3072
TRAIN_CPU_EXAMPLES = 1     # [train card vs cpu]: the collected examples of its step
STUDENT_EVAL_STEPS, STUDENT_EVAL_SEGMENT = 40, 20
TRAIN_FRAMES = 13          # frames a chunk: 13 - 4 - 1 = 8 two-sweep examples
TRAIN_FRAMES_SMALL = 7     # the rehearsal's chunk: 2 examples, one a rank of [ddp step]
TRAIN_STEPS = 3            # optimizer steps of student_rl6
TRAIN_TOL = 1e-3           # card vs CPU float32 train step: losses, grad_norm, the update
GRAD_TOL, GRAD_COS = 1e-2, 0.99   # ... its gradient: of the norm; each leaf's cosine
BC5_WEIGHTS = os.path.join(REPO, "runs", "roach_bc5", "params.msgpack")
PPO_ENVS, PPO_STEPS, PPO_ITERS = 24, 128, 2   # the fine-tune recipe, two iterations
BC_ROUTES = 32             # grid routes of the BC recipe; the tail 8 are the probe's
BC_PROBE_TICKS = 384       # the probe's ticks, cut from the recipe's 768
DDP_RANKS = 2              # gloo ranks sharing the one card in [ddp step] and [worlds sharded]
DDP_TIMEOUT = 600.0        # s a spawned group may take before its ranks are killed
SHARDED_SEED = 45          # the generator of the sharded rollout's resets and draws
SHARDED_CTRL_TOL = 1e-5    # the first tick's controls, a rank against the one-process run
SHARDED_COMPLETION_TOL = 1e-4  # the sharded summary's mean completion against the one-process
TOWN_BLOCKS = 6            # [town import]: 6 x 6 blocks of 100 m, 3,200 px a side at 5 px/m
TOWN_ROUTES, TOWN_MAX_TRIES = 80, 1000   # lane-graph routes of 100-370 m, and the tries for them
KEYPOINT_M = 25.0          # a route keypoint every ~25 m, densified by the RasterPlanner
TOWN_SEED = 46             # the generator of the imported town's resets and draws
TOWN_CPU_ROUTE_M = 30      # [town card vs cpu]: one route cut to 30 m,
TOWN_CPU_TICKS, TOWN_CPU_SEGMENT = 400, 20   # run to done or 400 ticks, checked every 20
EXPORT_FRAMES = 7          # [reference export]: one world's frames, 7 - 4 = 3 dataset items
# [longest6]: scripts/eval_longest6.py:107-117 with --vehicles 500 on the imported town
L6_VEHICLES = 500          # background vehicles asked for; 8 more slots for scenario actors
L6_SPAWN_CAP = 302         # CARLA_SPAWN_POINTS["Town05"] (eval_longest6.py:73-80)
L6_ROUTE_LEN = 3584        # eval_longest6.py MAX_ROUTE_LEN
L6_WORLDS, L6_SEGMENT = 6, 256   # the script's --worlds-per-batch and --segment
L6_TICKS = 1024            # the tick bound of the cut evaluation: 4 segments
L6_ROUTE_TRIES = 120       # lane-graph routes tried; the six longest are kept
L6_SEED = 47               # the route generator's seed


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseClock:
    """Wall seconds of each phase of the run, from the script's start."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.secs: dict[str, float] = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.secs[name] = now - self.last
        self.last = now

    def line(self) -> str:
        total = time.perf_counter() - self.t0
        return ("[phase seconds] " + ", ".join(f"{k} {v:.1f}" for k, v in self.secs.items())
                + f"; total {total:.1f}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound(cfg, prims, ego):
    """(bound_ms, bound_by, pairs): the least time of K1's work on an H100.
    Bytes: the primitive and ego tables read once, the masks written once.
    Operations: every pixel's coordinates plus one coverage test for each
    (pixel, primitive) pair whose primitive's bounding box holds the pixel,
    counted on these inputs."""
    from thinktwice_tpu_torch.ops.birdview_cuda import pixel_world_coords, row_bounds

    B, NP, _ = prims.shape
    W = cfg.width
    wx, wy = pixel_world_coords(cfg, ego)
    wx, wy = wx[..., None], wy[..., None]
    x0, x1, y0, y1 = row_bounds(prims)
    used = prims[..., 1] >= 0
    pairs = 0
    for k0 in range(0, NP, 64):
        k = slice(k0, k0 + 64)
        inside = ((wx >= x0[:, None, k]) & (wx <= x1[:, None, k]) & (wy >= y0[:, None, k])
                  & (wy <= y1[:, None, k]) & used[:, None, k])
        pairs += int(inside.sum())
    n_bytes = prims.numel() * 4 + ego.numel() * 4 + B * W * W * 4
    flops = pairs * K1_FLOP_PER_PAIR + B * W * W * K1_FLOP_PER_PIXEL
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), pairs


def compare_k1(cfg, town, states, tag: str):
    """Run K1 and its plain version on the same inputs; assert agreement.
    -> (mismatched pixels, max abs error of the decoded channels, prims, ego)."""
    from thinktwice_tpu_torch.ops.birdview_cuda import (
        birdview_bits_cuda,
        birdview_bits_plain,
        decode_bits,
    )
    from thinktwice_tpu_torch.sensors.birdview import birdview_inputs

    prims, ego = birdview_inputs(cfg, town, states)
    bits_k = birdview_bits_cuda(cfg, prims, ego)
    bits_p = birdview_bits_plain(cfg, prims, ego)
    torch.cuda.synchronize()
    mism = int((bits_k != bits_p).sum())
    n_px = bits_k.numel()
    err = float((decode_bits(cfg, bits_k) - decode_bits(cfg, bits_p)).abs().max())
    log(f"[k1 vs plain, {tag}] {tuple(prims.shape)} prims -> {tuple(bits_k.shape)}: "
        f"{mism} of {n_px} pixels differ ({mism / n_px:.2e}), max abs err {err}")
    if mism > MISMATCH_LIMIT * n_px:
        raise AssertionError(f"K1 disagrees with its plain version on {mism} pixels")
    if int((bits_p != 0).sum()) == 0:
        raise AssertionError("the birdview is empty")
    return mism, err, prims, ego


def check_small_reference(cfg, policy_cpu, device):
    """The port on the card against the port on the CPU (plain versions),
    two worlds for four ticks with the same draws: the same counters and
    events, poses within 1e-3 m, policy outputs within 1e-4."""
    from thinktwice_tpu_torch.agents.expert import expert_control
    from thinktwice_tpu_torch.rollout import grid_world
    from thinktwice_tpu_torch.sim.state import state_to_arrays, tree_map
    from thinktwice_tpu_torch.sim.step import sample_step_draws, step_world

    g = torch.Generator().manual_seed(7)
    town_c, st_c = grid_world(cfg, 2, 120, device="cpu", generator=g)
    town_d = town_c.to(device)
    st_d = tree_map(lambda x: x.to(device), st_c)
    policy_d = policy_cpu.__class__.from_config(cfg).to(device)
    policy_d.load_state_dict(policy_cpu.state_dict())
    policy_d.eval()
    for t in range(4):
        draws = sample_step_draws(town_c, st_c, g)
        if t % 2 == 0:
            ctrl_c, sup_c = expert_control(cfg, policy_cpu, town_c, st_c)
            ctrl_d, sup_d = expert_control(cfg, policy_d, town_d, st_d)
            for key in ("alpha", "beta"):
                e = float((sup_c[key] - sup_d[key].cpu()).abs().max())
                if e > 1e-4:
                    raise AssertionError(f"policy {key} differs by {e} on the card")
            if not torch.equal(sup_c["only_ap_brake"], sup_d["only_ap_brake"].cpu()):
                raise AssertionError("only_ap_brake differs on the card")
        # hold both at the CPU's control so the worlds stay comparable
        d_draws = dataclasses.replace(
            draws, steer_normal=draws.steer_normal.to(device),
            recycle_cand=draws.recycle_cand.to(device))
        st_c, ev_c = step_world(cfg, town_c, st_c, ctrl_c, draws=draws)
        st_d, ev_d = step_world(cfg, town_d, st_d, ctrl_c.to(device), draws=d_draws)
    a, b = state_to_arrays(st_c), state_to_arrays(st_d)
    worst = _compare_arrays(a, b)
    log(f"[small reference] 2 worlds x 4 ticks, card vs CPU: worst pose diff {worst:.2e} m")
    if worst > 1e-3:
        raise AssertionError(f"card and CPU worlds differ by {worst} m")


def _compare_arrays(a, b, path=""):
    worst = 0.0
    for k, v in a.items():
        if isinstance(v, dict):
            worst = max(worst, _compare_arrays(v, b[k], path + k + "."))
        elif v.dtype.kind == "f":
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"{path}{k} is not finite")
            worst = max(worst, float(np.max(np.abs(v - b[k]))) if v.size else 0.0)
        elif not np.array_equal(v, b[k]):
            raise AssertionError(f"{path}{k} differs between card and CPU")
    return worst


def breakdown(cfg, policy, town, states, g):
    """Where a tick's time goes at this shape: each stage of the expert and
    the world step timed alone by CUDA events, and the device's busy share
    over 10 ticks of the rollout by the profiler."""
    from thinktwice_tpu_torch.agents.expert import expert_control
    from thinktwice_tpu_torch.ops.birdview_cuda import birdview_bits_cuda, decode_bits
    from thinktwice_tpu_torch.rollout import rollout
    from thinktwice_tpu_torch.sensors.birdview import birdview_inputs
    from thinktwice_tpu_torch.sim.step import step_world

    prims, ego = birdview_inputs(cfg.birdview, town, states)
    bits = birdview_bits_cuda(cfg.birdview, prims, ego)
    obs = decode_bits(cfg.birdview, bits)
    sv = torch.zeros((obs.shape[0], cfg.roach.state_dim), device=obs.device)
    ctrl, _ = expert_control(cfg, policy, town, states)
    with torch.no_grad():
        stages = {
            "birdview_inputs": lambda: birdview_inputs(cfg.birdview, town, states),
            "k1": lambda: birdview_bits_cuda(cfg.birdview, prims, ego),
            "decode_bits": lambda: decode_bits(cfg.birdview, bits),
            "policy": lambda: policy(obs, sv),
            "expert_control": lambda: expert_control(cfg, policy, town, states),
            "step_world": lambda: step_world(cfg, town, states, ctrl, generator=g),
        }
        times = {k: cuda_ms(fn, reps=10) for k, fn in stages.items()}
    log("[breakdown] ms per call at " f"{states.n_worlds} worlds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))

    log(device_busy(lambda: rollout(cfg, policy, town, states, 10, generator=g),
                    "10 ticks"))


def device_busy(fn, what: str, tag: str = "[breakdown]") -> str:
    """Wall time of fn() and the device's busy time under the profiler: the
    union of the kernels' and copies' intervals on the card (the CPU ops
    that launched them carry the same time again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return f"{tag} {what}: device busy share not measured (no device time in the trace)"
    busy_us, end = 0.0, float("-inf")
    for t0_us, t1_us in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if t1_us > end:
            busy_us += t1_us - max(t0_us, end)
            end = t1_us
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.end - e.time_range.start
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return (f"{tag} {what} under the profiler: {wall * 1e3:.1f} ms wall, "
            f"{busy_us / 1e3:.1f} ms device busy ({busy_us / 1e6 / wall:.1%}), "
            f"{len(kernels)} device kernels and copies; top: "
            + "; ".join(f"{name[:40]} {us / 1e3:.2f} ms x{n}" for name, (us, n) in top))


# --------------------------------------------------------------------------
# the route evaluator


def small_config():
    """The JAX suite's small_cfg capacities: the rehearsal's Roach rollout
    and the card-vs-CPU evaluation."""
    from thinktwice_tpu_torch.config import Config, SimConfig

    return Config(sim=SimConfig(max_vehicles=16, max_walkers=8, max_lights=64,
                                max_stop_signs=8, max_route_len=256, max_scenarios=8))


def eval_routes_small():
    """Three grid routes: a straight, one through the lit junction (100, 100)
    that gets map-derived scenarios, and another straight."""
    routes = []
    for x0, y, length, n in ((8.0, -1.75, 60.0, 128), (70.0, 98.25, 70.0, 200),
                             (20.0, 198.25, 50.0, 128)):
        xs = np.linspace(x0, x0 + length, n)
        routes.append(np.stack([xs, np.full_like(xs, y), np.zeros_like(xs)], 1)
                      .astype(np.float32))
    return routes, ["straight", "junction with scenarios", "straight 2"]


def run_eval(cfg, town, routes, policy_fn, **kw):
    """evaluate_routes into a temporary results file -> (global record,
    records, batch log, wall seconds)."""
    import tempfile

    from thinktwice_tpu_torch.harness.evaluator import evaluate_routes
    from thinktwice_tpu_torch.harness.statistics import load_results

    log = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.json")
        if town.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = evaluate_routes(cfg, town, routes, [str(i) for i in range(len(routes))],
                            policy_fn, out_path=out, batch_log=log, **kw)
        if town.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        records = load_results(out)["_checkpoint"]["records"]
    return g, records, log, wall


def compare_records(a, b, tag: str) -> float:
    """Records of two runs: equal indices, statuses and infraction counts;
    scores, route_length and duration_game within EVAL_TOL. -> worst diff."""
    if [r["index"] for r in a] != [r["index"] for r in b]:
        raise AssertionError(f"{tag}: the runs hold different routes")
    worst = 0.0
    for x, y in zip(a, b):
        if x["status"] != y["status"]:
            raise AssertionError(f"{tag}: route {x['index']} {x['status']!r} vs {y['status']!r}")
        if ({k: len(v) for k, v in x["infractions"].items()}
                != {k: len(v) for k, v in y["infractions"].items()}):
            raise AssertionError(f"{tag}: route {x['index']} infraction counts differ")
        for v, w in ([(x["scores"][k], y["scores"][k]) for k in x["scores"]]
                     + [(x["meta"][k], y["meta"][k]) for k in ("route_length", "duration_game")]):
            if not np.isfinite(v):
                raise AssertionError(f"{tag}: a record field is not finite")
            worst = max(worst, abs(v - w))
    if worst > EVAL_TOL:
        raise AssertionError(f"{tag}: record floats differ by {worst}")
    return worst


def eval_card_vs_cpu(policy_cpu, device, small: bool):
    """A small evaluation run once on `device` and once on the CPU with the
    same draws (drawn on the CPU): the autopilot, and the roach_rl6 expert
    at reduced capacities, 3 routes in batches of 2 (the last one padded),
    one with map-derived scenarios. The records must be equal in every
    count and status and within EVAL_TOL in every float but duration_system."""
    from thinktwice_tpu_torch.agents.autopilot import autopilot_control
    from thinktwice_tpu_torch.agents.expert import make_expert_policy
    from thinktwice_tpu_torch.harness.evaluator import (
        GeneratorDraws, build_route_scenarios, derive_map_triggers)
    from thinktwice_tpu_torch.maps.procedural import make_grid_town
    from thinktwice_tpu_torch.weights import load_roach_policy

    cfg = small_config()
    routes, _ = eval_routes_small()
    max_steps, segment = (8, 4) if small else (96, 32)
    for name in ("autopilot", "expert"):
        runs = {}
        for dev in (torch.device(device), torch.device("cpu")):
            town = make_grid_town(n_blocks=2, block=100.0, device=dev)
            scen = build_route_scenarios(cfg, routes[1], derive_map_triggers(town, routes[1]),
                                         device=dev)
            if name == "autopilot":
                fn = autopilot_control
            else:
                pol = policy_cpu if dev.type == "cpu" else load_roach_policy(WEIGHTS, cfg, dev)
                fn = make_expert_policy(cfg, pol)
            runs[dev.type] = run_eval(
                cfg, town, routes, fn, n_vehicles=8, max_steps=max_steps, worlds_per_batch=2,
                segment_steps=segment, policy_every=2, scenarios=[None, scen, None],
                draws=GeneratorDraws(5, device="cpu"))
        (g_d, rec_d, log_d, wall_d), (g_c, rec_c, _, wall_c) = runs[device.type], runs["cpu"]
        worst = compare_records(rec_d, rec_c, f"eval card vs cpu, {name}")
        log(f"[eval card vs cpu] {name}: {len(rec_d)} routes in batches of 2 "
            f"({[b['routes'] for b in log_d]} routes, {log_d[0]['ticks']} ticks each), "
            f"statuses {[r['status'] for r in rec_d]}, driving score "
            f"{g_d['scores']['score_composed']:.4f} on {device.type} and "
            f"{g_c['scores']['score_composed']:.4f} on cpu; record floats within {worst:.2e} "
            f"(limit {EVAL_TOL}); {wall_d:.2f} s on {device.type}, {wall_c:.2f} s on cpu")


def eval_summary(g, records) -> str:
    infr = {k: sum(len(r["infractions"][k]) for r in records) for k in records[0]["infractions"]}
    statuses = {}
    for r in records:
        statuses[r["status"]] = statuses.get(r["status"], 0) + 1
    s = g["scores"]
    return (f"driving score {s['score_composed']:.4f}, route completion {s['score_route']:.4f}, "
            f"infraction penalty {s['score_penalty']:.4f}; statuses {statuses}; "
            f"infractions {{{', '.join(f'{k}: {v}' for k, v in infr.items() if v)}}}")


def eval_path(cfg, device, n_worlds: int, policy_fn, **kw):
    """An evaluation main path: evaluate_routes over n_worlds grid routes in
    one batch, with K1's and K2's counts set to 0 just before and read just
    after. -> (global record, records, ticks run, seconds, wall with the
    results file, K1 launches, K2 launches)."""
    from thinktwice_tpu_torch.maps.procedural import make_grid_town
    from thinktwice_tpu_torch.ops.birdview_cuda import K1
    from thinktwice_tpu_torch.ops.raycast_cuda import K2
    from thinktwice_tpu_torch.rollout import grid_routes

    town = make_grid_town(n_blocks=2, block=100.0, device=device)
    routes = list(grid_routes(n_worlds, cfg.sim.max_route_len))
    K1.launches = K2.launches = 0
    g, records, blog, wall = run_eval(cfg, town, routes, policy_fn,
                                      worlds_per_batch=n_worlds, **kw)
    k1_n, k2_n = K1.launches, K2.launches
    if len(records) != n_worlds:
        raise AssertionError("the evaluation lost a route")
    if not all(np.isfinite(v) for r in records for v in r["scores"].values()):
        raise AssertionError("an evaluation score is not finite")
    return g, records, blog[0]["ticks"], blog[0]["seconds"], wall, k1_n, k2_n


def eval_expert(cfg, policy, device, n_worlds: int, n_vehicles: int, card: str,
                max_steps=None, segment=EVAL_SEGMENT):
    """The expert evaluation: the roach_rl6 expert every 2 ticks, to every
    world's done or the timeout bound (or max_steps)."""
    from thinktwice_tpu_torch.agents.expert import make_expert_policy

    g, records, ticks, seconds, wall, k1_n, k2_n = eval_path(
        cfg, device, n_worlds, make_expert_policy(cfg, policy), n_vehicles=n_vehicles,
        segment_steps=segment, policy_every=2, seed=42, max_steps=max_steps)
    expected = ticks // 2 if device.type == "cuda" else 0
    log(f"[eval expert] {n_worlds} grid routes in 1 batch of {n_worlds} worlds, {n_vehicles} "
        f"vehicles, policy every 2 ticks, {segment}-tick segments"
        + (f", at most {max_steps} ticks" if max_steps else ", to done or the timeout bound")
        + f": {ticks} ticks run in {seconds:.3f} s ({wall:.3f} s with the results file): "
        f"{n_worlds * ticks / seconds:.1f} env-steps/s on {card}; K1 launches {k1_n} "
        f"(expected {expected}), K2 launches {k2_n}")
    log(f"[eval expert] {eval_summary(g, records)}; game time "
        f"{min(r['meta']['duration_game'] for r in records):.2f}-"
        f"{max(r['meta']['duration_game'] for r in records):.2f} s")
    if k1_n != expected or k2_n != 0 or (device.type == "cuda" and k1_n == 0):
        raise AssertionError(f"the expert evaluation launched K1 {k1_n} times, expected {expected}")
    if device.type == "cuda":
        log(device_busy(lambda: eval_path(cfg, device, n_worlds, make_expert_policy(cfg, policy),
                                          n_vehicles=n_vehicles, segment_steps=32,
                                          policy_every=2, seed=42, max_steps=32),
                        f"a {n_worlds}-world evaluation of 32 ticks", "[eval breakdown]"))


def eval_student(cfg, model, device, n_worlds: int, n_vehicles: int, card: str,
                 max_steps=STUDENT_EVAL_STEPS, segment=STUDENT_EVAL_SEGMENT):
    """The student evaluation: the student adapter (its DriverState the
    carry) every tick for max_steps ticks."""
    from thinktwice_tpu_torch.agents.thinktwice_driver import make_student_policy

    policy_fn, policy_init = make_student_policy(cfg, model, policy_every=1)
    g, records, ticks, seconds, wall, k1_n, k2_n = eval_path(
        cfg, device, n_worlds, policy_fn, policy_init=policy_init, n_vehicles=n_vehicles,
        max_steps=max_steps, segment_steps=segment, seed=43)
    expected = 2 * ticks if device.type == "cuda" else 0
    log(f"[eval student] {n_worlds} grid routes in 1 batch of {n_worlds} worlds, {n_vehicles} "
        f"vehicles, policy every tick, {segment}-tick segments, at most {max_steps} ticks: "
        f"{ticks} ticks run in {seconds:.3f} s ({wall:.3f} s with the results file): "
        f"{n_worlds * ticks / seconds:.2f} env-steps/s on {card}; K2 launches {k2_n} "
        f"(expected {expected}), K1 launches {k1_n}")
    log(f"[eval student] {eval_summary(g, records)}")
    if k2_n != expected or k1_n != 0 or (device.type == "cuda" and k2_n == 0):
        raise AssertionError(
            f"the student evaluation launched K2 {k2_n} times, expected {expected}")
    if ticks != max_steps:
        raise AssertionError("the student evaluation stopped early")


# --------------------------------------------------------------------------
# the ThinkTwice student and K2


def student_tiny_config():
    """The JAX suite's TINY shapes (tests/test_pipeline.py) for the checks on
    small inputs."""
    from thinktwice_tpu_torch.config import (
        CameraConfig, Config, LidarConfig, ModelConfig, SimConfig)

    return Config(
        sim=SimConfig(max_vehicles=8, max_walkers=4, max_route_len=256, max_scenarios=4),
        camera=CameraConfig(height=32, width=64), lidar=LidarConfig(n_beams=4, n_azimuth=64),
        model=ModelConfig(img_height=32, img_width=64, refine_num=1, bev_channels=64,
                          n_depth_bins=16, lidar_pillar_grid=84),
    )


def tiny_student(cfg, device):
    """A two-sweep ResNet-10 student with random weights from seed 0."""
    from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel

    torch.manual_seed(0)
    return ThinkTwiceModel(cfg.model, backbone_depth=10, n_sweeps=2,
                           n_cams=cfg.camera.n_cams).to(device).eval()


class Spy:
    """Records the arguments (and results) of module.name's calls while the
    block runs, the last `keep` of them (all with keep None), and counts
    them all."""

    def __init__(self, module, name: str, keep: int | None = None):
        self._mod, self._name, self._keep = module, name, keep

    def __enter__(self):
        self._real = getattr(self._mod, self._name)
        self.calls, self.results, self.count = [], [], 0

        def record(*args, **kwargs):
            out = self._real(*args, **kwargs)
            self.count += 1
            self.calls.append(args + tuple(kwargs.values()))
            self.results.append(out)
            if self._keep is not None:
                del self.calls[:-self._keep], self.results[:-self._keep]
            return out

        setattr(self._mod, self._name, record)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self._name, self._real)


def K2Inputs(keep: int | None = None):
    """Records the rays and box tables (origins, dirs, table, grid) that
    cast_scene hands to K2 (or its plain version) while the block runs."""
    from thinktwice_tpu_torch.sensors import raycast

    return Spy(raycast, "ray_boxes_table", keep)


def k2_inputs(cfg, town, states):
    """[(name, origins, dirs, table, grid)] of one policy call: the cameras'
    rays (every camera of every world, grid (H, W)) and the lidar's (grid
    (beams, azimuths))."""
    from thinktwice_tpu_torch.sensors.camera import cameras_from_state
    from thinktwice_tpu_torch.sensors.lidar import lidar_from_state

    with K2Inputs() as rec:
        cameras_from_state(cfg.camera, town, states)
        lidar_from_state(cfg.lidar, town, states)
    return [(name, *call) for name, call in zip(("cameras", "lidar"), rec.calls)]


def compare_k2(inputs, tag: str) -> float:
    """K2 against its plain version on the same inputs, with the main path's
    grids and on a ray count that is no multiple of a block (without a
    grid). The hit masks and indices must be equal and t within K2_RTOL
    (both do the same IEEE operations: t is expected to be equal bit for
    bit, and the count of rays where it is not is printed). K2 without a
    grid must equal K2 with one bit for bit. -> max abs error of t."""
    from thinktwice_tpu_torch.ops.raycast_cuda import ray_boxes_cuda, ray_boxes_plain

    cases = list(inputs)
    name, o, d, table, _ = inputs[0]
    r = o.shape[1] - 77
    cases.append((f"{name} ragged", o[:, :r].contiguous(), d[:, :r].contiguous(), table, None))
    worst = 0.0
    for name, o, d, table, grid in cases:
        t_k, i_k = ray_boxes_cuda(o, d, table, grid)
        t_p, i_p = ray_boxes_plain(o, d, table)
        torch.cuda.synchronize()
        hit = i_p >= 0
        n_idx = int((i_k != i_p).sum())
        n_hit = int(((i_k >= 0) != hit).sum())
        n_t = int((t_k != t_p).sum())
        err = float((t_k - t_p).abs().max())
        rel = float(((t_k - t_p).abs() / t_p.abs().clamp_min(1e-30))[hit].max()) \
            if bool(hit.any()) else 0.0
        worst = max(worst, err)
        log(f"[k2 vs plain, {tag}, {name}] {tuple(o.shape[:2])} rays x {table.shape[1]} boxes, "
            f"grid {grid}: {n_idx} indices and {n_hit} hit flags differ, t differs on {n_t} "
            f"rays (max abs {err}, max rel {rel:.2e}); {int(hit.sum())} rays hit a box")
        if n_idx or n_hit or rel > K2_RTOL:
            raise AssertionError(f"K2 disagrees with its plain version ({name}, {tag})")
        if not bool(hit.any()):
            raise AssertionError(f"no ray hit a box ({name}, {tag})")
        if grid is not None:
            t_n, i_n = ray_boxes_cuda(o, d, table, None)
            torch.cuda.synchronize()
            n_diff = int((i_n != i_k).sum()) + int((t_n != t_k).sum())
            log(f"[k2 grid vs none, {tag}, {name}] {n_diff} rays differ")
            if n_diff:
                raise AssertionError(f"K2 depends on the grid ({name}, {tag})")
    return worst


def k2_bound(inputs) -> dict:
    """The least time of one policy call's K2 work on an H100, for the
    data-dependent work these
    inputs need: the (ray, box) pairs that the per-tile cull keeps, each a
    slab test, plus one cone-sphere test for each (tile, box); the kept
    pairs are counted by k2_tile_cull_plain, the kernel's cull. Bytes: rays
    read once, boxes read once, t and idx written once. The all-pairs bound
    (every ray against every box) is given for comparison."""
    from thinktwice_tpu_torch.ops.raycast_cuda import k2_tile_cull_plain

    pairs = tests = all_pairs = n_bytes = 0
    for _, o, d, table, grid in inputs:
        B, R, _ = o.shape
        N = table.shape[1]
        keep, ids = k2_tile_cull_plain(o, d, table, grid)
        pairs += int((keep.sum(-1) * (ids >= 0).sum(-1)).sum())
        tests += keep.numel()
        all_pairs += B * R * N
        n_bytes += B * R * (24 + 12) + table.numel() * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (pairs * K2_FLOP_PER_PAIR + tests * K2_FLOP_PER_CULL) / FP32_FLOP_PER_S * 1e3
    t_all = all_pairs * K2_FLOP_PER_PAIR / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops, pairs=pairs, tests=tests,
                all_pairs=all_pairs, all_pairs_ms=max(t_bytes, t_all))


def k3_bound(value_cams, spatial_shapes, ref_points, offsets, weights) -> dict:
    """The least time of one K3 launch on an H100, by bytes, for what these
    inputs need: each 32-channel head block of value that an inside corner
    of a tap reads, read once; the reference points, offsets and weights
    read once; the output written once. Also the bytes of every tap's
    corners as the kernel reads them (L2 serves the repeats)."""
    from thinktwice_tpu_torch.ops.deform_attn import sampling_locations

    N, B, S, C = value_cams.shape
    H = offsets.shape[3]
    item = value_cams.element_size()
    locs = sampling_locations(spatial_shapes, ref_points, offsets)  # (B, N, Q, H, L, P, 2)
    b = torch.arange(B, device=locs.device)[:, None, None, None, None]
    n = torch.arange(N, device=locs.device)[None, :, None, None, None]
    h = torch.arange(H, device=locs.device)[None, None, None, :, None]
    keys, start = [], 0
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        x = locs[:, :, :, :, lvl, :, 0] * wl - 0.5
        y = locs[:, :, :, :, lvl, :, 1] * hl - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
            row = start + yi.clamp(0, hl - 1).long() * wl + xi.clamp(0, wl - 1).long()
            key = (((n * B + b) * S + row) * H + h).expand_as(inside)
            keys.append(key[inside])
        start += hl * wl
    keys = torch.cat(keys)
    head_bytes = C // H * item
    read = (torch.unique(keys).numel() * head_bytes + ref_points.numel() * 4
            + (offsets.numel() + weights.numel()) * item)
    written = B * N * ref_points.shape[2] * C * item
    bytes_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=bytes_ms, bound_by="bytes", bytes=read + written,
                taps_bytes=keys.numel() * head_bytes)


def k4_bound(maps, coords) -> dict:
    """The least time of one K4 launch on an H100, by bytes: each pixel's
    channels that an inside corner reads, read once; the points read once;
    the float32 output written once. Also the bytes of every corner as the
    kernel reads them."""
    B, N, Q, _ = coords.shape
    C = maps[0].shape[-1]
    item = maps[0].element_size()
    b = torch.arange(B, device=coords.device)[:, None, None]
    n = torch.arange(N, device=coords.device)[None, :, None]
    pixels = corners = 0
    for m in maps:
        hl, wl = m.shape[2], m.shape[3]
        g = coords * 2.0 - 1.0
        x = (g[..., 0] + 1.0) * 0.5 * wl - 0.5
        y = (g[..., 1] + 1.0) * 0.5 * hl - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        keys = []
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
            key = ((n * B + b) * hl + yi.clamp(0, hl - 1).long()) * wl \
                + xi.clamp(0, wl - 1).long()
            keys.append(key[inside])
        keys = torch.cat(keys)
        pixels += torch.unique(keys).numel()
        corners += keys.numel()
    read = pixels * C * item + coords.numel() * 4
    written = B * N * Q * len(maps) * C * 4
    return dict(bound_ms=(read + written) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=read + written, taps_bytes=corners * C * item)


def look_kernels(args, device, card: str):
    """K3 and K4 on the inputs of one policy call of the student_rl6 weights
    at the closed loop's shape (8 worlds, 448 x 896 cameras): their launches
    over the call (once a refine layer each), each against its plain
    version, ms a launch, the plain version's ms and the bound by bytes.
    -> K3's and K4's rows of the kernels line."""
    from thinktwice_tpu_torch.agents.thinktwice_driver import driver_init, make_thinktwice_driver
    from thinktwice_tpu_torch.config import CameraConfig, ModelConfig, bench_config
    from thinktwice_tpu_torch.models import decoder
    from thinktwice_tpu_torch.ops import deform_attn as k3
    from thinktwice_tpu_torch.ops import grid_sample as k4
    from thinktwice_tpu_torch.rollout import grid_world
    from thinktwice_tpu_torch.weights import load_student_model

    cfg = bench_config().replace(camera=CameraConfig(height=448, width=896),
                                 model=ModelConfig(img_height=448, img_width=896))
    model = load_student_model(args.student_weights, cfg, device=device)
    g = torch.Generator(device=device).manual_seed(44)
    town, states = grid_world(cfg, STUDENT_WORLDS, N_VEHICLES, device=device, generator=g)
    policy = make_thinktwice_driver(cfg, model)
    driver = driver_init(cfg, STUDENT_WORLDS, model.n_sweeps, device=device)
    _, driver = policy(town, states, driver, generator=g)
    torch.cuda.synchronize()
    before = k3.K3.launches, k4.K4.launches
    with Spy(decoder, "deform_attn_cams", keep=1) as rec3, \
            Spy(decoder, "sample_levels", keep=1) as rec4:
        policy(town, states, driver, generator=g)
    torch.cuda.synchronize()
    n3, n4 = k3.K3.launches - before[0], k4.K4.launches - before[1]
    if (n3, n4) != (5, 5):
        raise AssertionError(f"K3 and K4 launched {n3} and {n4} times in a forward, expected 5")
    a3, (maps, coords) = rec3.calls[-1], rec4.calls[-1]
    value = a3[0]
    out = k3.deform_attn_cams_cuda(*a3)
    exact = k3.deform_attn_cams_plain(value.double(), a3[1], a3[2].double(), a3[3].double(),
                                      a3[4].double())
    scale = float(exact.abs().max())
    err3 = float((out.double() - exact).abs().max()) / scale
    err3_plain = float((k3.deform_attn_cams_plain(*a3).double() - exact).abs().max()) / scale
    if err3 > 2 ** -8:
        raise AssertionError(f"K3 differs from the float64 plain version by {err3:.3e}")
    del exact
    ms3 = cuda_ms(lambda: k3.deform_attn_cams_cuda(*a3), reps=50)
    plain3 = cuda_ms(lambda: k3.deform_attn_cams_plain(*a3), reps=5)
    b3 = k3_bound(*a3)
    N, B, S, C = value.shape
    log(f"[k3 vs plain] {B} worlds x {N} cameras x {a3[2].shape[2]} queries x "
        f"{a3[3].shape[3]} heads x {len(a3[1])} levels x {a3[3].shape[5]} points, "
        f"{value.dtype}: K3 within {err3:.3e} of the output's scale of the float64 plain "
        f"version, the plain {value.dtype} version within {err3_plain:.3e}; launches in a "
        f"forward K3 {n3}, K4 {n4}")
    log(f"[k3 time] {ms3:.4f} ms a launch (plain {plain3:.3f} ms, bound {b3['bound_ms']:.4f} ms "
        f"by bytes: {b3['bytes'] / 1e6:.2f} MB, the head blocks of value the taps need read "
        f"once, the offsets, weights and points read and the output written; every tap's "
        f"corners {b3['taps_bytes'] / 1e6:.1f} MB) on {card}")
    out4 = k4.sample_levels_cuda(maps, coords)
    equal4 = torch.equal(out4, k4.sample_levels_plain(maps, coords))
    if not equal4:
        raise AssertionError("K4 differs from its plain version")
    ms4 = cuda_ms(lambda: k4.sample_levels_cuda(maps, coords), reps=50)
    plain4 = cuda_ms(lambda: k4.sample_levels_plain(maps, coords), reps=5)
    b4 = k4_bound(maps, coords)
    log(f"[k4 vs plain] {B} worlds x {N} cameras x {coords.shape[2]} points x {len(maps)} "
        f"levels of {tuple(tuple(m.shape[2:4]) for m in maps)} x {maps[0].shape[-1]} "
        f"channels, {maps[0].dtype}: equal bit for bit")
    log(f"[k4 time] {ms4:.4f} ms a launch (plain {plain4:.3f} ms, bound {b4['bound_ms']:.4f} ms "
        f"by bytes: {b4['bytes'] / 1e6:.2f} MB, the pixels the corners need read once, the "
        f"points read and the float32 output written; every corner {b4['taps_bytes'] / 1e6:.1f}"
        f" MB) on {card}")
    rows = []
    for name, src, err, ms, plain, b in (("deform_attn_cams", "deform_attn.cu", err3, ms3,
                                          plain3, b3),
                                         ("sample_levels", "look_sample.cu", 0.0, ms4, plain4,
                                          b4)):
        rows.append(dict(name=name, route="cuda", source=f"thinktwice_tpu_torch/csrc/{src}",
                         replaces="none", launches_a_forward=5, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                         library_ms=None))
    del model, town, states, driver, rec3, rec4, a3, maps, coords, out, out4
    return rows


def sparse_student(on_card: bool):
    """The student with its published LiDAR encoder (`lidar_encoder="sparse"`)
    as the main path builds it (make_model, its initial parameters): on the
    card at the closed loop's shape (8 worlds, 448 x 896 cameras, 131,072
    points a world), on the CPU the tiny config (a 4 x 64 LiDAR).
    -> (cfg, model, worlds, vehicles)."""
    from thinktwice_tpu_torch.config import CameraConfig, ModelConfig, bench_config
    from thinktwice_tpu_torch.train.loop import make_model

    if on_card:
        cfg = bench_config().replace(
            camera=CameraConfig(height=448, width=896),
            model=ModelConfig(img_height=448, img_width=896, lidar_encoder="sparse"))
        return cfg, make_model(cfg, 50, 2, device="cuda").eval(), STUDENT_WORLDS, N_VEHICLES
    cfg = student_tiny_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, lidar_encoder="sparse"))
    return cfg, make_model(cfg, 10, 2, device="cpu").eval(), 2, 6


def rulebook_mismatch(subm, strided) -> tuple[int, int]:
    """K7's tables of one forward (Spies of subm_rulebook and strided_level)
    against their plain versions on the same input levels: each strided
    level's coordinates and count, and every table's neighbours and active
    pairs. -> (entries that differ, entries compared)."""
    from thinktwice_tpu_torch.ops import sparse_conv as sc

    def plain_level(level):
        n = int(level.n)
        return sc.Level(level.coords[:n].cpu(), level.n.cpu(), level.shape, level.batch)

    def differ(a, b) -> int:
        a = a.cpu()
        return a.numel() + b.numel() if a.shape != b.shape else int((a != b).sum())

    bad = total = 0
    for (level, *_), rb in zip(subm.calls, subm.results):
        want = sc._table_plain(plain_level(level).coords, plain_level(level), rb.kernel, 1,
                               tuple(k // 2 for k in rb.kernel))
        bad += differ(rb.nbr[:int(level.n)], want.nbr) + differ(rb.pairs, want.pairs)
        total += want.nbr.numel() + 1
    for (level, kernel, stride, padding), (out, rb) in zip(strided.calls, strided.results):
        want_out, want = sc._strided_plain(plain_level(level), kernel, stride, padding)
        n = int(out.n)
        bad += differ(out.n, want_out.n) + differ(out.coords[:n], want_out.coords)
        bad += differ(rb.nbr[:n], want.nbr) + differ(rb.pairs, want.pairs)
        total += 2 + want_out.coords.numel() + want.nbr.numel()
    return bad, total


def sparse_lidar(device, card: str, on_card: bool):
    """The student's published LiDAR encoder (`lidar_encoder="sparse"`) on
    its main path: rollout_thinktwice over the closed loop (see
    sparse_student), with K5's and K6's counts set to 0 just before and
    K7's tables counted, each checked against one per forward, 21 sparse
    convolutions and 8 tables; on the last forward's own inputs K5 against
    its plain version (equal bit for bit), every K7 table against its plain
    version (equal), the encoder's dense output against the plain
    version's; ms a launch of K5, K6 and K7, their bounds
    (`port_bench/counts/k5_bound.py`, `k6_bound.py`, `k7_bound.py`), the
    plain versions' ms; the voxels a world, those the cap dropped, and the
    share of the points inside the BEV box that fall outside the z range.
    On the CPU the plain versions, and the launch counts 0. -> K5's, K6's
    and K7's rows of the kernels line (None on the CPU)."""
    from port_bench.counts.k5_bound import k5_bound
    from port_bench.counts.k6_bound import k6_bound
    from port_bench.counts.k7_bound import k7_bound
    from thinktwice_tpu_torch.agents.thinktwice_driver import rollout_thinktwice
    from thinktwice_tpu_torch.models.sparse_lidarnet import SparseConvBN, SparseLidarNet
    from thinktwice_tpu_torch.ops import sparse_conv as sc
    from thinktwice_tpu_torch.ops import voxelize as vx
    from thinktwice_tpu_torch.rollout import grid_world
    from thinktwice_tpu_torch.train.loop import init_model_params

    cfg, model, n_worlds, n_vehicles = sparse_student(on_card)
    net = model.lidar_encoder
    g = torch.Generator(device=device).manual_seed(48)
    with torch.no_grad():
        init_model_params(cfg, model, g)
    town, states = grid_world(cfg, n_worlds, n_vehicles, device=device, generator=g)
    warm = 1 if on_card else 0                       # the first forward is slow: untimed
    states, _, _ = rollout_thinktwice(cfg, town, model, states, warm, generator=g)
    convs = sum(isinstance(m, SparseConvBN) for m in net.modules())
    levels = len(net.middle_encoder.downs) + 1
    ticks = SPARSE_TICKS if on_card else 1
    vx.K5.launches = sc.K6.launches = 0
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Spy(vx, "voxelize", keep=1) as rec5, Spy(net, "encode", keep=1) as rec_enc, \
            Spy(sc, "sparse_conv", keep=convs) as rec6, \
            Spy(sc, "subm_rulebook", keep=levels) as rec7s, \
            Spy(sc, "strided_level", keep=levels) as rec7d:
        final, _, controls = rollout_thinktwice(cfg, town, model, states, ticks, generator=g)
        if on_card:
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n5, n6, n7 = vx.K5.launches, sc.K6.launches, rec7s.count + rec7d.count
    want = (ticks, convs * ticks, 2 * levels * ticks) if on_card else (0, 0, 2 * levels * ticks)
    log(f"[sparse student] {n_worlds} worlds x {ticks} ticks (lidar_encoder=\"sparse\", "
        f"rollout_thinktwice) in {seconds:.3f} s: {n_worlds * ticks / seconds:.2f} env-steps/s on "
        f"{card}; K5 launches {n5}, K6 {n6}, K7 tables {n7} (expected {want[0]}, {want[1]}, "
        f"{want[2]}: a forward 1 voxelization, {convs} sparse convolutions and {2 * levels} "
        f"tables, on the CPU the plain versions)")
    if (n5, n6, n7) != want:
        raise AssertionError(f"the sparse student launched K5, K6, K7 {(n5, n6, n7)} times, "
                             f"expected {want}")
    check_student_run(final, controls, warm + ticks)
    pts, mask, spec = rec5.calls[-1]
    vox = rec5.results[-1]
    lo, hi = cfg.model.sparse_point_range[:3], cfg.model.sparse_point_range[3:]
    box = mask & (pts[..., 0] >= lo[0]) & (pts[..., 0] < hi[0]) & (pts[..., 1] >= lo[1]) \
        & (pts[..., 1] < hi[1])
    outside_z = box & ((pts[..., 2] < lo[2]) | (pts[..., 2] >= hi[2]))
    z_share = float(outside_z.sum()) / max(int(box.sum()), 1)
    t0 = time.perf_counter()
    with torch.no_grad():
        plain_vox = vx.voxelize_plain(pts.cpu(), mask.cpu(), spec)
        plain_k5 = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        net_cpu = SparseLidarNet(cfg.model).eval()
        net_cpu.load_state_dict(net.state_dict())
        plain_dense = net_cpu.encode(plain_vox, n_worlds)
        plain_enc = 1e3 * (time.perf_counter() - t0)
    n, dropped = (int(v) for v in plain_vox.n)
    for name in ("coords", "point_idx", "counts", "feats"):
        if not torch.equal(getattr(vox, name)[:n].cpu(), getattr(plain_vox, name)):
            raise AssertionError(f"K5's {name} differs from its plain version")
    scale = float(plain_dense.abs().max())
    err6 = float((rec_enc.results[-1].cpu() - plain_dense).abs().max()) / scale
    if err6 > 1e-5:
        raise AssertionError(f"the sparse encoder differs from its plain version by {err6:.3e}")
    bad7, total7 = rulebook_mismatch(rec7s, rec7d)
    if bad7:
        raise AssertionError(f"K7's tables differ from their plain versions in {bad7} of "
                             f"{total7} entries")
    if not on_card:
        log(f"[sparse lidar] the last forward's {n_worlds} worlds x {pts.shape[1]} points (plain "
            f"versions): {n / n_worlds:.0f} voxels a world, {dropped} dropped by the cap, "
            f"{z_share:.4%} of the in-box points outside z [{lo[2]}, {hi[2]}) m, {total7} "
            f"entries of {len(rec7s.calls) + len(rec7d.calls)} tables, the encoder's output "
            f"{tuple(plain_dense.shape)} in {plain_enc:.1f} ms")
        return None
    ms5 = cuda_ms(lambda: vx.voxelize_cuda(pts, mask, spec), reps=20)
    calls6 = rec6.calls
    per6 = [cuda_ms(lambda c=c: sc.sparse_conv(*c), reps=5) for c in calls6]
    per7 = [cuda_ms(lambda c=c: sc.subm_rulebook(*c), reps=5) for c in rec7s.calls]
    per7 += [cuda_ms(lambda c=c: sc.strided_level(*c), reps=5) for c in rec7d.calls]
    sum6 = [{"n_in": int(c[1].n_in), "n_out": int(c[1].n_out), "pairs": int(c[1].pairs),
             "K": int(c[1].nbr.shape[1]), "cin": int(c[2].shape[1]), "cout": int(c[2].shape[0]),
             "residual": len(c) > 4 and c[4] is not None} for c in calls6]
    sum7 = [{"n_out": int(r.n_out), "K": int(r.nbr.shape[1]), "n_in": None}
            for r in rec7s.results]
    sum7 += [{"n_out": int(r.n_out), "K": int(r.nbr.shape[1]), "n_in": int(r.n_in)}
             for _, r in rec7d.results]
    b5 = k5_bound([{"B": n_worlds, "P": pts.shape[1], "F": pts.shape[2],
                    "M": spec.max_points, "n": [n, dropped]}])
    b6, b7 = k6_bound(sum6), k7_bound(sum7)
    pairs = sum(c["pairs"] for c in sum6)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"[sparse lidar] the last forward's {n_worlds} worlds x {pts.shape[1]} points: "
        f"{n / n_worlds:.0f} voxels a world ({n} kept, {dropped} dropped by the cap of "
        f"{spec.max_voxels}); {z_share:.4%} of the in-box points outside z [{lo[2]}, {hi[2]}) m; "
        f"K5 equal to its plain version bit for bit; K7's {len(sum7)} tables "
        f"({len(rec7d.calls)} strided levels) equal to their plain versions in all {total7} "
        f"entries; the encoder's output within {err6:.3e} of its scale; {pairs} active pairs")
    log(f"[sparse lidar time] K5 {ms5:.4f} ms a launch (bound {b5['bound_ms']:.4f} ms by bytes, "
        f"plain {plain_k5:.1f} ms on the CPU); K6 {sum(per6) / len(per6):.4f} ms a launch, "
        f"{sum(per6):.3f} ms a forward (bound {b6['bound_ms']:.4f} ms: "
        f"{b6['bytes'] / 1e6:.1f} MB, {b6['flops'] / 1e9:.2f} GFLOP); K7 {sum(per7):.3f} ms a "
        f"forward (bound {b7['bound_ms']:.4f} ms); the plain encoder {plain_enc:.0f} ms on the "
        f"CPU; peak {peak:.2f} GiB on {card}")
    rows = []
    for name, src, err, ms, plain, b, n_launch in (
            ("voxelize", "voxelize.cu", 0.0, ms5, plain_k5, b5, n5 // ticks),
            ("sparse_conv", "sparse_conv.cu", err6, sum(per6) / len(per6),
             plain_enc / len(per6), b6, n6 // ticks),
            ("rulebook", "sparse_conv.cu", float(bad7), sum(per7) / len(per7), None, b7,
             n7 // ticks)):
        bound = b["bound_ms"] / (n_launch if name != "voxelize" else 1)
        rows.append(dict(name=name, route="cuda", source=f"thinktwice_tpu_torch/csrc/{src}",
                         replaces="none", launches_a_forward=n_launch, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=bound, bound_by="bytes" if name != "sparse_conv"
                         else "bytes or float32 operations", library_ms=None))
    del model, net, net_cpu, vox, rec5, rec_enc, rec6, rec7s, rec7d, calls6, town, states, final
    return rows


def check_student_small(device):
    """The student's closed loop on the card against the CPU (plain K2) on
    the tiny config with random weights: two worlds, five policy calls in
    lockstep on the CPU's states with the same draws. The cameras' classes
    may differ on at most 1e-3 of the pixels (the ray directions' cosines
    round differently on the two devices); the controls agree to
    STUDENT_CTRL_TOL (bfloat16 on both, rounded by other libraries) and the
    brake flags exactly."""
    from thinktwice_tpu_torch.agents.thinktwice_driver import (
        driver_init, make_thinktwice_driver, sample_sensor_draws)
    from thinktwice_tpu_torch.rollout import grid_world
    from thinktwice_tpu_torch.sensors.camera import cameras_from_state
    from thinktwice_tpu_torch.sim.state import tree_map
    from thinktwice_tpu_torch.sim.step import step_world

    cfg = student_tiny_config()
    g = torch.Generator().manual_seed(3)
    town_c, st_c = grid_world(cfg, 2, 6, device="cpu", generator=g)
    town_d = town_c.to(device)
    model_c = tiny_student(cfg, "cpu")
    model_d = tiny_student(cfg, device)
    pol_c, pol_d = make_thinktwice_driver(cfg, model_c), make_thinktwice_driver(cfg, model_d)
    drv_c = driver_init(cfg, 2, 2, hist_len=2, device="cpu")
    drv_d = driver_init(cfg, 2, 2, hist_len=2, device=device)
    worst_ctrl, worst_px = 0.0, 0.0
    for _ in range(5):
        st_d = tree_map(lambda x: x.to(device), st_c)
        draws = sample_sensor_draws(cfg, 2, "cpu", g)
        sem_c = cameras_from_state(cfg.camera, town_c, st_c)["semantic"]
        sem_d = cameras_from_state(cfg.camera, town_d, st_d)["semantic"].cpu()
        worst_px = max(worst_px, float((sem_c != sem_d).float().mean()))
        ctrl_c, drv_c = pol_c(town_c, st_c, drv_c, draws=draws)
        ctrl_d, drv_d = pol_d(town_d, st_d, drv_d, draws=tree_map(lambda x: x.to(device), draws))
        worst_ctrl = max(worst_ctrl, float((ctrl_c - ctrl_d.cpu()).abs().max()))
        if not torch.equal(ctrl_c[:, 2], ctrl_d[:, 2].cpu()):
            raise AssertionError("the student's brake differs on the card")
        st_c, _ = step_world(cfg, town_c, st_c, ctrl_c, generator=g)
    log(f"[student small] 2 worlds x 5 calls, card vs CPU: controls within {worst_ctrl:.2e}, "
        f"{worst_px:.2e} of camera pixels differ in class")
    if worst_ctrl > STUDENT_CTRL_TOL or worst_px > 1e-3:
        raise AssertionError("the student on the card disagrees with the CPU")


def run_student(cfg, model, town, states, n_ticks, g, on_card, hist_len=None):
    """The main path of the student: rollout_thinktwice, with K1 and K2's
    counts set to 0 just before and read just after. -> (final state,
    controls, seconds, K1 launches, K2 launches)."""
    from thinktwice_tpu_torch.agents.thinktwice_driver import HIST_TICKS, rollout_thinktwice
    from thinktwice_tpu_torch.ops.birdview_cuda import K1
    from thinktwice_tpu_torch.ops.raycast_cuda import K2

    K1.launches = K2.launches = 0
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _, controls = rollout_thinktwice(cfg, town, model, states, n_ticks, generator=g,
                                            hist_len=hist_len or HIST_TICKS)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return final, controls, seconds, K1.launches, K2.launches


def check_student_run(final, controls, n_ticks):
    from thinktwice_tpu_torch.sim.state import state_to_arrays

    arrays = state_to_arrays(final)
    _compare_arrays(arrays, arrays)          # raises on a non-finite field
    ctrl = torch.stack(controls)
    if not bool(torch.isfinite(ctrl).all()):
        raise AssertionError("a student control is not finite")
    if not (bool((ctrl[..., 0].abs() <= 1).all()) and bool((ctrl[..., 1] >= 0).all())
            and bool((ctrl[..., 1] <= 1).all())):
        raise AssertionError("a student control is out of range")
    if not np.all(arrays["tick"] == n_ticks):
        raise AssertionError("a world's tick count is wrong")
    log(f"[student] mean speed {float(final.ego.speed.mean()):.2f} m/s, driven "
        f"{float(final.criteria.dist_driven.mean()):.2f} m, mean route completion "
        f"{float(final.criteria.route_completion.mean()):.4f}; mean control "
        f"(steer, throttle, brake) {[round(v, 4) for v in ctrl.mean(dim=(0, 1)).tolist()]}")


def student_breakdown(cfg, model, town, states, g):
    """Where a policy call's and a tick's time goes at this shape: each stage
    timed alone by CUDA events, and the device's busy share over 3 ticks."""
    from thinktwice_tpu_torch.agents.thinktwice import agent_init
    from thinktwice_tpu_torch.agents.thinktwice_driver import (
        controls_from_outputs, driver_init, make_thinktwice_driver, rollout_thinktwice)
    from thinktwice_tpu_torch.sensors.camera import cameras_from_state
    from thinktwice_tpu_torch.sensors.lidar import lidar_from_state
    from thinktwice_tpu_torch.sim.step import step_world

    seen = {}

    def grab(module, args, kwargs):
        seen["args"], seen["kwargs"] = args, kwargs

    hook = model.register_forward_pre_hook(grab, with_kwargs=True)
    policy = make_thinktwice_driver(cfg, model)
    ctrl, _ = policy(town, states, driver_init(cfg, states.n_worlds, model.n_sweeps,
                                               device=states.tick.device), generator=g)
    hook.remove()
    args, kwargs = seen["args"], seen["kwargs"]
    imgs, pts, mask, speed, tp, _, c2e, K, _ = args
    agent = agent_init(states.n_worlds, states.tick.device)
    with torch.no_grad():
        outs = model(*args, **kwargs)
        stages = {
            "cameras": lambda: cameras_from_state(cfg.camera, town, states, generator=g),
            "lidar": lambda: lidar_from_state(cfg.lidar, town, states, generator=g),
            "LSS (2 sweeps)": lambda: model.img_encoder(imgs, c2e, K,
                                                        sweep2key=kwargs["sweep2key"]),
            "LidarNet": lambda: model.lidar_encoder(pts, mask),
            "model forward": lambda: model(*args, **kwargs),
            "control fusion": lambda: controls_from_outputs(outs, agent, speed, tp),
            "step_world": lambda: step_world(cfg, town, states, ctrl, generator=g),
        }
        times = {k: cuda_ms(fn, reps=3, warmup=1) for k, fn in stages.items()}
    times["decoder and fusion convs (forward - LSS - LidarNet)"] = (
        times["model forward"] - times["LSS (2 sweeps)"] - times["LidarNet"])
    log("[student breakdown] ms per call at " f"{states.n_worlds} worlds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(device_busy(lambda: rollout_thinktwice(cfg, town, model, states, 3, generator=g),
                    "3 student ticks"))


def student_phases(args, on_card: bool, device, card: str):
    """K2 against its plain version at the student's shapes, its time, the
    student on the card against the CPU, the student's closed loop with
    the student_rl6 weights (on the CPU: the tiny config with random
    weights), and K3 and K4 at the closed loop's shape. -> (K2's row, K3's
    and K4's rows) of the kernels line (None on the CPU)."""
    from thinktwice_tpu_torch.agents.thinktwice_driver import rollout_thinktwice
    from thinktwice_tpu_torch.config import bench_config
    from thinktwice_tpu_torch.ops.deform_attn import K3
    from thinktwice_tpu_torch.ops.grid_sample import K4
    from thinktwice_tpu_torch.ops.raycast_cuda import K2_TILE, ray_boxes_cuda, ray_boxes_plain
    from thinktwice_tpu_torch.rollout import grid_world
    from thinktwice_tpu_torch.weights import load_student_model

    g = torch.Generator(device=device).manual_seed(43)
    if not on_card:
        cfg = student_tiny_config()
        model = tiny_student(cfg, device)
        town, states = grid_world(cfg, 2, 6, device=device, generator=g)
        look_before = K3.launches + K4.launches
        final, controls, seconds, k1_n, k2_n = run_student(cfg, model, town, states, 4, g,
                                                           False, hist_len=2)
        log(f"[student] 2 worlds x 4 ticks (tiny config, random weights, plain K2, K3 and "
            f"K4) in {seconds:.3f} s; K2 launches {k2_n} (expected 0)")
        if k1_n or k2_n or K3.launches + K4.launches != look_before:
            raise AssertionError("a kernel launched on the CPU")
        check_student_run(final, controls, 4)
        eval_student(cfg, model, device, 2, 6, card, max_steps=4, segment=2)
        return None, None

    cfg = bench_config()
    t0 = time.perf_counter()
    model = load_student_model(args.student_weights, cfg, device=device)
    log(f"[student weights] {os.path.relpath(args.student_weights, REPO)} -> ThinkTwiceModel "
        f"({len(model.img_encoder.lss.backbone.blocks)} backbone blocks, {model.n_sweeps} sweeps, "
        f"{sum(p.numel() for p in model.parameters())} parameters) in "
        f"{time.perf_counter() - t0:.1f} s")
    town, states = grid_world(cfg, STUDENT_WORLDS, N_VEHICLES, device=device, generator=g)

    inputs = k2_inputs(cfg, town, states)
    err = compare_k2(inputs, "at reset")
    calls = [c[1:] for c in inputs]                       # (origins, dirs, table, grid)
    ms = cuda_ms(lambda: [ray_boxes_cuda(*c) for c in calls], reps=10)
    plain_ms = cuda_ms(lambda: [ray_boxes_plain(*c[:3]) for c in calls], reps=2, warmup=1)
    kb = k2_bound(inputs)
    per = [cuda_ms(lambda c=c: ray_boxes_cuda(*c), reps=10) for c in calls]
    flat_ms = cuda_ms(lambda: [ray_boxes_cuda(*c[:3]) for c in calls], reps=10)
    log(f"[k2 time] per policy call (cameras + lidar), {K2_TILE[0]}x{K2_TILE[1]} tiles: "
        f"{ms:.4f} ms (cameras {per[0]:.4f}, lidar {per[1]:.4f}); "
        f"no grid {flat_ms:.4f} ms; plain {plain_ms:.3f} ms; bound {kb['bound_ms']:.4f} ms "
        f"by {kb['bound_by']} (bytes {kb['bytes_ms']:.4f} ms; operations "
        f"{kb['ops_ms']:.4f} ms: {kb['pairs']} ray-box pairs kept by the tile cull "
        f"of {kb['all_pairs']} ({kb['pairs'] / kb['all_pairs']:.2%}) x {K2_FLOP_PER_PAIR} "
        f"+ {kb['tests']} tile-box cull tests x {K2_FLOP_PER_CULL}); all-pairs bound "
        f"{kb['all_pairs_ms']:.4f} ms; library: none (no PyTorch call computes it) on {card}")
    k2_row = dict(name="ray_boxes", route="cuda",
                  source="thinktwice_tpu_torch/csrc/raycast.cu",
                  replaces="thinktwice_tpu/ops/raycast_pallas.py:30",
                  ms=ms, plain_ms=plain_ms, bound_ms=kb["bound_ms"], bound_by=kb["bound_by"],
                  library_ms=None)
    del inputs, calls

    check_student_small(device)

    # the first forward of the full-width model is slow: warm up before timing
    t0 = time.perf_counter()
    rollout_thinktwice(cfg, town, model, states, STUDENT_WARMUP, generator=g)
    torch.cuda.synchronize()
    log(f"[student warm-up] {STUDENT_WORLDS} worlds x {STUDENT_WARMUP} ticks, the model's "
        f"first forward included, in {time.perf_counter() - t0:.3f} s on {card}")

    look_before = K3.launches, K4.launches
    final, controls, seconds, k1_n, k2_n = run_student(cfg, model, town, states,
                                                       STUDENT_TICKS, g, True)
    expected = 2 * STUDENT_TICKS
    k3_n, k4_n = K3.launches - look_before[0], K4.launches - look_before[1]
    refine = cfg.model.refine_num * STUDENT_TICKS
    log(f"[student] {STUDENT_WORLDS} worlds x {STUDENT_TICKS} ticks (policy every tick, "
        f"{model.n_sweeps} sweeps) in {seconds:.3f} s: "
        f"{STUDENT_WORLDS * STUDENT_TICKS / seconds:.1f} env-steps/s on {card}; "
        f"K2 launches {k2_n} (expected {expected}), K3 {k3_n} and K4 {k4_n} (expected "
        f"{refine} each), K1 launches {k1_n}")
    if k2_n != expected or k1_n != 0:
        raise AssertionError(f"K2 launched {k2_n} times, expected {expected}")
    if k3_n != refine or k4_n != refine:
        raise AssertionError(f"K3 and K4 launched {k3_n} and {k4_n} times, expected {refine}")
    check_student_run(final, controls, STUDENT_TICKS)
    k2_row["launches"] = k2_n
    inputs = k2_inputs(cfg, town, final)
    k2_row["max_abs_err"] = max(err, compare_k2(inputs, f"after {STUDENT_TICKS} ticks"))
    del inputs
    student_breakdown(cfg, model, town, final, g)
    eval_student(cfg, model, device, STUDENT_WORLDS, N_VEHICLES, card)
    del model, town, states, final, controls
    torch.cuda.empty_cache()
    return k2_row, look_kernels(args, device, card)


# --------------------------------------------------------------------------
# the student's training


def train_small_config(cfg):
    """A small student (ResNet-10, one refine layer, 64 BEV channels, 16
    depth bins) for the collected batch's cameras and lidar, stepped at lr
    1e-3 from its first step (no warmup): its update of 1e-3 lies far
    above the float32 spacing of the parameters it changes, where the
    first step of the default schedule (1e-7) moves them by a few ulps."""
    from thinktwice_tpu_torch.config import ModelConfig, TrainConfig

    return cfg.replace(
        model=ModelConfig(img_height=cfg.camera.height, img_width=cfg.camera.width,
                          refine_num=1, bev_channels=64, n_depth_bins=16,
                          lidar_pillar_grid=84),
        train=TrainConfig(lr=1e-3, warmup_steps=0))


def slice_batch(batch: dict, n: int) -> dict:
    """The first n examples of a training batch (per-camera maps: their
    first n * 4 rows)."""
    B = batch["imgs"].shape[0]

    def one(x):
        if isinstance(x, tuple):
            return tuple(one(y) for y in x)
        return x[:n] if x.shape[0] == B else x[:n * (x.shape[0] // B)]

    return {k: one(v) for k, v in batch.items()}


def to_device(batch: dict, device) -> dict:
    return {k: tuple(x.to(device) for x in v) if isinstance(v, tuple) else v.to(device)
            for k, v in batch.items()}


def train_step_card_and_cpu(cfg, part, device):
    """One train step of a small two-sweep student from the same weights
    (flax-style init from seed 0, its zero leaves, the biases, then given
    seeded noise of 1e-3 so that every leaf has a scale) on `device` and on
    the CPU, the gradients read through make_train_step's probe; then the
    CPU's optimizer applied to the card's gradients from the same weights.
    -> dict: "terms", each loss term's and grad_norm's difference relative
    to its value; "grad", the whole gradient's difference relative to its
    norm; "cos", each leaf's cosine with the CPU's gradient (1 where both
    are zero, 0 where one is); "update", each leaf's difference to the CPU
    optimizer's result, relative to the leaf's largest change; "moved",
    the largest change; the metrics and seconds on each."""
    from thinktwice_tpu_torch.train import loop
    from thinktwice_tpu_torch.train.crosscheck import leaf_cosine
    from thinktwice_tpu_torch.train.train_step import (
        create_train_state, make_optimizer, make_train_step)

    init = loop.make_model(cfg, backbone_depth=10, n_sweeps=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    loop.init_model_params(cfg, init, gen)
    start = {k: v + 1e-3 * torch.randn(v.shape, generator=gen) if not v.any() else v.clone()
             for k, v in init.state_dict().items()}
    out = {}
    for dev in (torch.device(device), torch.device("cpu")):
        model = loop.make_model(cfg, backbone_depth=10, n_sweeps=2, device=dev)
        model.load_state_dict(start)
        state = create_train_state(cfg, dict(model.named_parameters()))
        grads = {}

        def probe(stage, value, grads=grads):
            if stage == "backward":
                grads.update({k: g.detach().cpu() for k, g in value.items()})

        t0 = time.perf_counter()
        state, metrics = make_train_step(cfg, loop.model_loss_fn(cfg, model), probe)(
            state, to_device(part, dev))
        out[dev.type] = ({k: float(v) for k, v in metrics.items()}, grads,
                         {k: v.detach().cpu() for k, v in state.params.items()},
                         time.perf_counter() - t0)
    (m_d, g_d, p_d, s_d), (m_c, g_c, _, s_c) = out[device.type], out["cpu"]
    ref = {k: start[k].clone() for k in g_d}
    tx = make_optimizer(cfg)
    tx.step(ref, g_d, tx.init(ref))
    return {
        "terms": {k: abs(m_d[k] - m_c[k]) / max(abs(m_c[k]), 1e-12)
                  for k in m_c if not k.startswith("metric_")},
        "grad": float(torch.sqrt(sum(((g_d[k] - g_c[k]) ** 2).sum() for k in g_c))
                      / torch.sqrt(sum((g_c[k] ** 2).sum() for k in g_c))),
        "cos": {k: leaf_cosine(g_d[k], g_c[k]) for k in g_c},
        "update": {k: float((p_d[k] - ref[k]).abs().max())
                   / max(float((ref[k] - start[k]).abs().max()), 1e-30) for k in ref},
        "moved": max(float((ref[k] - start[k]).abs().max()) for k in ref),
        "metrics": (m_d, m_c), "seconds": (s_d, s_c)}


def train_card_vs_cpu(cfg, batch, device):
    """One train step of a small student on TRAIN_CPU_EXAMPLES examples of
    the collected batch, on the card and on the CPU. In float32 compute: the loss terms
    and grad_norm agree to TRAIN_TOL of their value; the gradient (the
    backward) to GRAD_TOL of its norm, and each leaf at a cosine of at
    least GRAD_COS; the card's updated parameters (the optimizer) to
    TRAIN_TOL of each leaf's change with the CPU's optimizer on the card's
    gradients. The gradient cannot be held leaf by leaf to 1e-3: a
    float32 backward of this model moves by some 1e-3 of its norm, and by
    some percent on single early leaves, with the order of its sums alone
    (the CPU's with 1 and with 8 threads differ so on the tiny config;
    the difference persists with cuDNN off and deterministic algorithms
    on). In bfloat16, as the model runs, the
    differences are printed: two bfloat16 runs whose convolutions round in
    other orders (the JAX and the port's agree no closer on the CPU)."""
    from thinktwice_tpu_torch.train.crosscheck import float32_compute

    small = train_small_config(cfg)
    part = slice_batch(batch, TRAIN_CPU_EXAMPLES)
    res = {}
    for name, ctx in (("bfloat16", contextlib.nullcontext()), ("float32", float32_compute())):
        with ctx:
            r = res[name] = train_step_card_and_cpu(small, part, device)
        (m_d, m_c), (s_d, s_c) = r["metrics"], r["seconds"]
        t, c, u = (max(r["terms"], key=r["terms"].get), min(r["cos"], key=r["cos"].get),
                   max(r["update"], key=r["update"].get))
        log(f"[train card vs cpu] {name}: a ResNet-10 two-sweep student, one step on "
            f"{TRAIN_CPU_EXAMPLES} of the collected examples: loss {m_d['loss']:.6f} on {device.type}, {m_c['loss']:.6f} "
            f"on cpu; {len(r['terms'])} values (loss, terms, grad_norm) within "
            f"{r['terms'][t]:.2e} of their value ({t}); the gradient within {r['grad']:.2e} "
            f"of its norm, its {len(r['cos'])} leaves at cosine >= {r['cos'][c]:.6f} ({c}); "
            f"the update within {r['update'][u]:.2e} of each leaf's change by the CPU's "
            f"optimizer on the card's gradients ({u}); grad_norm {m_d['grad_norm']:.6f} vs "
            f"{m_c['grad_norm']:.6f}; largest change {r['moved']:.3e}; {s_d:.2f} s on "
            f"{device.type}, {s_c:.2f} s on cpu")
    r = res["float32"]
    bad = ([f"{k} {v:.2e}" for k, v in r["terms"].items() if v > TRAIN_TOL]
           + ([f"gradient {r['grad']:.2e}"] if r["grad"] > GRAD_TOL else [])
           + [f"{k} cosine {v:.6f}" for k, v in r["cos"].items() if v < GRAD_COS]
           + [f"{k} update {v:.2e}" for k, v in r["update"].items() if v > TRAIN_TOL])
    if bad or not r["moved"] > 0:
        raise AssertionError("the float32 train step on the card disagrees with the CPU: "
                             + "; ".join(bad[:8]))


def train_checkpoint(cfg, model, batch, device, on_card):
    """Archive the trained parameters (flax msgpack), read the archive back
    with weights.load_student_model, and hold the same inputs' forward of
    both models: equal bit for bit (deterministic algorithms on for the
    forwards, so the voxel pooling's scatter sums in one order)."""
    import tempfile

    from thinktwice_tpu_torch.train import checkpoint as ckpt_lib
    from thinktwice_tpu_torch.train import loop
    from thinktwice_tpu_torch.weights import load_student_model

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.msgpack")
        t0 = time.perf_counter()
        ckpt_lib.archive_params(path, model.state_dict())
        size = os.path.getsize(path)
        t_write = time.perf_counter() - t0
        loaded = load_student_model(path, cfg, device=device)
    same_params = all(torch.equal(v, loaded.state_dict()[k])
                      for k, v in model.state_dict().items())
    n_ex = 2 if on_card else 1              # the rehearsal forwards one example
    part = slice_batch(batch, n_ex)

    def leaves(outs):
        return [t for v in outs.values() for t in (v if isinstance(v, tuple) else (v,))]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            fwd = [leaves(loop.model_forward(cfg, m)(part)) for m in (model, model, loaded)]
    finally:
        torch.use_deterministic_algorithms(False)
    repeat = all(torch.equal(a, b) for a, b in zip(fwd[0], fwd[1]))
    same = all(torch.equal(a, b) for a, b in zip(fwd[0], fwd[2]))
    log(f"[train checkpoint] params.msgpack {size} bytes written in {t_write:.2f} s; "
        f"weights.load_student_model: parameters equal {same_params}; the forward (teacher "
        f"pass included) of {n_ex} example(s) equal bit for bit {same} ({len(fwd[0])} outputs; the "
        f"trained model twice: {repeat}) on {'the card' if on_card else 'the cpu'}")
    if not (same_params and same and repeat):
        raise AssertionError("the archived student does not give the trained one's forward")


def train_breakdown(cfg, model, state, batch):
    """Where one train step's time goes: the forward with the teacher pass
    and the losses, the backward, the optimizer, by CUDA events that
    make_train_step's probe records in the step loop.train runs (one step
    after a warm one), and the device's busy share over one step under
    the profiler."""
    from thinktwice_tpu_torch.train import loop
    from thinktwice_tpu_torch.train.train_step import make_train_step

    ev = {}

    def probe(stage, _):
        ev[stage] = torch.cuda.Event(enable_timing=True)
        ev[stage].record()

    step = make_train_step(cfg, loop.model_loss_fn(cfg, model), probe)
    for _ in range(2):
        torch.cuda.synchronize()
        probe("start", None)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    stages = ("start", "forward", "backward", "optimizer")
    ms = [ev[a].elapsed_time(ev[b]) for a, b in zip(stages, stages[1:])]
    log(f"[train breakdown] one step of {batch['imgs'].shape[0]} examples: forward with the "
        f"teacher pass and the losses {ms[0]:.1f} ms, backward {ms[1]:.1f} ms, optimizer "
        f"{ms[2]:.1f} ms")
    log(device_busy(lambda: step(state, batch), "one train step", "[train breakdown]"))


def train_phases(args, on_card: bool, device, card: str, n_vehicles: int) -> dict:
    """The student's training path: collection in the loop (K1 and K2 on the
    card, counted, and held against their plain versions on a collected
    frame's inputs), loop.train for TRAIN_STEPS steps of student_rl6 (on the
    CPU: the tiny student with random weights), the card against the CPU,
    the archive. -> the training path's K1 and K2 launches and errors."""
    import io
    import itertools

    from thinktwice_tpu_torch.config import bench_config
    from thinktwice_tpu_torch.ops.birdview_cuda import K1
    from thinktwice_tpu_torch.ops.raycast_cuda import K2
    from thinktwice_tpu_torch.rollout import grid_routes
    from thinktwice_tpu_torch.maps.procedural import make_grid_town
    from thinktwice_tpu_torch.sensors import birdview as birdview_mod
    from thinktwice_tpu_torch.train import loop
    from thinktwice_tpu_torch.train.train_step import make_optimizer
    from thinktwice_tpu_torch.weights import load_roach_policy, load_student_model

    if on_card:
        cfg = bench_config()
        model = load_student_model(args.student_weights, cfg, device=device)
    else:
        cfg = student_tiny_config()
        model = tiny_student(cfg, device)
    policy = load_roach_policy(WEIGHTS, cfg, device=device)
    town = make_grid_town(n_blocks=2, block=100.0, device=device)
    routes = torch.as_tensor(grid_routes(1, cfg.sim.max_route_len), device=device)
    g = torch.Generator(device=device).manual_seed(44)
    frames = TRAIN_FRAMES_SMALL if args.small else TRAIN_FRAMES
    stream = loop.collect_stream(cfg, policy, town, routes, g, frames_per_chunk=frames,
                                 n_vehicles=n_vehicles, n_sweeps=model.n_sweeps, n_worlds=1)

    # ---- collection, the training path's first stage ----
    K1.launches = K2.launches = 0
    with Spy(birdview_mod, "birdview_bits", keep=1) as k1_rec, K2Inputs(keep=2) as k2_rec, \
            Spy(loop, "collect_batch", keep=1) as chunk:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch0 = next(stream)
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    k1_n, k2_n = K1.launches, K2.launches
    final = chunk.results[0][0]
    n_ex = batch0["imgs"].shape[0]
    exp_k1, exp_k2 = (frames * 6, frames * 2) if on_card else (0, 0)
    log(f"[train collect] 1 world, {n_vehicles} vehicles, {frames} frames of 10 ticks "
        f"(expert every 2 ticks and at each frame, 4 cameras of {cfg.camera.height} x "
        f"{cfg.camera.width}, lidar {cfg.lidar.n_beams} x {cfg.lidar.n_azimuth}) -> "
        f"{n_ex} examples of {model.n_sweeps} sweeps in {seconds:.3f} s: "
        f"{frames * 10 / seconds:.1f} env-steps/s on {card}; K1 launches {k1_n} "
        f"(expected {exp_k1}), K2 launches {k2_n} (expected {exp_k2}); route completion "
        f"{float(final.criteria.route_completion[0]):.4f}, speed "
        f"{float(final.ego.speed[0]):.2f} m/s")
    if (k1_n, k2_n) != (exp_k1, exp_k2):
        raise AssertionError(f"the collection launched K1 {k1_n} and K2 {k2_n} times")
    if n_ex != frames - cfg.model.pred_len - (model.n_sweeps - 1):
        raise AssertionError(f"the chunk gave {n_ex} examples")
    for k, v in batch0.items():
        for x in (v if isinstance(v, tuple) else (v,)):
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                raise AssertionError(f"the collected {k} is not finite")

    rows = {}
    if on_card:
        from thinktwice_tpu_torch.ops.birdview_cuda import birdview_bits_cuda, birdview_bits_plain

        prims, ego = k1_rec.calls[-1][1:3]
        bits_k = birdview_bits_cuda(cfg.birdview, prims, ego)
        bits_p = birdview_bits_plain(cfg.birdview, prims, ego)
        torch.cuda.synchronize()
        mism = int((bits_k != bits_p).sum())
        log(f"[k1 vs plain, training path] the collection's last policy call, "
            f"{tuple(prims.shape)} prims: {mism} of {bits_k.numel()} pixels differ")
        if mism or int((bits_p != 0).sum()) == 0:
            raise AssertionError("K1 differs from its plain version on the training path")
        inputs = [(name, *call) for name, call in zip(("cameras", "lidar"), k2_rec.calls)]
        err = compare_k2(inputs, "training path, the last collected frame")
        rows = dict(k1_err=0.0, k2_err=err)
        del inputs, prims, ego, bits_k, bits_p

    # ---- loop.train, the training path's main stage ----
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    K1.launches = K2.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        state = loop.train(cfg, model, itertools.chain([batch0], stream), TRAIN_STEPS,
                           params=model.state_dict(), log_every=1)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    rows.update(k1_train=k1_n + K1.launches, k2_train=k2_n + K2.launches)
    tx = make_optimizer(cfg)
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    if len(lines) != TRAIN_STEPS:
        raise AssertionError(f"loop.train logged {len(lines)} steps")
    for rec in lines:
        terms = {k: v for k, v in rec.items()
                 if k not in ("step", "wall_s", "collect_s", "grad_s")}
        if not all(np.isfinite(v) for v in terms.values()):
            raise AssertionError(f"step {rec['step']}: a loss or the gradient is not finite")
        log(f"[train step] {rec['step']}: lr {tx.schedule(rec['step'] - 1):.3e}, loss "
            f"{rec['loss']:.5f}, grad_norm {rec['grad_norm']:.5f}, collect_s {rec['collect_s']}, "
            f"grad_s {rec['grad_s']}; terms "
            + ", ".join(f"{k} {v}" for k, v in terms.items() if k not in ("loss", "grad_norm")))
    changed = sum(int(not torch.equal(v, model.state_dict()[k])) for k, v in before.items())
    log(f"[train step] student {'student_rl6' if on_card else 'tiny (random weights)'} "
        f"({sum(p.numel() for p in model.parameters())} parameters), batch {n_ex}, "
        f"{TRAIN_STEPS} steps in {wall:.2f} s on {card} "
        f"({TRAIN_STEPS * n_ex / lines[-1]['grad_s']:.2f} examples/s of the steps, "
        f"{TRAIN_STEPS * n_ex / wall:.2f} with the collection); K1 launches {K1.launches}, "
        f"K2 launches {K2.launches} (2 more chunks); peak memory {peak:.2f} GiB; "
        f"{changed} of {len(before)} parameter tensors changed")
    if state.step != TRAIN_STEPS or changed == 0:
        raise AssertionError("the train steps did not update the parameters")
    chunks = TRAIN_STEPS - 1
    if (K1.launches, K2.launches) != (chunks * exp_k1, chunks * exp_k2):
        raise AssertionError(f"loop.train's collection launched K1 {K1.launches} and K2 "
                             f"{K2.launches} times")
    del before

    if on_card:
        train_card_vs_cpu(cfg, batch0, device)
    else:
        log("[train card vs cpu] no card: skipped on the CPU rehearsal")
    train_checkpoint(cfg, model, batch0, device, on_card)
    if on_card:
        train_breakdown(cfg, model, state, batch0)
    del state
    ddp_step(cfg, model, batch0, device, card, on_card)
    return rows


def ddp_step(cfg, model, batch, device, card, on_card):
    """[ddp step]: one data-parallel train step of the trained student on
    the collected batch (on the CPU rehearsal its first 2 examples; the
    first example mirrored, so distil_weight is 0 on rank 0 only) over
    DDP_RANKS gloo ranks sharing the card, against the
    one-process step on the same global batch and weights, both in float32
    compute at lr 1e-3 from the first step (train_small_config's reason).
    crosscheck.step_agreement holds it with the tolerances of [train card
    vs cpu]: the loss terms and grad_norm to TRAIN_TOL of their value, the
    reduced gradient to GRAD_TOL of the one-process gradient's norm with
    every leaf at a cosine of at least GRAD_COS, and the ranks' parameters
    to TRAIN_TOL of each leaf's change by the one-process optimizer applied
    to the reduced gradient (the difference to the one-process step's own
    change is printed); both ranks hold the same parameters. Per rank: a
    second step's ms, its all-reduce's ms, peak memory."""
    import functools
    import tempfile

    from thinktwice_tpu_torch.config import TrainConfig
    from thinktwice_tpu_torch.parallel import ranks
    from thinktwice_tpu_torch.parallel.launch import spawn
    from thinktwice_tpu_torch.train import loop
    from thinktwice_tpu_torch.train.augment import maybe_mirror
    from thinktwice_tpu_torch.train.crosscheck import step_agreement

    step_cfg = cfg.replace(train=TrainConfig(lr=1e-3, warmup_steps=0))
    if not on_card:
        batch = slice_batch(batch, DDP_RANKS)
    B = batch["imgs"].shape[0]
    batch = maybe_mirror(batch, do=torch.arange(B, device=batch["imgs"].device) == 0)
    depth = 50 if on_card else 10
    make_model = functools.partial(loop.make_model, step_cfg, depth, model.n_sweeps)
    make_loss = functools.partial(loop.model_loss_fn, step_cfg)
    start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    on = "cuda:0" if on_card else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ddp_step.pt")
        torch.save({"state_dict": start, "batch": to_device(batch, "cpu")}, path)
        if on_card:
            torch.cuda.empty_cache()
        timed = 1 if on_card else 0            # the rehearsal times no second step
        one = ranks.train_step_rank(None, step_cfg, make_model, make_loss, path, float32=True,
                                    timed=timed, device=device)
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = spawn(ranks.train_step_rank, DDP_RANKS,
                    args=(step_cfg, make_model, make_loss, path, True, timed),
                    devices=[on] * DDP_RANKS, backend="gloo", timeout=DDP_TIMEOUT)
        wall = time.perf_counter() - t0
    nan = float("nan")
    a = step_agreement(out, one, start, step_cfg, TRAIN_TOL, GRAD_TOL, GRAD_COS, TRAIN_TOL)
    m, ref = out[0]["metrics"], one["metrics"]
    terms, cos, update = a["terms"], a["cos"], a["update"]
    t, c, u = (max(terms, key=terms.get), min(cos, key=cos.get), max(update, key=update.get))
    per_rank = "; ".join(
        f"rank {r}: {o['ms'] or nan:.1f} ms a step, all-reduce {o['reduce_ms'] or nan:.1f} ms, "
        f"first step {o['first_s']:.2f} s, peak {o['peak_gib'] or nan:.2f} GiB"
        for r, o in enumerate(out))
    log(f"[ddp step] student {'student_rl6' if on_card else 'tiny'} in float32, global batch "
        f"{B} ({B // DDP_RANKS} a rank, example 0 mirrored: distil_weight 0 on rank 0 only), "
        f"{DDP_RANKS} gloo ranks on {on} against one process: loss {m['loss']:.6f} vs "
        f"{ref['loss']:.6f}; {len(terms)} values within {terms[t]:.2e} of their value ({t}); "
        f"the gradient within {a['grad']:.2e} of its norm, its {len(cos)} leaves at cosine >= "
        f"{cos[c]:.6f} ({c}); the update within {update[u]:.2e} of each leaf's change by the "
        f"one-process optimizer on the reduced gradient ({u}); against the one-process step's own "
        f"change: {a['direct']:.2e} of a leaf's largest, {a['direct_all']:.2e} of the whole "
        f"change's norm; ranks equal {a['same']}; {per_rank}; one process {one['ms'] or nan:.1f} ms a "
        f"step, peak {one['peak_gib'] or float('nan'):.2f} GiB; {wall:.1f} s wall with the "
        f"ranks' start on {card}")
    if a["bad"]:
        raise AssertionError("the data-parallel step disagrees with the one-process step: "
                             + "; ".join(a["bad"][:8]))


# --------------------------------------------------------------------------
# the Roach expert's training: PPO with the BC anchor, behavior cloning


def expert_recipes(small: bool):
    """(cfg, PPOConfig, BCConfig, PPO routes, BC routes): the fine-tune recipe
    of scripts/finetune_roach_town05.py and the BC recipe of
    scripts/train_bc_town05.py on the grid town at full width, or tiny
    shapes for the CPU rehearsal."""
    from thinktwice_tpu_torch.scripts.train_roach_ppo import build_routes, grid_config
    from thinktwice_tpu_torch.train.bc import BCConfig
    from thinktwice_tpu_torch.train.ppo import PPOConfig

    if small:
        pc = PPOConfig(n_envs=2, n_steps=4, n_epochs=1, minibatch=8, lr=3e-5, n_vehicles=2,
                       policy_every=2, anchor_coef=0.05)
        bcc = BCConfig(n_envs=2, n_steps=8, minibatch=8, n_epochs=1, n_vehicles=2,
                       perturb_prob=0.05, eval_envs=2, eval_steps=8)
        return grid_config(2), grid_config(2), pc, bcc, build_routes(2), build_routes(4)
    pc = PPOConfig(n_envs=PPO_ENVS, n_steps=PPO_STEPS, n_epochs=4, minibatch=512, lr=3e-5,
                   n_vehicles=48, policy_every=2, anchor_coef=0.05)
    bcc = BCConfig(n_envs=24, n_steps=256, n_vehicles=96, perturb_prob=0.05,
                   eval_steps=BC_PROBE_TICKS)
    return (grid_config(48), grid_config(96), pc, bcc, build_routes(PPO_ENVS),
            build_routes(BC_ROUTES))


def expert_card_vs_cpu(kind: str, device) -> None:
    """crosscheck's small PPO (roach_bc5 anchored to roach_rl6) or BC
    (roach_bc5, then its probe) iterate on the card against the CPU in
    float32 (TF32 off), held to crosscheck's tolerances."""
    from thinktwice_tpu_torch.train import crosscheck
    from thinktwice_tpu_torch.weights import load_roach_policy

    cfg = small_config()
    start = load_roach_policy(BC5_WEIGHTS, cfg, device="cpu").state_dict()
    anchor = load_roach_policy(WEIGHTS, cfg, device="cpu").state_dict()
    runs = {dev: crosscheck.small_iterate(kind, cfg, dev, start, anchor)
            for dev in (device, torch.device("cpu"))}
    d, c = runs[device], runs[torch.device("cpu")]
    r = crosscheck.compare(d, c)
    sp, sb = crosscheck.SMALL_PPO, crosscheck.SMALL_BC
    what = (f"PPO, {sp.n_envs} worlds x {sp.n_steps} macro steps, policy every "
            f"{sp.policy_every}, roach_bc5 with the roach_rl6 anchor" if kind == "ppo" else
            f"BC, {sb.n_envs} worlds x {sb.n_steps} ticks, perturbation {sb.perturb_prob} and "
            f"DAgger mix {crosscheck.DAGGER_MIX}, and its probe")
    log(f"[{kind} card vs cpu] {what}, float32: dones equal {r['dones_equal']} "
        f"({int(c.done.sum())}); {r['n_metrics']} metrics within {r['metric_err']:.2e} "
        f"({r['worst']}: {d.metrics[r['worst']]:.6f} vs {c.metrics[r['worst']]:.6f}); the first "
        f"minibatch's gradient within {r['grad_err']:.2e} of its norm, its {r['n_leaves']} "
        f"leaves at cosine >= {r['cos']:.6f} ({r['leaf']}); K1 launches {d.launches} on "
        f"{device.type}, {c.launches} on cpu; {d.seconds:.2f} s on {device.type}, "
        f"{c.seconds:.2f} s on cpu")
    if not r["ok"]:
        raise AssertionError(f"the {kind} iterate on the card disagrees with the CPU")


def k1_frame_vs_plain(cfg, rec, tag: str) -> float:
    """K1 against its plain version on the last primitive table a Spy of
    birdview_bits recorded: 0 pixels may differ, and the frame must not be
    empty. -> the decoded channels' max abs error."""
    from thinktwice_tpu_torch.ops.birdview_cuda import (
        birdview_bits_cuda,
        birdview_bits_plain,
        decode_bits,
    )

    _, prims, ego = rec.calls[-1][:3]
    bits_k = birdview_bits_cuda(cfg, prims, ego)
    bits_p = birdview_bits_plain(cfg, prims, ego)
    torch.cuda.synchronize()
    mism = int((bits_k != bits_p).sum())
    err = float((decode_bits(cfg, bits_k) - decode_bits(cfg, bits_p)).abs().max())
    log(f"[k1 vs plain, expert training path] {tag}, {tuple(prims.shape)} prims: "
        f"{mism} of {bits_k.numel()} pixels differ, max abs err {err}")
    if mism or int((bits_p != 0).sum()) == 0:
        raise AssertionError(f"K1 differs from its plain version on {tag} (or it is empty)")
    return err


def expert_breakdown(cfg, pc, policy, anchor, town, routes, states, draws, peak_gib):
    """Where a PPO macro step's time goes at the recipe's width, each stage
    timed alone by CUDA events: the birdview (K1 with its inputs and the
    decode), the policy and the anchor, one step_world, the hazard speed
    and the reward of one tick, the reset of two worlds; one minibatch's
    update (forward, backward, Adam); and the device's busy share over an
    iterate of 8 macro steps under the profiler; with the PPO iterates'
    peak memory."""
    from thinktwice_tpu_torch.agents.expert import state_vector
    from thinktwice_tpu_torch.sensors.birdview import birdview_from_state
    from thinktwice_tpu_torch.sim.step import step_world
    from thinktwice_tpu_torch.train.ppo import (
        WorldBank, compute_reward, hazard_desired_speed, make_ppo)
    from thinktwice_tpu_torch.train.train_step import Adam

    W = states.n_worlds
    ctrl = torch.tensor([[0.0, 0.5, 0.0]], device=town.device).expand(W, 3).contiguous()
    bv = birdview_from_state(cfg.birdview, town, states)
    sv = state_vector(states)
    new, ev = step_world(cfg, town, states, ctrl, draws=draws.step(states))
    bank = WorldBank(cfg, town, routes, pc.n_vehicles)
    done = torch.zeros((W,), dtype=torch.bool, device=town.device)
    done[:2] = True

    def reward():
        return compute_reward(states, new, ev, hazard_desired_speed(cfg, town, states))

    with torch.no_grad():
        stages = {
            "birdview": lambda: birdview_from_state(cfg.birdview, town, states),
            "policy+anchor": lambda: (policy(bv, sv), anchor(bv, sv)),
            "step_world": lambda: step_world(cfg, town, states, ctrl, draws=draws.step(states)),
            "hazard+reward": reward,
            "reset 2 worlds": lambda: bank.reset_done(states, done, draws),
        }
        times = {k: cuda_ms(fn, reps=10) for k, fn in stages.items()}
    per_macro = (times["birdview"] + times["policy+anchor"] + times["reset 2 worlds"]
                 + pc.policy_every * (times["step_world"] + times["hazard+reward"]))
    # one minibatch of the update: the loss, its gradient and Adam's step
    short = dataclasses.replace(pc, n_steps=8, n_epochs=1)
    _, it = make_ppo(cfg, short, town, routes, anchor=anchor)
    n = pc.minibatch
    g = torch.Generator(device=town.device).manual_seed(0)
    flat = {"bv_u8": (bv[torch.arange(n, device=town.device) % W] * 255).to(torch.uint8),
            "sv": sv[torch.arange(n, device=town.device) % W],
            "action": torch.rand((n, 2), generator=g, device=town.device) * 2 - 1,
            "logp": torch.zeros(n, device=town.device),
            "anchor_alpha": torch.full((n, 2), 2.0, device=town.device),
            "anchor_beta": torch.full((n, 2), 2.0, device=town.device),
            "adv": torch.randn(n, generator=g, device=town.device),
            "ret": torch.randn(n, generator=g, device=town.device)}
    tx = Adam(pc.lr, 0.5, eps=1e-5)
    opt = tx.init(dict(policy.named_parameters()))
    before = {k: v.detach().clone() for k, v in policy.state_dict().items()}
    upd_ms = cuda_ms(lambda: it.update_fn(policy, opt, flat, draws), reps=3, warmup=1)
    policy.load_state_dict(before)
    log(f"[expert train breakdown] ms per call at {W} worlds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; a macro step of {pc.policy_every} ticks ~{per_macro:.1f} ms; update "
        f"{upd_ms:.1f} ms a minibatch of {n}; peak memory of the PPO iterates {peak_gib:.2f} GiB")
    log(device_busy(lambda: it(policy, opt, states, draws), "one PPO iterate of 8 macro "
                    "steps and one minibatch", "[expert train breakdown]"))
    policy.load_state_dict(before)


def expert_train_phases(args, on_card: bool, device, card: str) -> dict:
    """The Roach expert's training path: PPO at the fine-tune recipe (from
    roach_bc5, anchored to it) for PPO_ITERS iterations, K1 against its
    plain version on the last frame of its rollout, the card against the
    CPU, the breakdown; then BC at its recipe for one iteration and the
    held-out probe, K1 against its plain version on the last frame of each,
    and the card against the CPU. -> {"ppo": K1's launches in PPO, "bc":
    in BC's iterate and probe, "err" (on the card): the largest decoded
    error of those frames}."""
    from thinktwice_tpu_torch.maps.procedural import make_grid_town
    from thinktwice_tpu_torch.ops.birdview_cuda import K1
    from thinktwice_tpu_torch.sensors import birdview as birdview_mod
    from thinktwice_tpu_torch.train.bc import make_bc
    from thinktwice_tpu_torch.train.draws import GeneratorTrainDraws
    from thinktwice_tpu_torch.train.ppo import make_ppo
    from thinktwice_tpu_torch.weights import load_roach_policy

    ppo_cfg, bc_cfg, pc, bcc, ppo_routes, bc_routes = expert_recipes(args.small)
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # ---- PPO: the fine-tune recipe ----
    town = make_grid_town(2, 100.0, device=device)
    policy = load_roach_policy(BC5_WEIGHTS, ppo_cfg, device=device)
    anchor = load_roach_policy(BC5_WEIGHTS, ppo_cfg, device=device).requires_grad_(False)
    init_fn, iterate = make_ppo(ppo_cfg, pc, town, ppo_routes, anchor=anchor)
    draws = GeneratorTrainDraws(town, 9)
    _, opt, env = init_fn(draws)
    before = {k: v.detach().clone() for k, v in policy.state_dict().items()}
    marks = {}

    def probe(stage, _):
        if stage == "rollout":
            sync()
            marks["rollout"] = time.perf_counter()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K1.launches = 0
    ticks = pc.n_envs * pc.n_steps * pc.policy_every
    with Spy(birdview_mod, "birdview_bits", keep=1) as k1_rec:
        for i in range(PPO_ITERS if not args.small else 1):
            sync()
            t0 = time.perf_counter()
            policy, opt, env, m = iterate(policy, opt, env, draws, probe=probe)
            sync()
            t1 = time.perf_counter()
            roll_s, upd_s = marks["rollout"] - t0, t1 - marks["rollout"]
            vals = {k: float(v) for k, v in m.items()}
            log(f"[ppo iterate] {i}: {pc.n_envs} worlds x {pc.n_steps} macro steps of "
                f"{pc.policy_every} ticks, {pc.n_vehicles} vehicles, roach_bc5 with its anchor "
                f"{pc.anchor_coef}: rollout {roll_s:.2f} s ({ticks / roll_s:.1f} env-steps/s), "
                f"update {upd_s:.2f} s ({pc.n_epochs} epochs of "
                f"{max(pc.n_envs * pc.n_steps // pc.minibatch, 1)} minibatches of "
                f"{pc.minibatch}) on {card}; "
                + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
            if not all(np.isfinite(v) for v in vals.values()) or "anchor_kl" not in vals:
                raise AssertionError("a PPO metric is not finite, or anchor_kl is missing")
    ppo_k1 = K1.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    n_it = PPO_ITERS if not args.small else 1
    expected = n_it * (pc.n_steps + 1) if on_card else 0
    changed = sum(int(not torch.equal(v, policy.state_dict()[k])) for k, v in before.items())
    log(f"[ppo iterate] K1 launches {ppo_k1} (expected {expected}: {pc.n_steps} macro steps "
        f"and the bootstrap an iterate); {changed} of {len(before)} parameter tensors changed; "
        f"peak memory {peak:.2f} GiB")
    if ppo_k1 != expected or changed == 0:
        raise AssertionError(f"PPO launched K1 {ppo_k1} times and changed {changed} tensors")
    rows = {"ppo": ppo_k1}
    if on_card:
        rows["err"] = k1_frame_vs_plain(ppo_cfg.birdview, k1_rec, "the PPO rollout's last frame")
        expert_card_vs_cpu("ppo", device)
        expert_breakdown(ppo_cfg, pc, policy, anchor, town, torch.as_tensor(ppo_routes),
                         env, draws, peak)
    else:
        log("[ppo card vs cpu] no card: skipped on the CPU rehearsal")
    del policy, anchor, opt, env, iterate, init_fn, k1_rec
    if on_card:
        torch.cuda.empty_cache()

    # ---- BC: the autopilot's clone, one iteration and the probe ----
    init_fn, iterate = make_bc(bc_cfg, bcc, town, bc_routes)
    draws = GeneratorTrainDraws(town, 10)
    policy, opt, env = init_fn(draws)
    K1.launches = 0
    sync()
    t0 = time.perf_counter()
    with Spy(birdview_mod, "birdview_bits", keep=1) as bc_rec:
        policy, opt, env, m = iterate(policy, opt, env, draws, probe=probe)
    sync()
    t1 = time.perf_counter()
    bc_it_k1 = K1.launches
    vals = {k: float(v) for k, v in m.items()}
    frames = bcc.n_envs * bcc.n_steps
    log(f"[bc iterate] {bcc.n_envs} worlds x {bcc.n_steps} ticks, {bcc.n_vehicles} vehicles, "
        f"perturbation {bcc.perturb_prob}: rollout {marks['rollout'] - t0:.2f} s "
        f"({frames / (marks['rollout'] - t0):.1f} env-steps/s), update "
        f"{t1 - marks['rollout']:.2f} s on {card}; K1 launches {bc_it_k1}; "
        + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
    K1.launches = 0
    sync()
    t0 = time.perf_counter()
    with Spy(birdview_mod, "birdview_bits", keep=1) as probe_rec:
        ev = {k: float(v) for k, v in iterate.eval_fn(policy, draws).items()}
    sync()
    probe_s = time.perf_counter() - t0
    bc_probe_k1 = K1.launches
    exp_it, exp_probe = ((bcc.n_steps // 2, bcc.eval_steps // 2) if on_card else (0, 0))
    log(f"[bc probe] {bcc.eval_envs} held-out routes x {bcc.eval_steps} ticks in {probe_s:.2f} s "
        f"on {card}: " + ", ".join(f"{k} {v:.5f}" for k, v in ev.items())
        + f"; K1 launches {bc_probe_k1} (expected {exp_probe}; the iterate {bc_it_k1}, "
        f"expected {exp_it})")
    if not all(np.isfinite(v) for v in {**vals, **ev}.values()):
        raise AssertionError("a BC metric is not finite")
    if (bc_it_k1, bc_probe_k1) != (exp_it, exp_probe):
        raise AssertionError(f"BC launched K1 {bc_it_k1} + {bc_probe_k1} times")
    rows["bc"] = bc_it_k1 + bc_probe_k1
    del policy, opt, env
    if on_card:
        rows["err"] = max(rows["err"],
                          k1_frame_vs_plain(bc_cfg.birdview, bc_rec, "the BC rollout's last frame"),
                          k1_frame_vs_plain(bc_cfg.birdview, probe_rec, "the BC probe's last frame"))
        del bc_rec, probe_rec
        expert_card_vs_cpu("bc", device)
    else:
        log("[bc card vs cpu] no card: skipped on the CPU rehearsal")
    return rows


# --------------------------------------------------------------------------
# several processes: the data-parallel dry run, the sharded Roach rollout


def ddp_dryrun(on_card: bool, card: str) -> None:
    """[ddp dryrun]: dryrun_multigpu(1) with NCCL on the card at the frozen
    and the mid shapes (on the CPU rehearsal: 2 gloo ranks, frozen)."""
    from thinktwice_tpu_torch.dryrun import _DRYRUN_FROZEN, _DRYRUN_MID, dryrun_multigpu

    runs = (("frozen", _DRYRUN_FROZEN), ("mid", _DRYRUN_MID)) if on_card else (
        ("frozen", _DRYRUN_FROZEN),)
    for name, fz in runs:
        t0 = time.perf_counter()
        if on_card:
            res = dryrun_multigpu(1, fz, timeout=DDP_TIMEOUT)
        else:
            res = dryrun_multigpu(DDP_RANKS, fz, device="cpu", timeout=DDP_TIMEOUT)
        wall = time.perf_counter() - t0
        r0 = res[0]
        log(f"[ddp dryrun] {name} shapes (ResNet-{fz['backbone']}, {fz['n_cams']} cameras of "
            f"{fz['img_height']} x {fz['img_width']}, {fz['refine_num']} refine layers, one "
            f"example a rank): {len(res)} rank(s), {'nccl' if on_card else 'gloo'}: loss "
            f"{r0['loss']:.4f}; rank 0 built and replicated in {r0['init_s']:.2f} s, its "
            f"first step {r0['step_s']:.2f} s, peak {r0['peak_gib'] or float('nan'):.2f} GiB; "
            f"{wall:.1f} s wall with the process's start on {card}")
        if not all(np.isfinite(r["loss"]) for r in res):
            raise AssertionError(f"the {name} dry run's loss is not finite")


def worlds_sharded(cfg, device, card: str, on_card: bool, n_worlds: int, n_vehicles: int,
                   n_ticks: int) -> list[int]:
    """[worlds sharded]: the Roach rollout of n_worlds worlds for n_ticks
    ticks split over DDP_RANKS gloo ranks sharing the card, against the
    one-process run of all of them with the same resets and global draws:
    each rank's K1 masks of the first tick equal the one-process rows bit
    for bit, its first controls agree to SHARDED_CTRL_TOL, and its last
    frame's K1 masks equal the plain version's (0 pixels off, some set);
    K1 runs n_ticks / 2 times on each rank and K2 none. The summary over
    the ranks holds the one-process summary's counts, and its mean
    completion to SHARDED_COMPLETION_TOL: on the card the policy CNN's
    cuDNN algorithms may change with the batch, so the trajectories are
    held through what the evaluation reads, not bit for bit. -> each
    rank's K1 launches and its K2 launches."""
    from thinktwice_tpu_torch.parallel import ranks
    from thinktwice_tpu_torch.parallel.launch import spawn

    args = (cfg, WEIGHTS, n_worlds, n_vehicles, n_ticks, SHARDED_SEED)
    one = ranks.roach_rollout_rank(None, *args, device=device)
    on = "cuda:0" if on_card else "cpu"
    t0 = time.perf_counter()
    out = spawn(ranks.roach_rollout_rank, DDP_RANKS, args=args, devices=[on] * DDP_RANKS,
                backend="gloo", timeout=DDP_TIMEOUT)
    wall = time.perf_counter() - t0
    n_local = n_worlds // DDP_RANKS
    bad = []
    for r, o in enumerate(out):
        rows = slice(r * n_local, (r + 1) * n_local)
        same = torch.equal(o["bits0"], one["bits0"][rows])
        ctrl = float((o["ctrl0"] - one["ctrl0"][rows]).abs().max())
        expected = n_ticks // 2 if on_card else 0
        log(f"[worlds sharded] rank {r}: worlds {rows.start}-{rows.stop - 1}, first tick's K1 "
            f"masks equal to the one-process rows {same} ({int((o['bits0'] != 0).sum())} of "
            f"{o['bits0'].numel()} pixels set), first controls within {ctrl:.2e}; last frame "
            f"{o['last_off']} of {o['pixels']} pixels off the plain version "
            f"({o['last_nonzero']} set); {n_ticks} ticks in {o['seconds']:.3f} s "
            f"({n_local * n_ticks / o['seconds']:.1f} env-steps/s), K1 launches "
            f"{o['launches']} (expected {expected}), K2 launches {o['k2_launches']} "
            f"(expected 0), peak "
            f"{o['peak_gib'] or float('nan'):.2f} GiB; its worlds {o['local']}")
        bad += ([f"rank {r} first masks"] if not same or not int((o["bits0"] != 0).sum()) else [])
        bad += [f"rank {r} controls {ctrl:.2e}"] if ctrl > SHARDED_CTRL_TOL else []
        bad += ([f"rank {r} last frame"] if o["last_off"] or not o["last_nonzero"] else [])
        bad += [f"rank {r} K1 {o['launches']}"] if o["launches"] != expected else []
        bad += [f"rank {r} K2 {o['k2_launches']}"] if o["k2_launches"] else []
    log(f"[worlds sharded] {n_worlds} worlds x {n_ticks} ticks, {n_vehicles} vehicles: summary "
        f"over the {DDP_RANKS} ranks {out[0]['summary']}; one process {one['summary']} in "
        f"{one['seconds']:.3f} s ({n_worlds * n_ticks / one['seconds']:.1f} env-steps/s, K1 "
        f"launches {one['launches']}); {wall:.1f} s wall with the ranks' start on {card}")
    summary, ref = out[0]["summary"], one["summary"]
    counts = [k for k in ref if k != "mean_completion" and summary[k] != ref[k]]
    completion = abs(summary["mean_completion"] - ref["mean_completion"])
    log(f"[worlds sharded] the sharded summary against the one-process: counts differ in "
        f"{counts or 'none'}, mean completion within {completion:.2e} (tolerance "
        f"{SHARDED_COMPLETION_TOL:g})")
    bad += [f"summary {k} {summary[k]} vs {ref[k]}" for k in counts]
    if not completion <= SHARDED_COMPLETION_TOL:
        bad.append(f"mean completion {summary['mean_completion']} vs {ref['mean_completion']}")
    if bad:
        raise AssertionError("the sharded rollout disagrees: " + "; ".join(bad))
    return [o["launches"] for o in out], [o["k2_launches"] for o in out]


# --------------------------------------------------------------------------
# imported towns and the reference-format dataset


def grid_lane_loops(town) -> list:
    """The grid town's lane loops, each followed along lane_next from its
    first waypoint -> [(K, 2) float32]: the bank of polylines that covers
    every road of the town."""
    pts = town.lane_pts.cpu().numpy()
    nxt = town.lane_next.cpu().numpy()
    seen = ~town.lane_valid.cpu().numpy()
    loops = []
    for i in range(len(pts)):
        path = []
        while not seen[i]:
            seen[i] = True
            path.append(i)
            i = int(nxt[i])
        if len(path) > 1:
            loops.append(pts[path])
    return loops


def keypoint_spec(route, name: str):
    """A lane-graph route or lane loop (K, >= 2) -> the RouteSpec of a point
    every ~KEYPOINT_M metres and its last, posed along the path: the sparse
    keypoints of a route XML."""
    from thinktwice_tpu_torch.harness.route_parser import RouteSpec

    step = np.diff(route[:, :2], axis=0)
    cum = np.r_[0.0, np.cumsum(np.linalg.norm(step, axis=1))]
    yaw = np.arctan2(*np.r_[step, step[-1:]][:, ::-1].T)
    idx = np.unique(np.r_[np.searchsorted(cum, np.arange(0.0, cum[-1], KEYPOINT_M)),
                          len(route) - 1])
    return RouteSpec(name, "Grid6", route[idx, :2].astype(np.float64),
                     np.rad2deg(yaw[idx]).astype(np.float64))


def write_routes_xml(path: str, specs) -> None:
    """RouteSpecs -> a route XML in the leaderboard's format."""
    lines = ["<routes>"]
    for s in specs:
        lines.append(f'  <route id="{s.route_id}" town="{s.town}">')
        lines += [f'    <waypoint x="{float(x)!r}" y="{float(y)!r}" z="0.0" yaw="{float(w)!r}"/>'
                  for (x, y), w in zip(s.keypoints, s.keypoint_yaws)]
        lines.append("  </route>")
    with open(path, "w") as f:
        f.write("\n".join(lines + ["</routes>"]) + "\n")


def read_town_npz(path: str) -> dict:
    """The rasters of a town kept as an .npz (the keys of
    maps.compile_h5.read_town_h5): the smoke's town H5, since the card
    machine has no h5py."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["pixels_per_meter"] = float(out["pixels_per_meter"])
    return out


def imported_town(cfg, device, small: bool, n_worlds: int):
    """[town import]'s town, through the bench's imported-town entry point:
    the grid town of TOWN_BLOCKS x TOWN_BLOCKS blocks, its rasters and a
    stopline layer drawn from its stop lines written as the town's file (an
    .npz in place of the H5, read by read_town_npz); up to TOWN_ROUTES
    lane-graph routes of 100-370 m, a keypoint every ~KEYPOINT_M metres,
    written as a route XML; the town's lane loops, keypointed the same way,
    as the bank XML. bench.town05_world plans and filters the routes
    through the RasterPlanner, compiles the town at the bench's Town05
    capacities, strict, and writes the town cache; a second town05_cached
    call reads the cache file back. -> (town on `device`, routes (n_worlds,
    R, 3) numpy, scenarios, the seconds of each step, the compile's counts,
    the grid town on the CPU and the town's RasterPlanner)."""
    import tempfile

    from thinktwice_tpu_torch.bench import TOWN05_CAPS, town05_world
    from thinktwice_tpu_torch.maps import cache
    from thinktwice_tpu_torch.maps.procedural import grid_town_rasters, make_grid_town
    from thinktwice_tpu_torch.maps.router import generate_random_routes, raster_planner

    blocks, n_routes, tries = (2, 4, 200) if small else (TOWN_BLOCKS, TOWN_ROUTES, TOWN_MAX_TRIES)
    caps = (dict(max_lane_pts=4096, max_road_segs=1024, max_lane_segs=1024, strict=True)
            if small else TOWN05_CAPS)
    caps = dict(caps, max_lights=cfg.sim.max_lights, max_stops=cfg.sim.max_stop_signs)
    grid = make_grid_town(n_blocks=blocks, block=100.0, max_lane_pts=16384, max_lights=256,
                          max_spawn=2048, device="cpu")
    secs = {}
    cache_dir = cache.CACHE_DIR
    with tempfile.TemporaryDirectory() as tmp:
        town_path = os.path.join(tmp, "town.npz")
        routes_xml, bank_xml = os.path.join(tmp, "routes.xml"), os.path.join(tmp, "bank.xml")
        rasters = grid_town_rasters(grid)
        np.savez(town_path, **rasters)
        t0 = time.perf_counter()
        planner = raster_planner(town_path, read=read_town_npz)
        secs["planner"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lane_routes = generate_random_routes(
            grid, n_routes, min_length=100.0, max_length=min(370.0, cfg.sim.max_route_len - 20.0),
            seed=0, max_tries=tries)
        secs["routes"] = time.perf_counter() - t0
        specs = [keypoint_spec(r, str(i)) for i, r in enumerate(lane_routes)]
        bank = [keypoint_spec(p, f"loop{i}") for i, p in enumerate(grid_lane_loops(grid))]
        write_routes_xml(routes_xml, specs)
        write_routes_xml(bank_xml, bank)
        cache.CACHE_DIR = os.path.join(tmp, "towns")
        try:
            t0 = time.perf_counter()
            town, routes, scens = town05_world(cfg, n_worlds, town_path, routes_xml, device,
                                               bank_files=[bank_xml], read=read_town_npz,
                                               caps=caps)
            secs["world"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = cache.town05_cached(town_path, [routes_xml, bank_xml], device=device,
                                        read=read_town_npz, **caps)
            secs["cache"] = time.perf_counter() - t0
            n_files = len(os.listdir(cache.CACHE_DIR))
        finally:
            cache.CACHE_DIR = cache_dir
    if n_files != 1:
        raise AssertionError(f"the town cache holds {n_files} files, not 1")
    for f in dataclasses.fields(again):
        if not torch.equal(getattr(again, f.name), getattr(town, f.name)):
            raise AssertionError(f"the town cache changed {f.name}")
    counts = {k: int(getattr(town, v).sum()) for k, v in (
        ("lane points", "lane_valid"), ("road segments", "road_seg_valid"),
        ("lane segments", "lane_seg_valid"), ("lights", "tl_valid"), ("spawns", "spawn_valid"))}
    counts.update(routes=len(specs), bank=len(bank), raster=rasters["road"].shape[0],
                  keypoints=sum(len(s.keypoints) for s in specs + bank))
    return town, routes.cpu().numpy(), scens, secs, counts, grid, planner


def town_import(cfg, policy, device, card: str, on_card: bool, small: bool,
                n_worlds: int, n_ticks: int, n_vehicles: int) -> dict:
    """[town import]: the imported-town path at the bench's width. The
    town and n_worlds of its routes with Scenario3 and Scenario7 armed at a
    third and two thirds (imported_town, through bench.town05_world), the
    reset, n_ticks ticks of the Roach rollout with K1's count set to 0 just
    before and read just after; K1 against its plain version on the last
    frame (0 pixels off), its time and bound on these tables; a small
    rollout on the compiled town on the card against the CPU. -> the row's
    numbers; the town, routes for [reference export]; the grid town and
    the planner for [longest6]."""
    from thinktwice_tpu_torch.ops.birdview_cuda import (
        K1, birdview_bits_cuda, birdview_bits_plain, decode_bits)
    from thinktwice_tpu_torch.ops.raycast_cuda import K2
    from thinktwice_tpu_torch.rollout import rollout
    from thinktwice_tpu_torch.sensors import birdview as birdview_mod
    from thinktwice_tpu_torch.sensors.birdview import birdview_inputs
    from thinktwice_tpu_torch.sim.reset import reset_world
    from thinktwice_tpu_torch.sim.state import state_to_arrays

    town, routes, scens, secs, counts, grid, planner = imported_town(cfg, device, small,
                                                                     n_worlds)
    log(f"[town import] grid town of {TOWN_BLOCKS if not small else 2}^2 blocks as an imported "
        f"town ({counts['raster']} px a side at 5 px/m, stopline layer from its stop lines): "
        f"planner {secs['planner']:.2f} s, {counts['routes']} lane-graph routes "
        f"{secs['routes']:.2f} s; bench.town05_world on their route XML and a bank XML of "
        f"{counts['bank']} lane loops ({counts['keypoints']} keypoints): {len(routes)} routes "
        f"of 100 m to R - 10 m planned, the town compiled and cached in {secs['world']:.2f} s, "
        f"the cache file read back in {secs['cache']:.2f} s; "
        + ", ".join(f"{v} {k}" for k, v in counts.items()
                    if k not in ("routes", "bank", "keypoints", "raster"))
        + f" (capacities {town.lane_pts.shape[0]}, {town.road_segs.shape[0]}, "
        f"{town.lane_segs.shape[0]}, {town.tl_pos.shape[0]}, {town.spawn.shape[0]})")
    g = torch.Generator(device=device).manual_seed(TOWN_SEED)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    states0 = reset_world(cfg, town, torch.as_tensor(routes, device=device),
                          n_vehicles=n_vehicles, scenario=scens, generator=g)
    if on_card:
        torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    reset_peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    prims, _ = birdview_inputs(cfg.birdview, town, states0)
    rows, in_use = prims.shape[1], float((prims[..., 1] >= 0).sum()) / prims.shape[0]
    del prims
    comp0 = float(states0.criteria.route_completion.mean())
    with Spy(birdview_mod, "birdview_bits", keep=1) as k1_rec:
        K1.launches = K2.launches = 0
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _, controls = rollout(cfg, policy, town, states0, n_ticks, generator=g)
        if on_card:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, k2_n = K1.launches, K2.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    expected = n_ticks // 2 if on_card else 0
    arrays = state_to_arrays(final)
    _compare_arrays(arrays, arrays)          # raises on a non-finite field
    comp1 = float(final.criteria.route_completion.mean())
    log(f"[town import] {n_worlds} worlds x {n_ticks} ticks on the compiled town "
        f"({n_vehicles} vehicles, Scenario3 and Scenario7 on every route): {rows} table rows "
        f"a world ({in_use:.1f} in use), reset {reset_s:.3f} s (peak {reset_peak:.2f} GiB), "
        f"rollout {seconds:.3f} s: {n_worlds * n_ticks / seconds:.1f} env-steps/s on {card}; "
        f"K1 launches {launches} (expected {expected}), K2 launches {k2_n}; peak memory "
        f"{peak:.2f} GiB; mean "
        f"route completion {comp0:.4f} -> {comp1:.4f}, driven "
        f"{float(final.criteria.dist_driven.mean()):.2f} m")
    if launches != expected or k2_n != 0:
        raise AssertionError(f"K1 launched {launches} and K2 {k2_n} times on the imported town")
    if any(not torch.isfinite(c).all() for c in controls) or not np.all(arrays["tick"] == n_ticks):
        raise AssertionError("the imported town's rollout went wrong")
    if not float(final.criteria.dist_driven.mean()) > 0.0:
        raise AssertionError("the egos did not move on the imported town")
    row = {"launches": launches, "k2": k2_n, "rows": rows}
    if on_card:
        _, prims, ego = k1_rec.calls[-1][:3]
        bits_k = birdview_bits_cuda(cfg.birdview, prims, ego)
        bits_p = birdview_bits_plain(cfg.birdview, prims, ego)
        torch.cuda.synchronize()
        mism = int((bits_k != bits_p).sum())
        err = float((decode_bits(cfg.birdview, bits_k) - decode_bits(cfg.birdview, bits_p))
                    .abs().max())
        log(f"[k1 vs plain, imported town] the rollout's last policy call, {tuple(prims.shape)} "
            f"prims ({-(-prims.shape[1] // 4096)} chunks of 4096 rows): {mism} of "
            f"{bits_k.numel()} pixels differ, max abs err {err}")
        if mism or int((bits_p != 0).sum()) == 0 or prims.shape[1] <= 4096:
            raise AssertionError("K1 differs from its plain version on the imported town")
        ms = cuda_ms(lambda: birdview_bits_cuda(cfg.birdview, prims, ego), reps=20)
        plain_ms = cuda_ms(lambda: birdview_bits_plain(cfg.birdview, prims, ego), reps=1,
                           warmup=1)
        bound_ms, bound_by, pairs = k1_bound(cfg.birdview, prims, ego)
        used = float((prims[..., 1] >= 0).sum()) / prims.shape[0]
        log(f"[k1 time, imported town] {ms:.4f} ms a launch (plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by}, {pairs} pixel-primitive pairs; {used:.1f} of "
            f"{prims.shape[1]} rows a world in use) on {card}")
        row.update(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del prims, ego, bits_k, bits_p
        town_card_vs_cpu(town, routes, device)
    del final, states0, controls
    return row, town, routes, grid, planner


def town_card_vs_cpu(town, routes, device):
    """The route evaluator on the compiled town, once on the card and once on
    the CPU with the same draws: the roach_rl6 expert every 2 ticks on one
    of its routes cut to its first TOWN_CPU_ROUTE_M metres (padded with its
    last point, as a planned route is), to done or TOWN_CPU_TICKS ticks, so
    that the route can end Completed on one device and not on the other.
    The records must agree as eval_card_vs_cpu holds them."""
    from thinktwice_tpu_torch.agents.expert import make_expert_policy
    from thinktwice_tpu_torch.config import bench_config
    from thinktwice_tpu_torch.harness.evaluator import GeneratorDraws
    from thinktwice_tpu_torch.weights import load_roach_policy

    cfg = bench_config()
    n = TOWN_CPU_ROUTE_M + 1                     # points of 1 m
    short = np.concatenate([routes[0][:n], np.repeat(routes[0][n - 1:n], len(routes[0]) - n, 0)])
    runs = {}
    for dev in (torch.device(device), torch.device("cpu")):
        fn = make_expert_policy(cfg, load_roach_policy(WEIGHTS, cfg, dev))
        runs[dev.type] = run_eval(
            cfg, town.to(dev), [short], fn, n_vehicles=8, max_steps=TOWN_CPU_TICKS,
            worlds_per_batch=1, segment_steps=TOWN_CPU_SEGMENT, policy_every=2,
            draws=GeneratorDraws(6, device="cpu"))
    (g_d, rec_d, log_d, wall_d), (g_c, rec_c, log_c, wall_c) = runs[device.type], runs["cpu"]
    worst = compare_records(rec_d, rec_c, "town card vs cpu")
    if log_d[0]["ticks"] != log_c[0]["ticks"]:
        raise AssertionError("town card vs cpu: the runs took different tick counts")
    log(f"[town card vs cpu] the expert on the compiled town, 1 route cut to "
        f"{TOWN_CPU_ROUTE_M} m, to done or {TOWN_CPU_TICKS} ticks: {log_d[0]['ticks']} ticks, "
        f"status {rec_d[0]['status']!r} on both, route completion "
        f"{rec_d[0]['scores']['score_route']:.4f}, driving score "
        f"{g_d['scores']['score_composed']:.4f} on {device.type} and "
        f"{g_c['scores']['score_composed']:.4f} on cpu; record floats within {worst:.2e} "
        f"(limit {EVAL_TOL}); {wall_d:.2f} s on {device.type}, {wall_c:.2f} s on cpu")


def reference_export(town, routes, device, card: str, on_card: bool) -> dict:
    """[reference export]: one world of collect_batch on the compiled town,
    EXPORT_FRAMES frames (K1 and K2 counted), exported in the reference's
    layout with export_route and export_metadata and read back with
    ReferenceDataset and the PNG reader, with neither PIL nor cv2: images
    within 1/255, depth within 1 cm, seg exact, measurements and
    supervision equal to the frames'; K2 against its plain version on the
    last frame's rays."""
    import tempfile

    from thinktwice_tpu_torch.config import bench_config
    from thinktwice_tpu_torch.ops.birdview_cuda import K1
    from thinktwice_tpu_torch.ops.raycast_cuda import K2
    from thinktwice_tpu_torch.sim.reset import reset_world
    from thinktwice_tpu_torch.train.collect import collect_batch
    from thinktwice_tpu_torch.train.export_reference import (
        CAMERAS, export_metadata, export_route)
    from thinktwice_tpu_torch.train.png import read_png
    from thinktwice_tpu_torch.train.reference_dataset import ReferenceDataset
    from thinktwice_tpu_torch.weights import load_roach_policy

    cfg = bench_config() if on_card else student_tiny_config()
    policy = load_roach_policy(WEIGHTS, cfg, device=device)
    g = torch.Generator(device=device).manual_seed(TOWN_SEED + 1)
    state = reset_world(cfg, town, torch.as_tensor(routes[-1:], device=device), n_vehicles=8,
                        generator=g)
    with K2Inputs(keep=2) as k2_rec:
        K1.launches = K2.launches = 0
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, frames, sensors = collect_batch(cfg, policy, town, state, EXPORT_FRAMES, generator=g)
        if on_card:
            torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        k1_n, k2_n = K1.launches, K2.launches
    exp = (EXPORT_FRAMES * 6, EXPORT_FRAMES * 2) if on_card else (0, 0)
    if (k1_n, k2_n) != exp:
        raise AssertionError(f"the export's collection launched K1 {k1_n} and K2 {k2_n} times")
    sens = {k: v[0].cpu().numpy() for k, v in sensors.items()}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        n = export_route(os.path.join(root, "town_grid6_00"), frames, sensors)
        meta = export_metadata(root, os.path.join(root, "dataset_metadata.pkl"))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = ReferenceDataset(root, os.path.join(root, "dataset_metadata.pkl"))
        worst = {"rgb": 0.0, "depth": 0.0}
        for i in range(n):
            route_dir = os.path.join(root, "town_grid6_00")
            with open(os.path.join(route_dir, "measurements", f"{i:04d}.json")) as f:
                m = json.load(f)
            sup = np.load(os.path.join(route_dir, "supervision", f"{i:04d}.npy"),
                          allow_pickle=True)[()]
            want = {"x": frames.pos[0, i, 0], "y": frames.pos[0, i, 1], "theta": frames.yaw[0, i],
                    "speed": frames.speed[0, i], "steer": frames.control[0, i, 0],
                    "throttle": frames.control[0, i, 1], "brake": frames.control[0, i, 2]}
            if any(m[k] != float(v) for k, v in want.items()) or m["target_command"] != int(
                    frames.command[0, i]) + 1:
                raise AssertionError(f"frame {i}'s measurements differ from the frame")
            for key, name in (("action", "action"), ("action_mu", "alpha"),
                              ("action_sigma", "beta"), ("value", "value"),
                              ("features", "features")):
                if not np.array_equal(sup[key], frames.supervision[name][0, i].cpu().numpy()):
                    raise AssertionError(f"frame {i}'s supervision {key} differs")
            for k, grid in enumerate(frames.supervision["cnn_features"]):
                if not np.array_equal(sup["cnn_features"][k], grid[0, i].cpu().numpy()):
                    raise AssertionError(f"frame {i}'s cnn_features {k} differ")
            for c, cam in enumerate(CAMERAS):
                rgb = read_png(os.path.join(route_dir, cam, f"{i:04d}.png")) / 255.0
                depth = read_png(os.path.join(route_dir, cam.replace("rgb", "depth"),
                                              f"{i:04d}.png")) / 100.0
                seg = read_png(os.path.join(route_dir, cam.replace("rgb", "seg"), f"{i:04d}.png"))
                worst["rgb"] = max(worst["rgb"], float(np.abs(rgb - sens["rgb"][i, c]).max()))
                worst["depth"] = max(worst["depth"],
                                     float(np.abs(depth - sens["depth"][i, c]).max()))
                if not np.array_equal(seg, sens["semantic"][i, c].astype(np.uint8)):
                    raise AssertionError(f"frame {i} camera {cam}: seg differs")
        items = [ds[i] for i in range(len(ds))]
        for i, item in enumerate(items):
            if not np.array_equal(item["pos"], frames.pos[0, i].cpu().numpy()) or not np.isfinite(
                    item["gt_waypoints"]).all():
                raise AssertionError(f"item {i} differs from its frame")
        imgs = ds.load_images(0)
        read_s = time.perf_counter() - t0
    log(f"[reference export] 1 world x {EXPORT_FRAMES} frames collected on the compiled town "
        f"in {collect_s:.3f} s on {card} (K1 {k1_n}, K2 {k2_n}), exported in {export_s:.3f} s "
        f"({meta}), read back in {read_s:.3f} s without PIL or cv2 (PIL loaded: "
        f"{'PIL' in sys.modules}, cv2 loaded: {'cv2' in sys.modules}): {len(items)} items, "
        f"images {tuple(imgs.shape)} within {worst['rgb']:.2e} (limit {1 / 255:.2e}), depth "
        f"within {worst['depth']:.2e} m (limit 0.01), seg, measurements and supervision equal")
    if worst["rgb"] > 1 / 255 or worst["depth"] > 0.01 or meta != {"town_grid6_00": n}:
        raise AssertionError("the reference export does not read back")
    row = {"k1": k1_n, "k2": k2_n}
    if on_card:
        inputs = [(name, *call) for name, call in zip(("cameras", "lidar"), k2_rec.calls)]
        row["k2_err"] = compare_k2(inputs, "reference export, the last collected frame")
    return row


# --------------------------------------------------------------------------
# the Longest6 evaluation


def longest6_config(small: bool):
    """The Config that scripts/eval_longest6.py:107-117 builds with
    --vehicles 500: 508 vehicle slots (8 for scenario actors), 16 walkers,
    256 lights, 32 stop signs, 3,584-point routes, 8 scenario slots, the
    courtesy yield on. small: 16 slots, 4 walkers, the rehearsal town's 64
    lights and 8 stop signs, 1024-point routes."""
    from thinktwice_tpu_torch.config import Config, SimConfig

    if small:
        return Config(sim=SimConfig(max_vehicles=16, max_walkers=4, max_lights=64,
                                    max_stop_signs=8, max_route_len=1024, max_scenarios=8,
                                    courtesy_yield=True))
    return Config(sim=SimConfig(max_vehicles=L6_VEHICLES + 8, max_walkers=16, max_lights=256,
                                max_stop_signs=32, max_route_len=L6_ROUTE_LEN, max_scenarios=8,
                                courtesy_yield=True))


def longest6(town, grid, planner, device, card: str, on_card: bool, small: bool) -> dict:
    """[longest6]: the path of scripts/eval_longest6.py:107-190 on the
    imported town of [town import]. The longest L6_WORLDS of the town's
    lane-graph routes (L6_ROUTE_TRIES tried) written as a route XML, parsed
    and densified by the RasterPlanner to L6_ROUTE_LEN points, each with
    derive_map_triggers + build_route_scenarios scenarios; the roach_rl6
    expert every tick through evaluate_routes with min(500, Town05's 302
    spawn points) vehicles, the worlds in one batch of L6_SEGMENT-tick
    segments, stop_penalty 1.0, to done or L6_TICKS ticks, K1's count set to
    0 just before and read just after. On the card, K1 against its plain
    version on the last policy call's table (0 pixels off), timed with its
    bound, and one world's render_birdview_rgb from each version's masks,
    equal. -> K1's row numbers."""
    import tempfile

    from thinktwice_tpu_torch.agents import expert as expert_mod
    from thinktwice_tpu_torch.agents.expert import make_expert_policy
    from thinktwice_tpu_torch.harness.evaluator import build_route_scenarios, derive_map_triggers
    from thinktwice_tpu_torch.harness.route_parser import parse_routes_file
    from thinktwice_tpu_torch.maps.router import generate_random_routes
    from thinktwice_tpu_torch.maps.town import route_length
    from thinktwice_tpu_torch.ops.birdview_cuda import (
        K1, birdview_bits_cuda, birdview_bits_plain, decode_bits)
    from thinktwice_tpu_torch.ops.raycast_cuda import K2
    from thinktwice_tpu_torch.sensors.birdview import birdview_inputs, render_birdview_rgb
    from thinktwice_tpu_torch.weights import load_roach_policy

    cfg = longest6_config(small)
    R = cfg.sim.max_route_len
    n_worlds, n_ticks, segment = (2, 8, 4) if small else (L6_WORLDS, L6_TICKS, L6_SEGMENT)
    n_vehicles = 8 if small else min(L6_VEHICLES, L6_SPAWN_CAP)
    t0 = time.perf_counter()
    tries = 20 if small else L6_ROUTE_TRIES
    pool = generate_random_routes(grid, tries, min_length=100.0, max_length=R - 10.0,
                                  seed=L6_SEED, max_tries=tries)
    pool.sort(key=lambda r: -float(np.linalg.norm(np.diff(r[:, :2], axis=0), axis=1).sum()))
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "routes_longest6.xml")
        write_routes_xml(xml, [keypoint_spec(r, f"l6_{i}") for i, r in enumerate(pool[:n_worlds])])
        specs = parse_routes_file(xml)
    routes = [s.dense(spacing=1.0, max_len=R, planner=planner) for s in specs]
    scens = [build_route_scenarios(cfg, r, derive_map_triggers(town, r), device=device)
             for r in routes]
    plan_s = time.perf_counter() - t0
    lengths = [route_length(r) for r in routes]
    if len(routes) != n_worlds or max(len(r) for r in routes) > R:
        raise AssertionError(f"[longest6] {len(routes)} routes planned, not {n_worlds}")
    policy = load_roach_policy(WEIGHTS, cfg, device=device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with Spy(expert_mod, "birdview_from_state", keep=1) as rec:
        K1.launches = K2.launches = 0
        g, records, blog, wall = run_eval(
            cfg, town, routes, make_expert_policy(cfg, policy), n_vehicles=n_vehicles,
            max_steps=n_ticks, worlds_per_batch=n_worlds, segment_steps=segment,
            stop_penalty=1.0, scenarios=scens, weathers=[s.weather for s in specs], seed=0)
        k1_n, k2_n = K1.launches, K2.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    ticks, seconds = blog[0]["ticks"], blog[0]["seconds"]
    state = rec.calls[-1][2]
    slots = state.traffic.active.shape[1]
    background = int(state.traffic.active[:, :L6_VEHICLES].sum(1).min())
    expected = ticks if on_card else 0
    log(f"[longest6] eval_longest6.py's Config on the imported town: {n_worlds} worlds x "
        f"{slots} vehicle slots, {n_vehicles} vehicles (min({L6_VEHICLES}, Town05's "
        f"{L6_SPAWN_CAP} spawn points); at the last policy call {background} background "
        f"vehicles active in every world), {cfg.sim.max_walkers} walkers, "
        f"{cfg.sim.max_lights} lights, {cfg.sim.max_stop_signs} stop signs, {R}-point routes, "
        f"{sum(int(sc.kind.gt(0).sum()) if sc is not None else 0 for sc in scens)} map-derived "
        f"scenarios, stop penalty 1.0; the {n_worlds} longest of {len(pool)} lane-graph routes "
        f"({', '.join(f'{x:.0f}' for x in lengths)} m) planned in {plan_s:.2f} s")
    log(f"[longest6] the roach_rl6 expert every tick, 1 batch of {n_worlds} worlds, "
        f"{segment}-tick segments, at most {n_ticks} ticks: {ticks} ticks run in {seconds:.3f} s "
        f"({wall:.3f} s with the results file): {n_worlds * ticks / seconds:.1f} env-steps/s on "
        f"{card}; K1 launches {k1_n} (expected {expected}), K2 launches {k2_n}; peak memory "
        f"{peak:.2f} GiB")
    log(f"[longest6] {eval_summary(g, records)}; route completions "
        f"{[round(r['scores']['score_route'], 2) for r in records]}, statuses "
        f"{[r['status'] for r in records]}")
    if k1_n != expected or k2_n != 0 or slots != cfg.sim.max_vehicles:
        raise AssertionError(f"[longest6] K1 launched {k1_n} and K2 {k2_n} times on {slots} slots")
    if not small and background != n_vehicles:
        raise AssertionError(f"[longest6] {background} background vehicles, not {n_vehicles}")
    if len(records) != n_worlds or not all(
            np.isfinite(v) for r in records for v in r["scores"].values()):
        raise AssertionError("[longest6] a route's record is missing or not finite")
    prims, ego = birdview_inputs(cfg.birdview, town, state)
    extent = (cfg.sim.ego_extent_x, cfg.sim.ego_extent_y)
    row = {"launches": k1_n, "rows": prims.shape[1]}
    if not on_card:
        rgb = render_birdview_rgb(cfg.birdview, decode_bits(
            cfg.birdview, birdview_bits_plain(cfg.birdview, prims[:1], ego[:1]))[0], extent)
        if rgb.shape != (cfg.birdview.width,) * 2 + (3,) or not bool(rgb.isfinite().all()):
            raise AssertionError("[longest6] the RGB render went wrong")
        return row
    bits_k = birdview_bits_cuda(cfg.birdview, prims, ego)
    bits_p = birdview_bits_plain(cfg.birdview, prims, ego)
    torch.cuda.synchronize()
    mism = int((bits_k != bits_p).sum())
    err = float((decode_bits(cfg.birdview, bits_k) - decode_bits(cfg.birdview, bits_p))
                .abs().max())
    rgb_k = render_birdview_rgb(cfg.birdview, decode_bits(cfg.birdview, bits_k[:1])[0], extent)
    rgb_p = render_birdview_rgb(cfg.birdview, decode_bits(cfg.birdview, bits_p[:1])[0], extent)
    rgb_equal = bool(torch.equal(rgb_k, rgb_p))
    log(f"[k1 vs plain, longest6] the last policy call's {slots}-slot table, "
        f"{tuple(prims.shape)} prims ({-(-prims.shape[1] // 4096)} chunks of 4096 rows): {mism} "
        f"of {bits_k.numel()} pixels differ, max abs err {err}; world 0's render_birdview_rgb "
        f"from K1's masks equal to the plain version's: {rgb_equal} "
        f"({int((rgb_k.sum(-1) > 0).sum())} painted pixels)")
    if mism or not rgb_equal or int((bits_p != 0).sum()) == 0:
        raise AssertionError("[longest6] K1 differs from its plain version")
    ms = cuda_ms(lambda: birdview_bits_cuda(cfg.birdview, prims, ego), reps=20)
    plain_ms = cuda_ms(lambda: birdview_bits_plain(cfg.birdview, prims, ego), reps=1, warmup=1)
    bound_ms, bound_by, pairs = k1_bound(cfg.birdview, prims, ego)
    used = float((prims[..., 1] >= 0).sum()) / prims.shape[0]
    log(f"[k1 time, longest6] {ms:.4f} ms a launch (plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by}, {pairs} pixel-primitive pairs; {used:.1f} of "
        f"{prims.shape[1]} rows a world in use, {n_worlds} worlds) on {card}")
    row.update(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="2 worlds, 4 ticks, small capacities (CPU rehearsal)")
    ap.add_argument("--student-weights", default=STUDENT_WEIGHTS,
                    help="the student's flax msgpack archive (default: student_rl6)")
    args = ap.parse_args()

    clock = PhaseClock()
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        log("no CUDA device: this smoke test needs an NVIDIA card")
        return 2

    from thinktwice_tpu_torch.bench import card_line
    from thinktwice_tpu_torch.config import bench_config
    from thinktwice_tpu_torch.ops.birdview_cuda import K1
    from thinktwice_tpu_torch.ops.deform_attn import K3
    from thinktwice_tpu_torch.ops.grid_sample import K4
    from thinktwice_tpu_torch.ops.nvcc import build_all
    from thinktwice_tpu_torch.ops.raycast_cuda import K2
    from thinktwice_tpu_torch.ops.sparse_conv import K6
    from thinktwice_tpu_torch.ops.voxelize import K5
    from thinktwice_tpu_torch.rollout import grid_world, rollout
    from thinktwice_tpu_torch.sim.state import state_to_arrays
    from thinktwice_tpu_torch.weights import load_roach_policy

    torch.manual_seed(0)
    if args.small:
        cfg = small_config()
        n_worlds, n_ticks, n_vehicles = 2, 4, 8
    else:
        cfg = bench_config()
        n_worlds, n_ticks, n_vehicles = N_WORLDS, N_TICKS, N_VEHICLES

    # ---- phase 1: the card -------------------------------------------------
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kind = torch.cuda.get_device_name(0)
        card = card_line(torch.device("cuda"))
        log(f"[card] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; TF32 off for matmul and cuDNN")
    else:
        kind, card = "cpu", "cpu"
        log(f"[card] none: CPU rehearsal with the plain versions, torch {torch.__version__}")

    # ---- phase 2: build K1 to K4, one nvcc each, at once -----------------
    if on_card:
        wall = build_all([K1, K2, K3, K4, K5, K6])
        log(f"[build] K1 to K7 in {wall:.1f} s")
        for name, k in (("K1", K1), ("K2", K2), ("K3", K3), ("K4", K4), ("K5", K5),
                        ("K6 and K7", K6)):
            log(f"[build] {name} {os.path.relpath(k.source, REPO)}: {k.build_seconds:.1f} s")
            for line in k.build_log.strip().splitlines():
                log(f"[build]   {line.strip()}")
    clock.lap("1-2 card and build")

    device = torch.device(args.device)
    policy = load_roach_policy(WEIGHTS, cfg, device=device)
    log(f"[weights] {os.path.relpath(WEIGHTS, REPO)} -> RoachPolicy "
        f"({sum(p.numel() for p in policy.parameters())} parameters)")

    # ---- phase 3: K1 against its plain version at the main path's shape ----
    g = torch.Generator(device=device).manual_seed(42)
    town, states0 = grid_world(cfg, n_worlds, n_vehicles, device=device, generator=g)
    if on_card:
        compare_k1(cfg.birdview, town, states0, "at reset")
    warm, _, _ = rollout(cfg, policy, town, states0, 4, generator=g)
    k1_row = None
    if on_card:
        mism, err, prims, ego = compare_k1(cfg.birdview, town, warm, "after 4 ticks")
        from thinktwice_tpu_torch.ops.birdview_cuda import (
            birdview_bits_cuda,
            birdview_bits_plain,
        )

        ms = cuda_ms(lambda: birdview_bits_cuda(cfg.birdview, prims, ego), reps=50)
        plain_ms = cuda_ms(lambda: birdview_bits_plain(cfg.birdview, prims, ego), reps=3)
        bound_ms, bound_by, pairs = k1_bound(cfg.birdview, prims, ego)
        in_use = float((prims[..., 1] >= 0).sum()) / prims.shape[0]
        log(f"[k1 time] {ms:.4f} ms a launch "
            f"(plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}, {pairs} "
            f"pixel-primitive pairs; {in_use:.1f} of {prims.shape[1]} rows a world in use) "
            f"on {card}")
        k1_row = dict(name="birdview_bits", route="cuda",
                      source="thinktwice_tpu_torch/csrc/birdview.cu",
                      replaces="thinktwice_tpu/ops/birdview_pallas.py:200",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        # ---- phase 4: the port on the card against the port on the CPU ----
        policy_cpu = load_roach_policy(WEIGHTS, cfg, device="cpu")
        check_small_reference(cfg, policy_cpu, device)
    clock.lap("3-4 k1 and small reference")

    # ---- phase 5: the Roach rollout, the first main path -------------------
    comp0 = float(states0.criteria.route_completion.mean())
    K1.launches = K2.launches = 0
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, events, controls = rollout(cfg, policy, town, states0, n_ticks, generator=g)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, k2_in_roach = K1.launches, K2.launches
    expected = n_ticks // 2 if on_card else 0
    log(f"[rollout] {n_worlds} worlds x {n_ticks} ticks in {seconds:.3f} s: "
        f"{n_worlds * n_ticks / seconds:.1f} env-steps/s on {card}; "
        f"K1 launches {launches} (expected {expected}), K2 launches {k2_in_roach}")
    if launches != expected or k2_in_roach != 0:
        raise AssertionError(f"K1 launched {launches} times, expected {expected}")
    arrays = state_to_arrays(final)
    _compare_arrays(arrays, arrays)          # raises on a non-finite field
    if any(not torch.isfinite(c).all() for c in controls):
        raise AssertionError("a control is not finite")
    comp1 = float(final.criteria.route_completion.mean())
    ticks = arrays["tick"]
    counters = {k: int(arrays["criteria"][k].sum()) for k in (
        "n_collision_vehicle", "n_collision_walker", "n_collision_static",
        "n_red_light", "n_stop_sign")}
    log(f"[rollout] mean route completion {comp0:.4f} -> {comp1:.4f}; "
        f"mean speed {float(final.ego.speed.mean()):.2f} m/s, driven "
        f"{float(final.criteria.dist_driven.mean()):.2f} m; counters {counters}")
    if not np.all(ticks == n_ticks):
        raise AssertionError("a world's tick count is wrong")
    if not float(final.criteria.dist_driven.mean()) > 0.0:
        raise AssertionError("the egos did not move")
    if not args.small and not comp1 > comp0:
        raise AssertionError("route completion did not grow")

    if on_card:
        compare_k1(cfg.birdview, town, final, f"after {n_ticks} ticks")
        breakdown(cfg, policy, town, final, g)
        k1_row["launches"] = launches
    del town, states0, warm, final, events, controls
    clock.lap("5 roach rollout")

    # ---- phase 6: the route evaluator: card against CPU, then the expert
    # evaluation, the next main path ----------------------------------------
    eval_card_vs_cpu(policy_cpu if on_card else policy, device, args.small)
    if args.small:
        eval_expert(cfg, policy, device, n_worlds, n_vehicles, card, max_steps=8, segment=4)
    else:
        eval_expert(cfg, policy, device, n_worlds, n_vehicles, card, max_steps=EVAL_EXPERT_TICKS)
    del policy
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("6 evaluations")

    # ---- phase 7: the ThinkTwice student and its evaluation -----------------
    k2_row, look_rows = student_phases(args, on_card, device, card)
    if on_card:
        torch.cuda.empty_cache()
    sparse_rows = sparse_lidar(device, card, on_card)
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("7 student")

    # ---- phase 8: the student's training ----------------------------------
    train = train_phases(args, on_card, device, card, n_vehicles)
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("8 student training")

    # ---- phase 9: the Roach expert's training, the last main path ---------
    k2_before = K2.launches
    expert = expert_train_phases(args, on_card, device, card)
    if K2.launches != k2_before:
        raise AssertionError("the expert's training launched K2")
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("9 expert training")

    # ---- phase 10: several processes: the dry run, the sharded rollout ------
    ddp_dryrun(on_card, card)
    sharded_k1, sharded_k2 = worlds_sharded(cfg, device, card, on_card, n_worlds, n_vehicles,
                                            n_ticks)
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("10 several processes")

    # ---- phase 11: an imported town, its rollout and the reference export ---
    policy = load_roach_policy(WEIGHTS, cfg, device=device)
    town_row, town05, town_routes, grid6, planner = town_import(
        cfg, policy, device, card, on_card, args.small, n_worlds, n_ticks, n_vehicles)
    del policy
    export = reference_export(town05, town_routes, device, card, on_card)
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("11 imported town")

    # ---- phase 12: the Longest6 evaluation on the imported town ------------
    l6_row = longest6(town05, grid6, planner, device, card, on_card, args.small)
    del town05
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("12 longest6")

    if on_card:
        k1_row["train_launches"], k2_row["train_launches"] = train["k1_train"], train["k2_train"]
        k1_row["ppo_launches"], k1_row["bc_launches"] = expert["ppo"], expert["bc"]
        k1_row["sharded_launches"], k2_row["sharded_launches"] = sharded_k1, sharded_k2
        k2_row["ppo_launches"] = k2_row["bc_launches"] = 0
        k1_row["town_launches"], k2_row["town_launches"] = town_row["launches"], town_row["k2"]
        k1_row["export_launches"], k2_row["export_launches"] = export["k1"], export["k2"]
        k1_row["longest6_launches"], k2_row["longest6_launches"] = l6_row["launches"], 0
        for k in ("rows", "ms", "plain_ms", "bound_ms", "bound_by"):
            k1_row[f"town_{k}"] = town_row[k]
        for k in ("rows", "ms", "bound_ms", "bound_by"):
            k1_row[f"longest6_{k}"] = l6_row[k]
        k1_row["max_abs_err"] = max(k1_row["max_abs_err"], train["k1_err"], expert["err"],
                                    town_row["err"], l6_row["err"])
        k2_row["max_abs_err"] = max(k2_row["max_abs_err"], train["k2_err"], export["k2_err"])
        keys = ("name", "route", "source", "replaces", "launches", "train_launches",
                "ppo_launches", "bc_launches", "sharded_launches", "town_launches",
                "export_launches", "longest6_launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
        k1_keys = ("town_rows", "town_ms", "town_plain_ms", "town_bound_ms", "town_bound_by",
                   "longest6_rows", "longest6_ms", "longest6_bound_ms", "longest6_bound_by")
        log(json.dumps({"kernels": [{k: row[k] for k in keys + (k1_keys if row is k1_row else ())}
                                    for row in (k1_row, k2_row)] + look_rows
                          + sparse_rows}))
        log(clock.line())
        log(card_line(device))
        device_info = {"platform": "gpu", "kind": kind,
                       "count": torch.cuda.device_count()}
    else:
        log(clock.line())
        log(card)
        device_info = {"platform": "cpu", "kind": kind, "count": 1}
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
