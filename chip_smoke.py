"""Chip smoke test of the PyTorch port: builds every CUDA kernel of the
closed-loop Roach rollout from the sources in this checkout, holds each
against its plain PyTorch version on the card, checks the port against its
CPU run on a small input, and drives the rollout at the bench's shape
(64 worlds on the 2-block grid town, 120 vehicles, 15 x 192 x 192
birdview, the roach_rl6 expert, policy every 2 ticks).

    python3 chip_smoke.py                       # on a machine with one card
    python3 chip_smoke.py --device cpu --small  # CPU rehearsal, plain versions

It imports torch, numpy, the standard library and thinktwice_tpu_torch
only. Any failed phase raises and the script exits non-zero. Output: progress
lines, then one JSON line of the kernels, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(REPO, "runs", "roach_rl6", "params.msgpack")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
K1_FLOP_PER_PAIR = 15      # float operations of one pixel-primitive test
K1_FLOP_PER_PIXEL = 8      # the pixel's world coordinates
MISMATCH_LIMIT = 1e-4      # share of pixels where K1 may differ from plain
N_WORLDS, N_VEHICLES = 64, 120   # the bench's shape (bench.py:38-41)
N_TICKS = 200              # ticks of the timed rollout, policy every 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    from thinktwice_tpu_torch.ops.birdview_cuda import pixel_world_coords

    B, NP, _ = prims.shape
    W = cfg.width
    wx, wy = pixel_world_coords(cfg, ego)
    wx, wy = wx[..., None], wy[..., None]
    pairs = 0
    for k0 in range(0, NP, 64):
        p = prims[:, None, k0:k0 + 64, :]
        seg = p[..., 0] < 0.5
        xb, yb = p[..., 2] + p[..., 4], p[..., 3] + p[..., 5]
        hx = torch.where(seg, p[..., 7],
                         p[..., 4].abs() * p[..., 6] + p[..., 5].abs() * p[..., 7])
        hy = torch.where(seg, p[..., 7],
                         p[..., 5].abs() * p[..., 6] + p[..., 4].abs() * p[..., 7])
        x0 = torch.where(seg, torch.minimum(p[..., 2], xb), p[..., 2]) - hx
        x1 = torch.where(seg, torch.maximum(p[..., 2], xb), p[..., 2]) + hx
        y0 = torch.where(seg, torch.minimum(p[..., 3], yb), p[..., 3]) - hy
        y1 = torch.where(seg, torch.maximum(p[..., 3], yb), p[..., 3]) + hy
        inside = (wx >= x0) & (wx <= x1) & (wy >= y0) & (wy <= y1) & (p[..., 1] >= 0)
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

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(cfg, policy, town, states, 10, generator=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device time: the union of the kernels' and copies' intervals on the
    # card (the CPU ops that launched them carry the same time again)
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log("[breakdown] device busy share: not measured (no device time in the trace)")
        return
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
    log(f"[breakdown] 10 ticks under the profiler: {wall * 1e3:.1f} ms wall, "
        f"{busy_us / 1e3:.1f} ms device busy ({busy_us / 1e6 / wall:.1%}), "
        f"{len(kernels)} device kernels and copies; top: "
        + "; ".join(f"{name[:40]} {us / 1e3:.2f} ms x{n}" for name, (us, n) in top))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="2 worlds, 4 ticks, small capacities (CPU rehearsal)")
    args = ap.parse_args()

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        log("no CUDA device: this smoke test needs an NVIDIA card")
        return 2

    from thinktwice_tpu_torch.config import Config, SimConfig, bench_config
    from thinktwice_tpu_torch.ops.birdview_cuda import K1, SOURCE
    from thinktwice_tpu_torch.rollout import grid_world, rollout
    from thinktwice_tpu_torch.sim.state import state_to_arrays
    from thinktwice_tpu_torch.weights import load_roach_policy

    torch.manual_seed(0)
    if args.small:
        cfg = Config(sim=SimConfig(max_vehicles=16, max_walkers=8, max_lights=64,
                                   max_stop_signs=8, max_route_len=256,
                                   max_scenarios=8))
        n_worlds, n_ticks, n_vehicles = 2, 4, 8
    else:
        cfg = bench_config()
        n_worlds, n_ticks, n_vehicles = N_WORLDS, N_TICKS, N_VEHICLES

    # ---- phase 1: the card -------------------------------------------------
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kind = torch.cuda.get_device_name(0)
        card = card_line()
        log(f"[card] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; TF32 off for matmul and cuDNN")
    else:
        kind, card = "cpu", "cpu"
        log(f"[card] none: CPU rehearsal with the plain versions, torch {torch.__version__}")

    # ---- phase 2: build K1 -------------------------------------------------
    if on_card:
        K1.library()
        log(f"[build] K1 {os.path.relpath(SOURCE, REPO)}: {K1.build_seconds:.1f} s")
        for line in K1.build_log.strip().splitlines():
            log(f"[build]   {line.strip()}")

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
        log(f"[k1 time] {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"by {bound_by}, {pairs} pixel-primitive pairs) on {card}")
        k1_row = dict(name="birdview_bits", route="cuda",
                      source="thinktwice_tpu_torch/csrc/birdview.cu",
                      replaces="thinktwice_tpu/ops/birdview_pallas.py:200",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        # ---- phase 4: the port on the card against the port on the CPU ----
        policy_cpu = load_roach_policy(WEIGHTS, cfg, device="cpu")
        check_small_reference(cfg, policy_cpu, device)

    # ---- phase 5: the main path ---------------------------------------------
    comp0 = float(states0.criteria.route_completion.mean())
    K1.launches = 0
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, events, controls = rollout(cfg, policy, town, states0, n_ticks, generator=g)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = K1.launches
    expected = n_ticks // 2 if on_card else 0
    log(f"[rollout] {n_worlds} worlds x {n_ticks} ticks in {seconds:.3f} s: "
        f"{n_worlds * n_ticks / seconds:.1f} env-steps/s on {card}; "
        f"K1 launches {launches} (expected {expected})")
    if launches != expected:
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
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        log(json.dumps({"kernels": [{k: k1_row[k] for k in keys}]}))
        log(card_line())
        device_info = {"platform": "gpu", "kind": kind,
                       "count": torch.cuda.device_count()}
    else:
        log(card)
        device_info = {"platform": "cpu", "kind": kind, "count": 1}
    print(json.dumps({"ok": True, "device": device_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
