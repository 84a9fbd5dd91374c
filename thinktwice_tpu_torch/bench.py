"""Benchmark of the port: aggregate env-steps/s of the closed-loop Roach
rollout over 64 worlds (the workload of the repository's `bench.py`).

64 worlds, 120 background vehicles in 128 slots, 8 walkers, 384-point
routes, driven closed loop by the roach_rl6 expert (birdview through K1,
the policy, the rule brakes) every 2 ticks, on the procedural 2-block grid
town. Given a Town05 H5 and its route XML (--h5 and --routes, both), the
worlds run on that imported town instead (`town05_world`: 64 of its routes
of 100-374 m, Scenario3 and Scenario7 armed at a third and two thirds of
each, the bench's raised capacities) and the metric's name says so. Those
files are not in the repository, so the grid town is the only workload
measured until they are. A warm-up run comes first; the timed run starts
again from the same reset worlds and covers --steps ticks.

    python -m thinktwice_tpu_torch.bench              # on the card
    python -m thinktwice_tpu_torch.cli benchmark      # the same

Prints one JSON line {"metric", "value", "unit", "vs_baseline"} (value /
1000 env-steps/s) and, on a line of its own, the card's name and power
limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.config import bench_config
from thinktwice_tpu_torch.rollout import POLICY_EVERY, grid_world, rollout
from thinktwice_tpu_torch.sim.reset import reset_world
from thinktwice_tpu_torch.sim.state import tree_map
from thinktwice_tpu_torch.weights import load_roach_policy

N_WORLDS = 64
N_STEPS = 200          # timed ticks per world
N_VEHICLES = 120
SEED = 42
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "runs", "roach_rl6", "params.msgpack")
# the imported town's capacities (bench.py:75): strict, so no content is cut
TOWN05_CAPS = dict(max_lane_pts=49152, max_road_segs=8192, max_lane_segs=8192, strict=True)


def scenario_triggers(route: np.ndarray) -> list:
    """Scenario3 (a walker crossing) at a third and Scenario7 (a junction
    crossing) at two thirds of a dense route, posed on it."""
    from thinktwice_tpu_torch.harness.route_parser import ScenarioTrigger

    n = len(route)
    return [ScenarioTrigger(kind, route[i, :2].astype(np.float64), np.rad2deg(route[i, 2]))
            for kind, i in (("Scenario3", n // 3), ("Scenario7", 2 * n // 3))]


def scenario_batch(cfg, routes: np.ndarray, device):
    """One ScenarioState row per route, armed by scenario_triggers."""
    from thinktwice_tpu_torch.harness.evaluator import build_route_scenarios

    rows = [build_route_scenarios(cfg, r, scenario_triggers(r), device=device) for r in routes]
    return tree_map(lambda *xs: torch.cat(xs), *rows)


def town05_world(cfg, n_worlds: int, h5_path: str, routes_xml: str, device="cuda",
                 bank_files=(), read=None, caps=TOWN05_CAPS):
    """(town, routes (n_worlds, R, 3), scenarios): the imported town of a
    town H5, compiled (or loaded from the town cache) at caps from the
    routes of routes_xml and of the bank_files (route XMLs for town-wide
    NPC coverage), and the first n_worlds of routes_xml's routes whose
    planned length is 100 m to R - 10 m, densified by the raster planner to
    R = cfg.sim.max_route_len points, each with scenario_triggers armed.
    read: path -> the town's rasters, for a town kept in another format
    than an H5 (maps.compile_h5.read_town_h5 unless given)."""
    from thinktwice_tpu_torch.harness.route_parser import parse_routes_file
    from thinktwice_tpu_torch.maps.cache import town05_cached
    from thinktwice_tpu_torch.maps.router import raster_planner
    from thinktwice_tpu_torch.maps.town import route_length

    device = resolve_device(device)
    R = cfg.sim.max_route_len
    planner = raster_planner(h5_path, read=read)
    routes = []
    for spec in parse_routes_file(routes_xml):
        if not 100.0 <= route_length(spec.dense(spacing=1.0, planner=planner)) <= R - 10:
            continue
        routes.append(spec.dense(spacing=1.0, max_len=R, planner=planner))
        if len(routes) == n_worlds:
            break
    if len(routes) < n_worlds:
        raise ValueError(f"{routes_xml} holds {len(routes)} routes of 100 to {R - 10} m, "
                         f"not {n_worlds}")
    town = town05_cached(h5_path, [routes_xml, *bank_files], device=device, read=read, **caps)
    routes = np.stack(routes).astype(np.float32)
    return town, torch.as_tensor(routes, device=device), scenario_batch(cfg, routes, device)


def card_line(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def run(device="cuda", n_worlds: int = N_WORLDS, n_steps: int = N_STEPS,
        h5_path: str | None = None, routes_xml: str | None = None) -> dict:
    """Warm-up run, then the timed run from the same reset worlds ->
    the JSON record. The imported town of h5_path and routes_xml when both
    are given, else the grid town."""
    if (h5_path is None) != (routes_xml is None):
        raise ValueError("the imported town needs both its H5 and its route XML")
    device = resolve_device(device)
    cfg = bench_config()
    policy = load_roach_policy(WEIGHTS, cfg, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    on_town05 = h5_path is not None
    if on_town05:
        town, routes, scens = town05_world(cfg, n_worlds, h5_path, routes_xml, device)
        states = reset_world(cfg, town, routes, n_vehicles=N_VEHICLES, scenario=scens,
                             generator=g)
    else:
        town, states = grid_world(cfg, n_worlds, N_VEHICLES, device=device, generator=g)

    def timed() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _, _ = rollout(cfg, policy, town, states, n_steps, POLICY_EVERY,
                              generator=g)
        final.tick.cpu()                 # waits for the device
        return time.perf_counter() - t0

    timed()                              # warm-up
    seconds = timed()
    rate = n_worlds * n_steps / seconds
    return {
        "metric": f"env_steps_per_sec_{n_worlds}worlds_roach_{'town05' if on_town05 else 'grid'}",
        "value": round(rate, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(rate / 1000.0, 3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worlds", type=int, default=N_WORLDS)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--h5", help="a Town05 H5; with --routes, the worlds run on it")
    ap.add_argument("--routes", help="its route XML")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(device, args.worlds, args.steps, args.h5, args.routes)), flush=True)
    print(card_line(device), flush=True)


if __name__ == "__main__":
    main()
