"""Benchmark of the port: aggregate env-steps/s of the closed-loop Roach
rollout over 64 worlds (the grid-town workload of the repository's
`bench.py`).

64 worlds on the procedural 2-block grid town, 120 background vehicles in
128 slots, 8 walkers, 384-point routes, driven closed loop by the roach_rl6
expert (birdview through K1, the policy, the rule brakes) every 2 ticks.
A warm-up run comes first; the timed run starts again from the same reset
worlds and covers --steps ticks. The imported Town05 world of `bench.py`
needs the reference map and routes, which the repository does not hold.

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

import torch

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.config import bench_config
from thinktwice_tpu_torch.rollout import POLICY_EVERY, grid_world, rollout
from thinktwice_tpu_torch.weights import load_roach_policy

N_WORLDS = 64
N_STEPS = 200          # timed ticks per world
N_VEHICLES = 120
SEED = 42
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "runs", "roach_rl6", "params.msgpack")


def card_line(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def run(device="cuda", n_worlds: int = N_WORLDS, n_steps: int = N_STEPS) -> dict:
    """Warm-up run, then the timed run from the same reset worlds ->
    the JSON record."""
    device = resolve_device(device)
    cfg = bench_config()
    policy = load_roach_policy(WEIGHTS, cfg, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
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
        "metric": f"env_steps_per_sec_{n_worlds}worlds_roach_grid",
        "value": round(rate, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(rate / 1000.0, 3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worlds", type=int, default=N_WORLDS)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(device, args.worlds, args.steps)), flush=True)
    print(card_line(device), flush=True)


if __name__ == "__main__":
    main()
