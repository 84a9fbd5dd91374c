"""Train the Roach expert with PPO on the grid town (counterpart of
`scripts/train_roach_ppo.py` and, with --init and --anchor, of the PPO
polish of `scripts/finetune_roach_town05.py`).

    python -m thinktwice_tpu_torch.scripts.train_roach_ppo [--iters N] [--out DIR]
    # the fine-tune recipe: the BC clone polished under a KL anchor
    python -m thinktwice_tpu_torch.scripts.train_roach_ppo \\
        --init runs/roach_bc5/params.msgpack --anchor 0.05 --policy-every 2 \\
        --vehicles 48 --lr 3e-5 --envs 24 --steps 128 --iters 150 --out DIR

Every iteration appends one line of its metrics to DIR/metrics.jsonl (the
JAX script's keys, rounded to 5 places, with iter, env_steps and wall_s);
the policy is archived to DIR/params.msgpack (flax msgpack, read by both
packages) every 50 iterations and at the end. --resume starts from that
archive with a fresh optimizer state. The trainer runs on --device (default
the card); its random numbers come from one torch.Generator seeded with
--seed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.config import Config, SimConfig
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sim.state import tree_map, zero_scenarios
from thinktwice_tpu_torch.train import checkpoint as ckpt_lib
from thinktwice_tpu_torch.train.draws import GeneratorTrainDraws
from thinktwice_tpu_torch.train.ppo import PPOConfig, make_policy, make_ppo
from thinktwice_tpu_torch.weights import load_roach_policy


def build_routes(n_routes: int, n_blocks: int = 2, block: float = 100.0) -> np.ndarray:
    """(n_routes, 256, 3) straight routes of 160 m over the grid town's right
    lanes, east-, west-, north- and southbound in turn."""
    half = 1.75
    rows = [g + half for g in range(0, int(n_blocks * block) + 1, int(block))]
    cols = [g - half for g in range(0, int(n_blocks * block) + 1, int(block))]
    routes = []
    for i in range(n_routes):
        kind, length, n = i % 4, 160.0, 256
        if kind == 0:    # eastbound on a row (right lane y = g - 1.75)
            xs = np.linspace(5.0, 5.0 + length, n)
            r = np.stack([xs, np.full_like(xs, rows[i % len(rows)] - 2 * half),
                          np.zeros_like(xs)], 1)
        elif kind == 1:  # westbound
            xs = np.linspace(5.0 + length, 5.0, n)
            r = np.stack([xs, np.full_like(xs, rows[i % len(rows)]), np.full_like(xs, np.pi)], 1)
        elif kind == 2:  # northbound on a column (right lane x = g + 1.75)
            ys = np.linspace(5.0, 5.0 + length, n)
            r = np.stack([np.full_like(ys, cols[i % len(cols)] + 2 * half), ys,
                          np.full_like(ys, np.pi / 2)], 1)
        else:            # southbound
            ys = np.linspace(5.0 + length, 5.0, n)
            r = np.stack([np.full_like(ys, cols[i % len(cols)]), ys,
                          np.full_like(ys, -np.pi / 2)], 1)
        routes.append(r)
    return np.stack(routes).astype(np.float32)


def grid_config(n_vehicles: int, max_scenarios: int = 8) -> Config:
    """The recipes' capacities on the grid town: 8 traffic slots above the
    background traffic (for scenario actors), 8 walkers, 256-point routes."""
    return Config(sim=SimConfig(max_vehicles=n_vehicles + 8, max_walkers=8,
                                max_route_len=256, max_scenarios=max_scenarios))


def scenario_bank(cfg: Config, town: TownMap, routes: np.ndarray):
    """One ScenarioState row per route with the map-derived triggers the
    evaluator arms (zero rows where none maps to a kind)."""
    from thinktwice_tpu_torch.harness.evaluator import build_route_scenarios, derive_map_triggers

    rows = []
    for dense in routes:
        s = build_route_scenarios(cfg, dense, derive_map_triggers(town, dense), device=town.device)
        rows.append(zero_scenarios(cfg, 1, town.device) if s is None else s)
    return tree_map(lambda *xs: torch.cat(xs), *rows)


def write_metrics(log, m: dict, **extra) -> str:
    rec = {k: round(float(v), 5) for k, v in m.items()}
    rec.update(extra)
    line = json.dumps(rec)
    print(line, flush=True)
    log.write(line + "\n")
    log.flush()
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--steps", type=int, default=128, help="macro steps per rollout")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--vehicles", type=int, default=0, help="background traffic per world")
    ap.add_argument("--policy-every", type=int, default=1,
                    help="ticks an action is held (2: the expert's 10 Hz)")
    ap.add_argument("--init", default=None,
                    help="params.msgpack to start from (default: a seeded initial policy)")
    ap.add_argument("--anchor", type=float, default=0.0,
                    help="KL(init || current) coefficient; needs --init")
    ap.add_argument("--red-scale", type=float, default=1.0)
    ap.add_argument("--scenarios", action="store_true",
                    help="arm the map-derived scenarios of each route")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/roach_ppo_torch")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.anchor > 0.0 and not args.init:
        ap.error("--anchor needs --init (the anchor is the initial policy)")

    device = resolve_device(args.device)
    cfg = grid_config(args.vehicles)
    town = make_grid_town(2, 100.0, device=device)
    routes = build_routes(args.envs)
    pcfg = PPOConfig(n_envs=args.envs, n_steps=args.steps, n_epochs=args.epochs,
                     minibatch=args.minibatch, lr=args.lr, seed=args.seed,
                     n_vehicles=args.vehicles, policy_every=args.policy_every,
                     anchor_coef=args.anchor, red_light_scale=args.red_scale)
    anchor = None
    if args.anchor > 0.0:
        anchor = load_roach_policy(args.init, cfg, device=device).requires_grad_(False)
    scen = scenario_bank(cfg, town, routes) if args.scenarios else None
    init_fn, iterate_fn = make_ppo(cfg, pcfg, town, routes, scenarios=scen, anchor=anchor)
    draws = GeneratorTrainDraws(town, args.seed)
    policy, opt_state, env_states = init_fn(draws)
    os.makedirs(args.out, exist_ok=True)
    archive = os.path.join(args.out, "params.msgpack")
    start = archive if (args.resume and os.path.exists(archive)) else args.init
    if start:
        policy = make_policy(cfg, device)
        policy.load_state_dict(ckpt_lib.restore_pytree(start, policy))
        print("resumed params" if start == archive else f"warm start from {start}", flush=True)

    t0 = time.time()
    with open(os.path.join(args.out, "metrics.jsonl"), "a") as log:
        for it in range(args.iters):
            policy, opt_state, env_states, m = iterate_fn(policy, opt_state, env_states, draws)
            write_metrics(log, m, iter=it, env_steps=(it + 1) * args.envs * args.steps,
                          wall_s=round(time.time() - t0, 1))
            if (it + 1) % 50 == 0 or it == args.iters - 1:
                ckpt_lib.archive_params(archive, policy.state_dict())


if __name__ == "__main__":
    main()
