"""Behavior-clone the Roach policy from the rule-based autopilot on the grid
town (counterpart of the loop of `scripts/train_bc_town05.py`).

    python -m thinktwice_tpu_torch.scripts.train_bc [--iters N] [--out DIR]

The recipe's shapes: 24 worlds, 256 ticks a rollout (one frame every 2),
96 background vehicles in 104 slots, perturbation 0.05, and 32 grid routes
of which the tail 8 are held out for the closed-loop probe (every
--eval-every iterations and at the end). Every 5th iteration, and the last,
appends one line of metrics to DIR/metrics.jsonl (the JAX script's keys,
rounded to 5 places, with the probe's cl_* where it ran); the policy is
archived to DIR/params.msgpack every 50 iterations and at the end. The
trainer runs on --device (default the card).
"""

from __future__ import annotations

import argparse
import os
import time

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.scripts.train_roach_ppo import (
    build_routes,
    grid_config,
    scenario_bank,
    write_metrics,
)
from thinktwice_tpu_torch.train import checkpoint as ckpt_lib
from thinktwice_tpu_torch.train.bc import BCConfig, make_bc
from thinktwice_tpu_torch.train.draws import GeneratorTrainDraws
from thinktwice_tpu_torch.train.ppo import make_policy


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--envs", type=int, default=24)
    ap.add_argument("--steps", type=int, default=256, help="sim ticks per rollout")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--minibatch", type=int, default=256)
    ap.add_argument("--vehicles", type=int, default=96)
    ap.add_argument("--routes", type=int, default=32, help="grid routes; the tail is the probe's")
    ap.add_argument("--eval-envs", type=int, default=8)
    ap.add_argument("--eval-steps", type=int, default=768)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--perturb", type=float, default=0.05)
    ap.add_argument("--dagger", type=float, default=0.0)
    ap.add_argument("--dagger-ramp", type=int, default=100)
    ap.add_argument("--scenarios", action="store_true",
                    help="arm the map-derived scenarios of each route")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/roach_bc_torch")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = grid_config(args.vehicles)
    town = make_grid_town(2, 100.0, device=device)
    routes = build_routes(args.routes)
    bcfg = BCConfig(n_envs=args.envs, n_steps=args.steps, n_epochs=args.epochs,
                    minibatch=args.minibatch, n_vehicles=args.vehicles, seed=args.seed,
                    perturb_prob=args.perturb, eval_envs=args.eval_envs,
                    eval_steps=args.eval_steps)
    scen = scenario_bank(cfg, town, routes) if args.scenarios else None
    init_fn, iterate_fn = make_bc(cfg, bcfg, town, routes, scenarios=scen)
    draws = GeneratorTrainDraws(town, args.seed)
    policy, opt_state, env_states = init_fn(draws)
    os.makedirs(args.out, exist_ok=True)
    archive = os.path.join(args.out, "params.msgpack")
    if args.resume and os.path.exists(archive):
        policy = make_policy(cfg, device)
        policy.load_state_dict(ckpt_lib.restore_pytree(archive, policy))
        print("resumed params", flush=True)

    t0 = time.time()
    with open(os.path.join(args.out, "metrics.jsonl"), "a") as log:
        for it in range(args.iters):
            mix = args.dagger * min(1.0, it / max(args.dagger_ramp, 1))
            policy, opt_state, env_states, m = iterate_fn(policy, opt_state, env_states, draws,
                                                          dagger_mix=mix)
            last = it == args.iters - 1
            if args.eval_every and (it % args.eval_every == 0 or last):
                m = {**m, **iterate_fn.eval_fn(policy, draws)}
            if it % 5 == 0 or last:
                write_metrics(log, m, iter=it, dagger_mix=round(mix, 3),
                              wall_s=round(time.time() - t0, 1))
            if (it + 1) % 50 == 0 or last:
                ckpt_lib.archive_params(archive, policy.state_dict())


if __name__ == "__main__":
    main()
