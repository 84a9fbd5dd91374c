"""Command line of the port: evaluate and benchmark (counterpart of
`thinktwice_tpu/cli.py`; its collect and train wait for the training
slice).

    python -m thinktwice_tpu_torch.cli evaluate --routes <xml> --agent autopilot
    python -m thinktwice_tpu_torch.cli evaluate --device cpu --n-routes 2 --route-len 64
    python -m thinktwice_tpu_torch.cli benchmark

Entry points run on the card unless --device cpu asks for the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _build_world(args):
    from thinktwice_tpu_torch import resolve_device
    from thinktwice_tpu_torch.config import Config, SimConfig
    from thinktwice_tpu_torch.maps.procedural import make_grid_town

    cfg = Config(
        sim=SimConfig(
            max_vehicles=args.vehicles if args.vehicles > 0 else 32,
            max_walkers=16,
            max_route_len=args.route_len,
            max_scenarios=16,
        )
    )
    town = make_grid_town(n_blocks=args.blocks, block=100.0,
                          device=resolve_device(args.device))
    return cfg, town


def cmd_evaluate(args):
    from thinktwice_tpu_torch.agents.autopilot import autopilot_control
    from thinktwice_tpu_torch.harness.evaluator import build_route_scenarios, evaluate_routes
    from thinktwice_tpu_torch.harness.route_parser import (
        match_scenarios_to_route,
        parse_routes_file,
        parse_scenarios_file,
    )
    from thinktwice_tpu_torch.harness.statistics import PENALTY_STOP

    if args.agent != "autopilot":
        raise SystemExit(f"unknown agent {args.agent!r}: the CLI drives the autopilot")
    cfg, town = _build_world(args)

    scenarios = None
    if args.routes:
        specs = parse_routes_file(args.routes)
        routes = [s.dense(spacing=1.0) for s in specs]
        ids = [s.route_id for s in specs]
        if args.scenarios:
            scenarios = []
            for spec, dense in zip(specs, routes):
                trigs = parse_scenarios_file(args.scenarios, spec.town)
                matched = match_scenarios_to_route(trigs, dense)
                scenarios.append(build_route_scenarios(cfg, dense, matched,
                                                       device=town.device))
    else:
        # built-in smoke routes on the procedural town
        routes, ids = [], []
        for i in range(args.n_routes):
            xs = np.linspace(5.0, 180.0, 256)
            y = 98.25 if i % 2 == 0 else 198.25
            routes.append(
                np.stack([xs, np.full_like(xs, y), np.zeros_like(xs)], 1)
            )
            ids.append(str(i))

    g = evaluate_routes(
        cfg, town, routes, ids,
        policy_fn=autopilot_control,
        n_vehicles=args.vehicles,
        worlds_per_batch=args.batch,
        out_path=args.out,
        resume=args.resume,
        stop_penalty=1.0 if args.benchmark == "longest6" else PENALTY_STOP,
        seed=args.seed,
        scenarios=scenarios,
    )
    print(json.dumps(g["scores"], indent=2))


def cmd_benchmark(args):
    from thinktwice_tpu_torch import bench

    bench.main(["--device", args.device])


def main(argv=None):
    p = argparse.ArgumentParser(prog="thinktwice_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("evaluate")
    e.add_argument("--vehicles", type=int, default=16)
    e.add_argument("--blocks", type=int, default=2)
    e.add_argument("--route-len", type=int, default=1024)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--routes", default=None, help="route XML (reference format)")
    e.add_argument("--scenarios", default=None,
                   help="scenario JSON (reference format)")
    e.add_argument("--agent", default="autopilot")
    e.add_argument("--n-routes", type=int, default=4)
    e.add_argument("--batch", type=int, default=4)
    e.add_argument("--out", default=None)
    e.add_argument("--resume", action="store_true")
    e.add_argument("--benchmark", default="town05long")
    e.add_argument("--device", default="cuda")
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("benchmark")
    b.add_argument("--device", default="cuda")
    b.set_defaults(fn=cmd_benchmark)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
