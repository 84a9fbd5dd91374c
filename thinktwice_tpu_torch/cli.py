"""Command line of the port: evaluate, collect, train and benchmark
(counterpart of `thinktwice_tpu/cli.py`).

    python -m thinktwice_tpu_torch.cli evaluate --routes <xml> --agent autopilot
    python -m thinktwice_tpu_torch.cli evaluate --device cpu --n-routes 2 --route-len 64
    python -m thinktwice_tpu_torch.cli collect --frames 32 --out data/run0
    python -m thinktwice_tpu_torch.cli train --steps 100 --ckpt-dir ckpts \
        --roach-ckpt runs/roach_rl6/params.msgpack
    python -m thinktwice_tpu_torch.cli benchmark

`collect` drives a Roach expert (random weights from seed 0, as the JAX
CLI's) on one straight route of the grid town and writes the training batch
with torch.save (`<out>/batch.pt`). `train` trains a student from a fresh
init on batches collected in the loop from two routes, the expert from
--roach-ckpt (a flax `.msgpack` archive or a torch.save state_dict) or
random.

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


def _grid_route(y: float) -> np.ndarray:
    xs = np.linspace(5.0, 180.0, 256)
    return np.stack([xs, np.full_like(xs, y), np.zeros_like(xs)], 1).astype(np.float32)


def _roach(cfg, device, ckpt=None):
    """The expert: a checkpoint's weights, or flax-style random ones from
    seed 0."""
    import torch

    from thinktwice_tpu_torch.agents.roach import RoachPolicy
    from thinktwice_tpu_torch.train.checkpoint import restore_pytree
    from thinktwice_tpu_torch.train.loop import init_model_params

    policy = RoachPolicy.from_config(cfg).to(device)
    if ckpt:
        policy.load_state_dict(restore_pytree(ckpt, policy))
    else:
        init_model_params(cfg, policy, torch.Generator(device=device).manual_seed(0))
    return policy.eval()


def cmd_collect(args):
    import os

    import torch

    from thinktwice_tpu_torch.sim.reset import reset_world
    from thinktwice_tpu_torch.train.checkpoint import save_pytree
    from thinktwice_tpu_torch.train.collect import collect_batch, frames_to_batch

    cfg, town = _build_world(args)
    policy = _roach(cfg, town.device)
    g = torch.Generator(device=town.device).manual_seed(args.seed)
    route = torch.as_tensor(_grid_route(98.25)[None], device=town.device)
    state = reset_world(cfg, town, route, n_vehicles=args.vehicles, generator=g)
    final, frames, sensors = collect_batch(cfg, policy, town, state, args.frames,
                                           generator=g)
    batch = frames_to_batch(cfg, frames, sensors)
    os.makedirs(args.out, exist_ok=True)
    save_pytree(os.path.join(args.out, "batch.pt"),
                {k: tuple(x.cpu() for x in v) if isinstance(v, tuple) else v.cpu()
                 for k, v in batch.items()})
    print(f"collected {args.frames} frames -> {args.out} "
          f"(completion {float(final.criteria.route_completion[0]):.2%})")


def cmd_train(args):
    import os

    import torch

    from thinktwice_tpu_torch.train.loop import collect_stream, make_model, train

    cfg, town = _build_world(args)
    policy = _roach(cfg, town.device, args.roach_ckpt)
    routes = torch.as_tensor(np.stack([_grid_route(98.25), _grid_route(198.25)]),
                             device=town.device)
    model = make_model(cfg, backbone_depth=args.backbone, device=town.device)
    batches = collect_stream(
        cfg, policy, town, routes,
        torch.Generator(device=town.device).manual_seed(cfg.train.seed),
        frames_per_chunk=args.frames_per_chunk, n_vehicles=args.vehicles)
    train(cfg, model, batches, n_steps=args.steps, ckpt_dir=args.ckpt_dir,
          log_path=os.path.join(args.ckpt_dir, "train.jsonl") if args.ckpt_dir else None,
          resume=args.resume)


def cmd_benchmark(args):
    from thinktwice_tpu_torch import bench

    bench.main(["--device", args.device])


def main(argv=None):
    p = argparse.ArgumentParser(prog="thinktwice_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--vehicles", type=int, default=16)
        sp.add_argument("--blocks", type=int, default=2)
        sp.add_argument("--route-len", type=int, default=1024)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda")

    e = sub.add_parser("evaluate")
    common(e)
    e.add_argument("--routes", default=None, help="route XML (reference format)")
    e.add_argument("--scenarios", default=None,
                   help="scenario JSON (reference format)")
    e.add_argument("--agent", default="autopilot")
    e.add_argument("--n-routes", type=int, default=4)
    e.add_argument("--batch", type=int, default=4)
    e.add_argument("--out", default=None)
    e.add_argument("--resume", action="store_true")
    e.add_argument("--benchmark", default="town05long")
    e.set_defaults(fn=cmd_evaluate)

    c = sub.add_parser("collect")
    common(c)
    c.add_argument("--frames", type=int, default=32)
    c.add_argument("--out", default="data/run0")
    c.set_defaults(fn=cmd_collect)

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--steps", type=int, default=100)
    t.add_argument("--ckpt-dir", default="ckpts")
    t.add_argument("--backbone", type=int, default=50)
    t.add_argument("--frames-per-chunk", type=int, default=12,
                   help="frames collected per chunk; batch = chunk - pred_len")
    t.add_argument("--roach-ckpt", default=None,
                   help="the expert's weights: a flax .msgpack archive or a torch.save file")
    t.add_argument("--resume", action="store_true")
    t.set_defaults(fn=cmd_train)

    b = sub.add_parser("benchmark")
    b.add_argument("--device", default="cuda")
    b.set_defaults(fn=cmd_benchmark)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
