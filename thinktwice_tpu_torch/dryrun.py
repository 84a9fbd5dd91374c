"""The data-parallel dry run: one train step of the ThinkTwice student over a
process group (the counterpart of `__graft_entry__.dryrun_multichip` and
`scripts/dryrun_midshape.py`).

Every rank builds the same model and zero batch as the JAX dry run (one
sample a rank, the teacher pass, total_loss), takes rank 0's parameters
(`replicate`), its rows of the batch (`shard_batch`) and one step of
`make_train_step(group=...)`; the step must be 1 and the loss finite.

    python -m thinktwice_tpu_torch.dryrun --nproc 2 --device cpu      # gloo on the CPU
    python -m thinktwice_tpu_torch.dryrun --nproc 4 --shapes mid      # NCCL, a card a rank
    torchrun --nproc-per-node 4 -m thinktwice_tpu_torch.dryrun        # the same under torchrun

Rank 0 prints `dryrun_multigpu OK: n ranks, loss=...`, then the run's JSON
line (the shapes, the ranks, the wall seconds). Nothing is written to disk.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from thinktwice_tpu_torch.config import CameraConfig, Config, ModelConfig
from thinktwice_tpu_torch.parallel.launch import Group, close_group, init_group, spawn

# Copies of __graft_entry__'s dry-run shapes: the frozen toy pin, and the
# half-flagship (ResNet-50, 4 cameras, 5 refine layers, 128 x 256 images).
_DRYRUN_FROZEN = {
    "img_height": 32,
    "img_width": 64,
    "refine_num": 1,
    "pred_len": 2,
    "bev_channels": 64,
    "n_depth_bins": 16,
    "lidar_pillar_grid": 84,
    "n_z_anchors": 5,
    "n_attn_heads": 4,
    "n_cams": 2,
    "backbone": 10,
    "n_points": 128,
}

_DRYRUN_MID = {
    "img_height": 128,
    "img_width": 256,
    "refine_num": 5,
    "pred_len": 4,
    "bev_channels": 256,
    "n_depth_bins": 40,
    "lidar_pillar_grid": 168,
    "n_z_anchors": 15,
    "n_attn_heads": 8,
    "n_cams": 4,
    "backbone": 50,
    "n_points": 512,
}

SHAPES = {"frozen": _DRYRUN_FROZEN, "mid": _DRYRUN_MID}


def dryrun_config(fz: dict) -> Config:
    """The model and camera configuration of a dry-run shape dict."""
    model = ModelConfig(**{k: fz[k] for k in (
        "img_height", "img_width", "refine_num", "pred_len", "bev_channels", "n_depth_bins",
        "lidar_pillar_grid", "n_z_anchors", "n_attn_heads")})
    n = fz["n_cams"]
    camera = CameraConfig(height=fz["img_height"], width=fz["img_width"], n_cams=n,
                          cam_yaws=(0.0, 180.0) if n == 2 else (0.0, -90.0, 90.0, 180.0)[:n])
    return Config(model=model, camera=camera)


def zero_batch(cfg: Config, n_points: int, B: int, device) -> dict:
    """The JAX dry run's batch of B examples: zero inputs and targets, unit
    Beta targets, every point valid."""
    m, N = cfg.model, cfg.camera.n_cams
    T, H, W = m.pred_len, m.img_height, m.img_width

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def one(*shape):
        return torch.ones(shape, device=device)

    return {
        "imgs": z(B, 1, N, H, W, 3), "points": z(B, n_points, 5),
        "points_mask": torch.ones((B, n_points), dtype=torch.bool, device=device),
        "speed": z(B), "target_point": z(B, 2), "command": z(B, 6),
        "teacher_wp": z(B, T, 2), "teacher_ctrl_sp": one(B, T, 4),
        "gt_waypoints": z(B, T, 2), "action_alpha": one(B, 2), "action_beta": one(B, 2),
        "future_action_alpha": one(B, T - 1, 2), "future_action_beta": one(B, T - 1, 2),
        "gt_speed": z(B), "gt_value": z(B), "roach_features": z(B, 256),
        "roach_cnn": (z(B, 21, 21, 32), z(B, 10, 10, 64), z(B, 4, 4, 128), z(B, 2, 2, 256)),
        "future_roach_cnn21": z(B, T, 21, 21, 32),
        "gt_depth": z(B * N, H, W),
        "gt_seg": z(B * N, H // 4, W // 4, dtype=torch.int64),
    }


def dryrun_rank(group: Group, fz: dict) -> dict:
    """One rank of the dry run. -> its loss, seconds and peak memory."""
    from thinktwice_tpu_torch.train import loop
    from thinktwice_tpu_torch.train.train_step import (
        create_train_state, make_train_step, replicate, shard_batch)

    dev = group.device
    t0 = time.perf_counter()
    cfg = dryrun_config(fz)
    model = loop.make_model(cfg, backbone_depth=fz["backbone"], n_sweeps=1, device=dev)
    loop.init_model_params(cfg, model, torch.Generator(device=dev).manual_seed(group.rank))
    state = replicate(group, create_train_state(cfg, dict(model.named_parameters())))
    batch = shard_batch(group, zero_batch(cfg, fz["n_points"], group.size, dev))
    init_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    step = make_train_step(cfg, loop.model_loss_fn(cfg, model, group), group=group)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t1
    if state.step != 1 or not torch.isfinite(metrics["loss"]):
        raise RuntimeError(f"rank {group.rank}: step {state.step}, loss {loss}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None
    if group.rank == 0:
        print(f"dryrun: rank 0 init in {init_s:.1f}s, train step in {step_s:.1f}s", flush=True)
        print(f"dryrun_multigpu OK: {group.size} ranks, loss={loss:.4f}", flush=True)
    return {"loss": loss, "init_s": init_s, "step_s": step_s, "peak_gib": peak}


def dryrun_multigpu(n: int, shapes: dict | None = None, device: str = "cuda",
                    timeout: float = 900.0) -> list[dict]:
    """Spawn n ranks and run the dry run on each (default shapes:
    _DRYRUN_FROZEN). device "cuda": rank r on cuda:r (NCCL); "cpu": n gloo
    ranks on the CPU; a card such as "cuda:0": every rank on it (gloo).
    -> each rank's result."""
    if device == "cuda":
        return spawn(dryrun_rank, n, args=(shapes or _DRYRUN_FROZEN,), timeout=timeout)
    return spawn(dryrun_rank, n, args=(shapes or _DRYRUN_FROZEN,), backend="gloo",
                 devices=[device] * n, timeout=timeout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks to spawn (default: run as one rank of torchrun's group)")
    ap.add_argument("--shapes", choices=sorted(SHAPES), default="frozen")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a rank, NCCL), cpu, or one card such as cuda:0 "
                         "(gloo ranks sharing it)")
    args = ap.parse_args()
    fz = SHAPES[args.shapes]
    t0 = time.perf_counter()
    if args.nproc is None:
        if "RANK" not in os.environ:
            ap.error("pass --nproc N, or run under torchrun")
        shared = args.device != "cuda"          # the CPU, or one card for every rank
        group = init_group(device=args.device if shared else None,
                           backend="gloo" if shared else None)
        try:
            results = [dryrun_rank(group, fz)]
        finally:
            close_group()
        if group.rank != 0:
            return 0
        n = group.size
    else:
        results = dryrun_multigpu(args.nproc, fz, args.device)
        n = args.nproc
    doc = {"ok": True, "devices": n, "device": args.device, "shapes": fz,
           "loss": results[0]["loss"], "wall_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
