"""Training driver of the student (counterpart of `thinktwice_tpu/train/loop.py`).

`collect_stream` is the data: B worlds driven by the Roach expert, their
sensors rendered on the card, each chunk of frames turned into one training
batch; a world whose route is done resets onto the next route, round
robin. `train` runs the optimizer steps over that stream, with optional
mirror and IDA augmentation, reuse of a chunk for several steps, a JSONL
log, train-state checkpoints and the `params.msgpack` archive beside them,
and resume (from the checkpoint directory, else from the archive with a
fresh optimizer state).

`make_model` builds the student with uninitialized parameters (on the meta
device, then allocated on the target device, so no RNG is read), as a flax
module is a definition without parameters; `init_model_params` gives them
flax's initial values from an explicit generator: lecun_normal kernels,
zero biases, unit norm scales and truncated normals of 0.02 for the
embeddings.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Iterator

import torch

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.models import rig as rig_lib
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel, total_loss
from thinktwice_tpu_torch.sim.reset import reset_world
from thinktwice_tpu_torch.sim.state import tree_map
from thinktwice_tpu_torch.train import checkpoint as ckpt_lib
from thinktwice_tpu_torch.train.augment import ida_augment, maybe_mirror
from thinktwice_tpu_torch.train.collect import collect_batch, frames_to_batch
from thinktwice_tpu_torch.train.train_step import create_train_state, make_train_step

TRUNC_STD = 0.87962566103423978   # std of a standard normal truncated to [-2, 2]


def make_model(cfg: Config, backbone_depth: int = 50, n_sweeps: int = 1,
               device="cuda") -> ThinkTwiceModel:
    """The student with parameters allocated on `device` and not yet set:
    load a state_dict into it or call init_model_params. Batch norms' running
    statistics (the sparse LiDAR encoder's) start at 0 and 1."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = ThinkTwiceModel(cfg.model, backbone_depth=backbone_depth,
                                n_sweeps=n_sweeps, n_cams=cfg.camera.n_cams)
    model = model.to_empty(device=device)
    for m in model.modules():
        if hasattr(m, "reset_running_stats"):
            m.reset_running_stats()
    return model


def model_forward(cfg: Config, model: ThinkTwiceModel):
    """-> forward(batch) -> the model's outputs on a training batch, the
    teacher pass included, with the rig of cfg.camera."""
    dev = next(model.parameters()).device
    c2e = torch.as_tensor(rig_lib.cam_to_ego(cfg.camera), device=dev)
    K = torch.as_tensor(rig_lib.intrinsics(cfg.camera), device=dev)
    e2i = torch.as_tensor(rig_lib.ego_to_img(cfg.camera), device=dev)

    def forward(batch):
        return model(batch["imgs"], batch["points"], batch["points_mask"], batch["speed"],
                     batch["target_point"], batch["command"], c2e, K, e2i,
                     batch.get("teacher_wp"), batch.get("teacher_ctrl_sp"),
                     sweep2key=batch.get("sweep2key"), ida=batch.get("ida"))

    return forward


def model_loss_fn(cfg: Config, model: ThinkTwiceModel, group=None):
    """-> loss_fn(batch) -> (loss, metrics): the model's forward with the
    teacher pass and total_loss (with a process group: this rank's share
    of the global batch's loss)."""
    forward = model_forward(cfg, model)

    def loss_fn(batch):
        return total_loss(cfg.model, forward(batch), batch, group)

    return loss_fn


def _truncated_normal(shape, std: float, generator, device):
    """Normals truncated to [-2, 2], times std, by the inverse CDF."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo
    x = math.sqrt(2) * torch.erfinv(u)
    return torch.clamp(x, -2.0, 2.0) * std


@torch.no_grad()
def init_model_params(cfg: Config, model: torch.nn.Module,
                      generator: torch.Generator) -> dict:
    """Set every parameter to flax's initial value, drawn from generator
    (on the model's device). -> the parameters by name."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "weight" and p.dim() == 1:          # GroupNorm / LayerNorm scale
            p.fill_(1.0)
        elif leaf == "weight":                           # lecun_normal, fan_in
            fan_in = math.prod(p.shape[1:])
            p.copy_(_truncated_normal(p.shape, math.sqrt(1.0 / fan_in) / TRUNC_STD,
                                      generator, p.device))
        else:                                            # embeddings
            p.copy_(_truncated_normal(p.shape, 0.02, generator, p.device))
    return dict(model.named_parameters())


def collect_stream(cfg: Config, policy, town: TownMap, routes,
                   generator: torch.Generator, frames_per_chunk: int = 16,
                   n_vehicles: int = 8, n_sweeps: int = 1, n_worlds: int = 1,
                   scenarios=None) -> Iterator[dict]:
    """Endless training batches from the expert's rollouts: each yield
    collects frames_per_chunk frames of n_worlds worlds (each on its own
    route) and gives n_worlds x (frames_per_chunk - pred_len - (n_sweeps -
    1)) examples. World states persist across chunks; a world resets, onto
    the next of routes (NR, R, 3) round robin, once its criteria report
    done. Every random number (spawns, steps, sensors) comes from
    generator. scenarios: an optional (NR,)-stacked ScenarioState bank."""
    NR = routes.shape[0]
    next_route = 0

    def fresh_states(done=None):
        nonlocal next_route
        idxs = []
        for i in range(n_worlds):
            if done is None or done[i]:
                idxs.append(next_route % NR)
                next_route += 1
            else:
                idxs.append(0)        # discarded by the merge below
        ids = torch.tensor(idxs, device=routes.device)
        scen = None if scenarios is None else tree_map(lambda x: x[ids], scenarios)
        return reset_world(cfg, town, routes[ids], n_vehicles=n_vehicles, scenario=scen,
                           generator=generator)

    states = fresh_states()
    while True:
        done = states.criteria.done.cpu()
        if bool(done.any()):
            fresh = fresh_states(done.tolist())
            mask = done.to(routes.device)
            states = tree_map(
                lambda f, s: torch.where(mask.reshape(-1, *([1] * (f.dim() - 1))), f, s),
                fresh, states)
        states, frames, sensors = collect_batch(cfg, policy, town, states, frames_per_chunk,
                                                generator=generator)
        yield frames_to_batch(cfg, frames, sensors, cfg.model.pred_len, n_sweeps=n_sweeps)


def make_eval_fn(cfg: Config, model: ThinkTwiceModel):
    """Validation: the same losses over val batches without gradients,
    averaged. -> evaluate(val_batches) -> {"val_<term>": mean}."""
    loss_fn = model_loss_fn(cfg, model)

    @torch.no_grad()
    def evaluate(val_batches) -> dict:
        acc: dict = {}
        n = 0
        for batch in val_batches:
            _, m = loss_fn(batch)
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + float(v)
            n += 1
        return {f"val_{k}": v / max(n, 1) for k, v in acc.items()}

    return evaluate


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: Config, model: ThinkTwiceModel, batches: Iterator[dict], n_steps: int,
          ckpt_dir: str | None = None, log_path: str | None = None, resume: bool = False,
          params: dict | None = None, log_every: int = 10, ckpt_every: int = 500,
          val_batches_fn=None, eval_every: int = 500, augment_mirror: bool = False,
          augment_ida: bool = False, reuse_batches: int = 1):
    """Run n_steps optimizer steps over the batch stream -> TrainState.

    params: a state_dict to start from (else flax's init from
    cfg.train.seed). reuse_batches > 1 runs that many steps on each
    collected chunk (fresh augmentation each time). Each log line (JSONL) is
    the step's metrics with step, wall_s, collect_s and grad_s. A checkpoint
    and the archive `params.msgpack` beside ckpt_dir are written every
    ckpt_every steps and at the end."""
    dev = next(model.parameters()).device
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
        init_model_params(cfg, model, gen)
    else:
        model.load_state_dict(params, strict=True)
    state = create_train_state(cfg, dict(model.named_parameters()))
    archive = (os.path.join(os.path.dirname(os.path.abspath(ckpt_dir)), "params.msgpack")
               if ckpt_dir else None)
    if resume and ckpt_dir:
        try:
            state = ckpt_lib.restore_train_state(ckpt_dir, state)
            print(f"resumed from step {state.step}")
        except FileNotFoundError:
            # a checkpoint directory does not survive a fresh clone; the
            # archive beside it may
            if os.path.exists(archive):
                model.load_state_dict(ckpt_lib.restore_archive(archive, model))
                state = create_train_state(cfg, dict(model.named_parameters()))
                print(f"no checkpoint in {ckpt_dir}; resumed params from {archive} "
                      "(fresh optimizer state)")
            else:
                print(f"no checkpoint in {ckpt_dir} and no params.msgpack archive; "
                      "starting from scratch")

    step_fn = make_train_step(cfg, model_loss_fn(cfg, model))
    aug_gen = torch.Generator(device=dev).manual_seed(cfg.train.seed + 1)
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    logf = open(log_path, "a") if log_path else None
    try:
        t0 = time.time()
        collect_s = grad_s = 0.0
        raw_batch = None
        for i in range(n_steps):
            tc = time.time()
            if raw_batch is None or i % max(reuse_batches, 1) == 0:
                raw_batch = next(batches)
                _sync(dev)
            batch = raw_batch
            collect_s += time.time() - tc
            tg = time.time()
            if augment_mirror:
                batch = maybe_mirror(batch, generator=aug_gen)
            if augment_ida:
                batch = ida_augment(batch, generator=aug_gen)
            state, metrics = step_fn(state, batch)
            _sync(dev)
            grad_s += time.time() - tg
            if (i + 1) % log_every == 0 or i == 0:
                host = {k: round(float(v), 5) for k, v in metrics.items()}
                host.update(step=state.step, wall_s=round(time.time() - t0, 1),
                            collect_s=round(collect_s, 1), grad_s=round(grad_s, 1))
                _log(json.dumps(host), logf)
            if ckpt_dir and state.step % ckpt_every == 0:
                ckpt_lib.save_train_state(ckpt_dir, state)
                ckpt_lib.archive_params(archive, state.params)
            if val_batches_fn is not None and state.step % eval_every == 0:
                ev = make_eval_fn(cfg, model)(val_batches_fn())
                _log(json.dumps({**ev, "step": state.step}), logf)
        if ckpt_dir:
            ckpt_lib.save_train_state(ckpt_dir, state)
            ckpt_lib.archive_params(archive, state.params)
    finally:
        if logf:
            logf.close()
    return state


def _log(line: str, logf) -> None:
    print(line, flush=True)
    if logf:
        logf.write(line + "\n")
        logf.flush()
