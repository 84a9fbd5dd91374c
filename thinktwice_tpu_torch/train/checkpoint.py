"""Checkpoints of training (counterpart of `thinktwice_tpu/train/checkpoint.py`).

- `archive_params` / `restore_archive`: the single-file parameter archive of
  the student or the Roach policy in flax's msgpack format
  (`params.msgpack`), written with `weights.packb` and read with
  `weights.load_flax_msgpack`, so the JAX package and flax read the port's
  archives and the port reads theirs. The write is an
  atomic replace: a killed trainer leaves the old archive whole.
- `save_train_state` / `restore_train_state`: step, parameters and the
  optimizer's moments, one `torch.save` file per step in the checkpoint
  directory (`step_<n>.pt`), the newest `MAX_TO_KEEP` kept.
- `save_pytree` / `restore_pytree`: any tree of tensors with `torch.save`;
  `restore_pytree` also takes a `.msgpack` archive.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from thinktwice_tpu_torch.agents.roach import RoachPolicy
from thinktwice_tpu_torch.train.train_step import AdamState, TrainState
from thinktwice_tpu_torch.weights import (
    flax_tree_from_roach_state_dict,
    flax_tree_from_student_state_dict,
    load_flax_msgpack,
    packb,
    roach_state_dict_from_flax,
    student_state_dict_from_flax,
)

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
MAX_TO_KEEP = 5


def _atomic_write(path: str, write) -> None:
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := _STEP_FILE.match(f)))


def save_train_state(ckpt_dir: str, state: TrainState) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    blob = {
        "step": state.step,
        "params": {k: v.detach().cpu() for k, v in state.params.items()},
        "opt_state": {"count": state.opt_state.count,
                      "mu": {k: v.cpu() for k, v in state.opt_state.mu.items()},
                      "nu": {k: v.cpu() for k, v in state.opt_state.nu.items()}},
    }
    _atomic_write(os.path.join(ckpt_dir, f"step_{state.step}.pt"),
                  lambda tmp: torch.save(blob, tmp))
    for old in _steps(ckpt_dir)[:-MAX_TO_KEEP]:
        os.remove(os.path.join(ckpt_dir, f"step_{old}.pt"))


def restore_train_state(ckpt_dir: str, template: TrainState) -> TrainState:
    """The newest snapshot into template's tensors (in place, on their
    devices); raises FileNotFoundError when there is none."""
    steps = _steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    blob = torch.load(os.path.join(ckpt_dir, f"step_{steps[-1]}.pt"),
                      map_location="cpu", weights_only=True)
    with torch.no_grad():
        for name, p in template.params.items():
            p.copy_(blob["params"][name])
    opt = blob["opt_state"]

    def on(tree):
        return {k: v.to(template.params[k].device) for k, v in tree.items()}

    return TrainState(step=int(blob["step"]), params=template.params,
                      opt_state=AdamState(count=int(opt["count"]), mu=on(opt["mu"]),
                                          nu=on(opt["nu"])))


def archive_params(path: str, params: dict, cast_floats: torch.dtype | None = None) -> None:
    """ThinkTwiceModel or RoachPolicy parameters (state_dict tensors, by
    name) -> a flax msgpack archive. The leaves are float32 unless
    cast_floats names another float type: with torch.bfloat16 each leaf is
    rounded to nearest even and written under the dtype name "bfloat16",
    as flax writes an ml_dtypes bfloat16 array (a smaller archive that
    knowingly loses precision)."""
    if "features_extractor.linear0.weight" in params:
        tree = flax_tree_from_roach_state_dict(params)
    else:
        tree = flax_tree_from_student_state_dict(params)
    if cast_floats is not None:
        tree = _cast_leaves(tree, cast_floats)
    data = packb(tree)

    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)

    _atomic_write(path, write)


def _cast_leaves(tree, dtype: torch.dtype):
    """The float leaves of a tree of numpy arrays cast to dtype: torch
    bfloat16 tensors (numpy has none), numpy arrays for any other type."""
    if isinstance(tree, dict):
        return {k: _cast_leaves(v, dtype) for k, v in tree.items()}
    if not np.issubdtype(tree.dtype, np.floating):
        return tree
    cast = torch.from_numpy(np.ascontiguousarray(tree)).to(dtype)
    return cast if dtype == torch.bfloat16 else cast.numpy()


def restore_archive(path: str, template: torch.nn.Module) -> dict:
    """A flax msgpack archive -> the state_dict of template (a
    ThinkTwiceModel or a RoachPolicy), in template's dtypes."""
    tree = load_flax_msgpack(path)
    if isinstance(template, RoachPolicy):
        sd = roach_state_dict_from_flax(
            tree, n_states=len(template.features_extractor.states),
            n_policy=len(template.policy_head), n_value=len(template.value_head),
            n_convs=len(template.features_extractor.convs))
    else:
        sd = student_state_dict_from_flax(tree, template)
    want = template.state_dict()
    return {k: v.to(want[k].dtype) for k, v in sd.items()}


def save_pytree(path: str, tree) -> None:
    _atomic_write(path, lambda tmp: torch.save(tree, tmp))


def restore_pytree(path: str, template=None):
    """A torch.save file, or with a `.msgpack` path the archive into
    template's structure (restore_archive)."""
    if path.endswith(".msgpack"):
        return restore_archive(path, template)
    return torch.load(path, map_location="cpu", weights_only=True)
