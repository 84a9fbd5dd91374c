"""The data-parallel dry run of thinktwice_tpu_torch and its launcher.

- `thinktwice_tpu_torch.dryrun`'s shapes are `__graft_entry__`'s
  `_DRYRUN_FROZEN` and `_DRYRUN_MID`.
- `python -m thinktwice_tpu_torch.dryrun --nproc 2 --device cpu` spawns two
  gloo ranks, takes one train step of the frozen-shape student over them,
  prints `dryrun_multigpu OK: 2 ranks, loss=...` and its JSON line, with
  both ranks' losses equal.
- The launcher falls back to nothing: without a card it refuses NCCL, the
  default one-card-a-rank layout and a CUDA rank; it refuses two NCCL ranks
  on one card, and init_group outside torchrun without a rank.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

import __graft_entry__ as ge
from thinktwice_tpu_torch import dryrun
from thinktwice_tpu_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_shapes_are_the_jax_dry_runs():
    assert dryrun._DRYRUN_FROZEN == ge._DRYRUN_FROZEN
    assert dryrun._DRYRUN_MID == ge._DRYRUN_MID
    cfg = dryrun.dryrun_config(dryrun._DRYRUN_MID)
    assert (cfg.camera.n_cams, cfg.camera.height, cfg.camera.width) == (4, 128, 256)
    assert cfg.camera.cam_yaws == (0.0, -90.0, 90.0, 180.0)
    assert dryrun.dryrun_config(dryrun._DRYRUN_FROZEN).camera.cam_yaws == (0.0, 180.0)


def test_dryrun_command_on_two_cpu_ranks():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "thinktwice_tpu_torch.dryrun", "--nproc", "2",
                           "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    ok = [line for line in lines if line.startswith("dryrun_multigpu OK: 2 ranks, loss=")]
    assert len(ok) == 1, lines
    doc = json.loads(lines[-1])
    assert doc["ok"] is True and doc["devices"] == 2 and doc["shapes"] == ge._DRYRUN_FROZEN
    assert math.isfinite(doc["loss"]) and ok[0].endswith(f"loss={doc['loss']:.4f}")


def test_launcher_has_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards"):
        launch.spawn(dryrun.dryrun_rank, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.init_group(0, 1, device="cuda:0")
    with pytest.raises(ValueError, match="NCCL needs a card"):
        launch.init_group(0, 1, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="one rank per card"):
        launch.spawn(dryrun.dryrun_rank, 2, devices=["cuda:0", "cuda:0"], backend="nccl")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch.init_group()
