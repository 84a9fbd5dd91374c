"""The PyTorch port's trainers run without the JAX stack (see
tests/test_torch_no_jax.py): the expert trainers' scripts
(`scripts.train_roach_ppo` with the fine-tune options, `scripts.train_bc`)
take two iterations each with --device cpu and write their metrics and a
params.msgpack the port reads back; `python -m thinktwice_tpu_torch.dryrun
--nproc 2 --device cpu` takes a step over two gloo ranks, whose processes
find the same modules blocked."""

import json

from test_torch_no_jax import BLOCKED, CPP_EXT, run_blocked

SCRIPT = f"""
import sys, runpy, tempfile
assert all(sys.modules.get(name, 0) is None for name in {BLOCKED!r})
with tempfile.TemporaryDirectory() as tmp:
    sys.argv = ["train_roach_ppo", "--device", "cpu", "--envs", "2", "--steps", "4",
                "--iters", "2", "--vehicles", "2", "--minibatch", "8", "--epochs", "1",
                "--policy-every", "2", "--init", "runs/roach_bc5/params.msgpack",
                "--anchor", "0.05", "--lr", "3e-5", "--scenarios", "--out", tmp + "/ppo"]
    runpy.run_module("thinktwice_tpu_torch.scripts.train_roach_ppo", run_name="__main__")
    sys.argv = ["train_bc", "--device", "cpu", "--envs", "2", "--steps", "8", "--iters", "2",
                "--vehicles", "2", "--minibatch", "8", "--epochs", "1", "--routes", "4",
                "--eval-envs", "2", "--eval-steps", "8", "--eval-every", "1", "--scenarios",
                "--out", tmp + "/bc"]
    runpy.run_module("thinktwice_tpu_torch.scripts.train_bc", run_name="__main__")
    from thinktwice_tpu_torch.agents.roach import RoachPolicy
    from thinktwice_tpu_torch.config import Config
    from thinktwice_tpu_torch.train.checkpoint import restore_pytree
    for name in ("ppo", "bc"):
        lines = open(f"{{tmp}}/{{name}}/metrics.jsonl").read().splitlines()
        sd = restore_pytree(f"{{tmp}}/{{name}}/params.msgpack", RoachPolicy.from_config(Config()))
        print("trained", name, len(lines), "lines", len(sd), "tensors", flush=True)
sys.argv = ["dryrun", "--nproc", "2", "--device", "cpu"]
from thinktwice_tpu_torch import dryrun
assert dryrun.main() == 0
{CPP_EXT}
"""


def test_trainers_and_dryrun_run_without_jax_stack(tmp_path):
    proc = run_blocked(tmp_path, SCRIPT, timeout=400)
    lines = proc.stdout.strip().splitlines()
    assert "trained ppo 2 lines 32 tensors" in lines and "trained bc 2 lines 32 tensors" in lines
    ppo = [json.loads(line) for line in lines if line.startswith('{"anchor_kl"')]
    assert [r["iter"] for r in ppo] == [0, 1] and "env_steps" in ppo[0]
    bc = [json.loads(line) for line in lines if line.startswith('{"action_mae"')]
    assert [r["iter"] for r in bc] == [0, 1] and "cl_completion" in bc[0]
    # one of the two lines the blocked interpreters print; the smoke's dry run
    # prints the other (tests/test_torch_no_jax_smoke.py)
    assert sum(line.startswith("dryrun_multigpu OK: 2 ranks, loss=") for line in lines) == 1
    assert lines[-1] == "cpp_extension loaded: False"
