"""The PyTorch port's entry points run without the JAX stack (see
tests/test_torch_no_jax.py): `python -m thinktwice_tpu_torch.cli evaluate
--device cpu` scores two routes, `cli collect --device cpu` writes a batch
of 5 frames, and `python -m thinktwice_tpu_torch.bench --device cpu` prints
its record at a tiny size, in one interpreter with jax, flax, optax, orbax,
msgpack, ninja, triton and the JAX package blocked."""

import json

from test_torch_no_jax import BLOCKED, CPP_EXT, run_blocked

SCRIPT = f"""
import sys, runpy, tempfile
assert all(sys.modules.get(name, 0) is None for name in {BLOCKED!r})
sys.argv = ["cli", "evaluate", "--device", "cpu", "--n-routes", "2", "--batch", "2",
            "--vehicles", "2", "--route-len", "64"]
runpy.run_module("thinktwice_tpu_torch.cli", run_name="__main__")
with tempfile.TemporaryDirectory() as tmp:
    sys.argv = ["cli", "collect", "--device", "cpu", "--frames", "5", "--vehicles", "2",
                "--route-len", "256", "--out", tmp]
    runpy.run_module("thinktwice_tpu_torch.cli", run_name="__main__")
    import torch
    batch = torch.load(tmp + "/batch.pt", weights_only=True)
    print("collected batch", tuple(batch["imgs"].shape), flush=True)
sys.argv = ["bench", "--device", "cpu", "--worlds", "2", "--steps", "4"]
runpy.run_module("thinktwice_tpu_torch.bench", run_name="__main__")
{CPP_EXT}
"""


def test_cli_and_bench_run_without_jax_stack(tmp_path):
    proc = run_blocked(tmp_path, SCRIPT, timeout=300)
    lines = proc.stdout.strip().splitlines()
    scores = json.loads(proc.stdout[proc.stdout.index("{"):proc.stdout.index("}") + 1])
    assert set(scores) == {"score_route", "score_penalty", "score_composed"}
    assert "collected batch (1, 1, 4, 256, 512, 3)" in lines
    bench = next(json.loads(line) for line in lines if line.startswith('{"metric"'))
    assert bench["metric"] == "env_steps_per_sec_2worlds_roach_grid"
    assert lines[lines.index(json.dumps(bench)) + 1] == "cpu"
    assert lines[-1] == "cpp_extension loaded: False"
