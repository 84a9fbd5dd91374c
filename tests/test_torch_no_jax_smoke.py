"""`chip_smoke.py --device cpu --small` runs whole without the JAX stack
(see tests/test_torch_no_jax.py): the Roach rollout, the tiny student's
closed loop with the pillar and with the sparse LiDAR encoder, the three
evaluator phases, the training phases (collection, 3 steps of
loop.train, the archive read back), the expert's training
phases (PPO, BC and its probe), the multi-process phases (the dry run, the
data-parallel step, the sharded rollout), the imported town's phases (the
town compiled and cached, its rollout, the reference export) and the
Longest6 evaluation, to exit 0 and its last line, with jax, flax, optax,
orbax, msgpack, ninja, triton and the JAX package blocked in it and in
every process it starts; nothing reaches torch.utils.cpp_extension."""

import json

from test_torch_no_jax import BLOCKED, run_blocked

SCRIPT = f"""
import sys, runpy
assert all(sys.modules.get(name, 0) is None for name in {BLOCKED!r})
sys.argv = ["chip_smoke.py", "--device", "cpu", "--small"]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
finally:
    print("cpp_extension loaded:", "torch.utils.cpp_extension" in sys.modules, flush=True)
"""


def test_port_and_smoke_run_without_jax_stack(tmp_path):
    proc = run_blocked(tmp_path, SCRIPT, timeout=400)
    lines = proc.stdout.strip().splitlines()
    for tag in ("[eval card vs cpu] autopilot", "[eval card vs cpu] expert", "[eval expert]",
                "[eval student]", "[train collect]", "[train step] 3:", "[train checkpoint]",
                "[ppo iterate] 0:", "[ppo card vs cpu]", "[bc iterate]", "[bc probe]",
                "[bc card vs cpu]", "[ddp step]", "[ddp dryrun] frozen",
                "[worlds sharded] rank 1", "[town import] 2 worlds x 4 ticks",
                "[reference export] 1 world x 7 frames", "[longest6]", "[phase seconds]",
                "[sparse student] 2 worlds x 1 ticks", "[sparse lidar]"):
        assert any(line.startswith(tag) for line in lines), tag
    assert any(line.startswith("[rollout] ") for line in lines)
    assert any(line.startswith("[student] 2 worlds x 4 ticks") for line in lines)
    assert any(line.startswith("[train checkpoint]") and "bit for bit True" in line
               for line in lines)
    # the smoke's dry run over two gloo ranks (the other line of the two:
    # tests/test_torch_no_jax_trainers.py)
    assert sum(line.startswith("dryrun_multigpu OK: 2 ranks, loss=") for line in lines) == 1
    assert "cpp_extension loaded: False" in lines
    last = json.loads(lines[-2])
    assert last == {"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}}
