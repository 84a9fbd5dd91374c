"""The PyTorch port runs without the JAX stack.

A machine with a card may have torch, numpy and the CUDA toolkit and none of
jax, flax, optax, orbax, msgpack, ninja or triton. In a subprocess where
those modules (and the JAX package) cannot be imported, every module of
thinktwice_tpu_torch imports; `python -m thinktwice_tpu_torch.cli evaluate
--device cpu` scores two routes, `cli collect --device cpu` writes a batch
of 5 frames and `python -m thinktwice_tpu_torch.bench --device cpu` prints
its record at a tiny size; `python -m thinktwice_tpu_torch.dryrun --nproc 2
--device cpu` takes a step over two gloo ranks, whose processes find the
same modules blocked; the expert trainers' scripts
(`scripts.train_roach_ppo` with the fine-tune options, `scripts.train_bc`)
take two iterations each with --device cpu and write their metrics and a
params.msgpack the port reads back; and `chip_smoke.py --device cpu
--small` runs to exit 0, the Roach rollout, the tiny student's closed
loop, the three evaluator phases, the training phases (collection, 3
steps of loop.train, the archive read back) and the expert's training
phases (PPO, BC and its probe), the multi-process phases (the dry run,
the data-parallel step, the sharded rollout) and the imported town's
phases (the town compiled and cached, its rollout, the reference export)
included; nothing reaches torch.utils.cpp_extension.

A second subprocess blocks h5py, PIL and cv2 as well, as the card machine
lacks them: there the planner is built from a town's rasters, a town is
compiled from arrays and goes through the town cache, the PNG codec writes
and reads each of its formats, one world collected on the compiled town is
exported in the reference's layout and `ReferenceDataset` reads it back
(images, depth and seg), and only `read_town_h5` fails, on its h5py import.
"""

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "optax", "orbax", "msgpack", "ninja", "triton",
           "thinktwice_tpu")

SCRIPT = f"""
import sys
import importlib, multiprocessing, pkgutil, runpy
assert all(sys.modules.get(name, 0) is None for name in {BLOCKED!r})
for name in ("jax", "thinktwice_tpu.config"):     # blocked in a spawned process too
    proc = multiprocessing.get_context("spawn").Process(
        target=importlib.import_module, args=(name,))
    proc.start()
    proc.join(120)
    assert proc.exitcode == 1, (name, proc.exitcode)
print("blocked in a spawned process", flush=True)
import thinktwice_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    thinktwice_tpu_torch.__path__, "thinktwice_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("imported", len(names), "modules", flush=True)
sys.argv = ["cli", "evaluate", "--device", "cpu", "--n-routes", "2", "--batch", "2",
            "--vehicles", "2", "--route-len", "64"]
runpy.run_module("thinktwice_tpu_torch.cli", run_name="__main__")
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    sys.argv = ["cli", "collect", "--device", "cpu", "--frames", "5", "--vehicles", "2",
                "--route-len", "256", "--out", tmp]
    runpy.run_module("thinktwice_tpu_torch.cli", run_name="__main__")
    import torch
    batch = torch.load(tmp + "/batch.pt", weights_only=True)
    print("collected batch", tuple(batch["imgs"].shape), flush=True)
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
sys.argv = ["bench", "--device", "cpu", "--worlds", "2", "--steps", "4"]
runpy.run_module("thinktwice_tpu_torch.bench", run_name="__main__")
sys.argv = ["chip_smoke.py", "--device", "cpu", "--small"]
try:
    runpy.run_path("chip_smoke.py", run_name="__main__")
finally:
    print("cpp_extension loaded:", "torch.utils.cpp_extension" in sys.modules, flush=True)
"""


IMAGE_LIBS = ("h5py", "PIL", "cv2")

SCRIPT_WITHOUT_IMAGE_LIBS = f"""
import os, sys, tempfile
assert all(sys.modules.get(name, 0) is None for name in {BLOCKED + IMAGE_LIBS!r})
import numpy as np
import torch
from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, SimConfig
from thinktwice_tpu_torch.agents.roach import RoachPolicy
from thinktwice_tpu_torch.maps.cache import load_town, save_town
from thinktwice_tpu_torch.maps.compile_h5 import compile_town_arrays, read_town_h5
from thinktwice_tpu_torch.maps.procedural import grid_town_rasters, make_grid_town
from thinktwice_tpu_torch.maps.router import RasterPlanner, generate_random_routes
from thinktwice_tpu_torch.sim.reset import reset_world
from thinktwice_tpu_torch.train import collect, loop, png
from thinktwice_tpu_torch.train.export_reference import export_metadata, export_route
from thinktwice_tpu_torch.train.reference_dataset import ReferenceDataset

grid = make_grid_town(device="cpu")
rasters = grid_town_rasters(grid)
planner = RasterPlanner(rasters["road"], rasters["world_offset"], rasters["pixels_per_meter"])
routes = generate_random_routes(grid, 2, min_length=100.0, seed=0)
dense = [planner.plan(r[::12, :2], np.rad2deg(r[::12, 2]), spacing=1.0, max_len=256)
         for r in routes]
town = compile_town_arrays(rasters, [d[:, :2] for d in dense], device="cpu", strict=True,
                           max_lights=64, max_stops=8)
print("compiled", int(town.lane_valid.sum()), "lane points", int(town.tl_valid.sum()), "lights",
      flush=True)
try:
    read_town_h5("Town05.h5")
except ImportError:
    print("read_town_h5 needs h5py", flush=True)
cfg = Config(sim=SimConfig(max_vehicles=8, max_walkers=4, max_route_len=256, max_scenarios=4),
             camera=CameraConfig(height=32, width=64), lidar=LidarConfig(n_beams=4, n_azimuth=64))
policy = RoachPolicy.from_config(cfg)
loop.init_model_params(cfg, policy, torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
with tempfile.TemporaryDirectory() as tmp:
    save_town(tmp + "/town.npz", town)
    town = load_town(tmp + "/town.npz", device="cpu")
    for img in (np.full((5, 7, 3), 200, np.uint8), np.arange(35, dtype=np.uint16).reshape(5, 7),
                np.arange(35, dtype=np.uint8).reshape(5, 7)):
        png.write_png(tmp + "/x.png", img)
        assert np.array_equal(png.read_png(tmp + "/x.png"), img)
    state = reset_world(cfg, town, torch.as_tensor(np.stack(dense[:1])), n_vehicles=4,
                        generator=g)
    _, frames, sensors = collect.collect_batch(cfg, policy.eval(), town, state, 6, generator=g)
    export_route(tmp + "/route_00", frames, sensors)
    export_metadata(tmp, tmp + "/dataset_metadata.pkl")
    ds = ReferenceDataset(tmp, tmp + "/dataset_metadata.pkl")
    print("read back", len(ds), "items", ds.load_images(1).shape, ds.load_depth(1).shape,
          ds.load_seg(1).dtype, sorted(ds[1])[:3], flush=True)
print("loaded:", sorted(name for name in {IMAGE_LIBS!r} if sys.modules.get(name)), flush=True)
"""


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "thinktwice_tpu_torch")):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cu", ".cuh"))]
    return paths


def test_port_and_smoke_run_without_jax_stack(tmp_path):
    # every interpreter started with this environment, the processes the
    # port spawns (the dry run's ranks, the smoke's) included, runs this
    # sitecustomize first: an import of a blocked name raises ImportError
    (tmp_path / "sitecustomize.py").write_text(
        f"import sys\nfor name in {BLOCKED!r}:\n    sys.modules[name] = None\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert "blocked in a spawned process" in lines
    assert any(line.startswith("imported ") for line in lines)
    scores = json.loads(proc.stdout[proc.stdout.index("{"):proc.stdout.index("}") + 1])
    assert set(scores) == {"score_route", "score_penalty", "score_composed"}
    bench = next(json.loads(line) for line in lines if line.startswith('{"metric"'))
    assert bench["metric"] == "env_steps_per_sec_2worlds_roach_grid"
    assert lines[lines.index(json.dumps(bench)) + 1] == "cpu"
    assert "collected batch (1, 1, 4, 256, 512, 3)" in lines
    for tag in ("[eval card vs cpu] autopilot", "[eval card vs cpu] expert", "[eval expert]",
                "[eval student]", "[train collect]", "[train step] 3:", "[train checkpoint]",
                "[ppo iterate] 0:", "[ppo card vs cpu]", "[bc iterate]", "[bc probe]",
                "[bc card vs cpu]", "[ddp step]", "[ddp dryrun] frozen",
                "[worlds sharded] rank 1", "[town import] 2 worlds x 4 ticks",
                "[reference export] 1 world x 7 frames"):
        assert any(line.startswith(tag) for line in lines), tag
    assert any(line.startswith("[rollout] ") for line in lines)
    assert any(line.startswith("[student] 2 worlds x 4 ticks") for line in lines)
    assert any(line.startswith("[train checkpoint]") and "bit for bit True" in line
               for line in lines)
    assert "trained ppo 2 lines 32 tensors" in lines and "trained bc 2 lines 32 tensors" in lines
    ppo = [json.loads(line) for line in lines if line.startswith('{"anchor_kl"')]
    assert [r["iter"] for r in ppo] == [0, 1] and "env_steps" in ppo[0]
    bc = [json.loads(line) for line in lines if line.startswith('{"action_mae"')]
    assert [r["iter"] for r in bc] == [0, 1] and "cl_completion" in bc[0]
    assert sum(line.startswith("dryrun_multigpu OK: 2 ranks, loss=") for line in lines) == 2
    assert "cpp_extension loaded: False" in lines
    last = json.loads(lines[-2])
    assert last == {"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}}


def test_imported_towns_and_the_dataset_run_without_h5py_pil_cv2(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(
        f"import sys\nfor name in {BLOCKED + IMAGE_LIBS!r}:\n    sys.modules[name] = None\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT_WITHOUT_IMAGE_LIBS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("compiled ") and int(lines[0].split()[1]) > 100
    assert "read_town_h5 needs h5py" in lines
    assert "read back 2 items (4, 32, 64, 3) (4, 32, 64) int32 ['action_alpha', " \
           "'action_beta', 'cnn_features']" in lines
    assert lines[-1] == "loaded: []"


def test_port_sources_import_nothing_of_the_jax_stack():
    pattern = re.compile(
        r"^\s*(import|from) (jax|flax|optax|orbax|msgpack|ninja|thinktwice_tpu)\b")
    for path in _port_sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                assert not pattern.match(line), f"{path}:{n}: {line.strip()}"
                assert "cpp_extension" not in line, f"{path}:{n}: {line.strip()}"
