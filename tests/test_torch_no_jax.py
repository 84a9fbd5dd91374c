"""The PyTorch port runs without the JAX stack.

A machine with a card may have torch, numpy and the CUDA toolkit and none of
jax, flax, optax, orbax, msgpack, ninja or triton. These tests run the port
in new interpreters where those modules (and the JAX package) cannot be
imported, with torch on one thread; the work is spread over four files,
since the suite places whole files on its workers:

- this file: every module of thinktwice_tpu_torch imports, and a spawned
  process finds the same modules blocked; the imported towns and the
  reference-format dataset without h5py, PIL and cv2 as well (below); no
  port source imports the JAX stack;
- tests/test_torch_no_jax_entry.py: the CLI's `evaluate` and `collect` and
  the bench with --device cpu;
- tests/test_torch_no_jax_trainers.py: the expert trainers' scripts and the
  dry run over two gloo ranks;
- tests/test_torch_no_jax_smoke.py: `chip_smoke.py --device cpu --small`,
  whole, to its last line.

Each script ends by printing whether torch.utils.cpp_extension was loaded
(it must not be).

The second subprocess here blocks h5py, PIL and cv2 as well, as the card
machine lacks them: there the planner is built from a town's rasters, a
town is compiled from arrays and goes through the town cache, the PNG codec
writes and reads each of its formats, one world collected on the compiled
town is exported in the reference's layout and `ReferenceDataset` reads it
back (images, depth and seg), and only `read_town_h5` fails, on its h5py
import.
"""

import os
import re
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "optax", "orbax", "msgpack", "ninja", "triton",
           "thinktwice_tpu")

# every interpreter these tests start, and every process those start, runs
# torch on one thread: the suite runs its files in parallel workers
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
# printed last by every blocked script: nothing reached cpp_extension
CPP_EXT = 'print("cpp_extension loaded:", "torch.utils.cpp_extension" in sys.modules, flush=True)'


def run_blocked(tmp_path, script: str, timeout: float, blocked=BLOCKED):
    """Run script in a new interpreter whose sitecustomize.py blocks
    `blocked` (an import of a blocked name raises ImportError), for that
    interpreter and every process it starts, from the repository's root
    with one torch thread. Prints the wall and CPU seconds of the process
    tree (`pytest -s` shows them). -> the completed process, its exit
    code 0."""
    (tmp_path / "sitecustomize.py").write_text(
        f"import sys\nfor name in {blocked!r}:\n    sys.modules[name] = None\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]), **ONE_THREAD)
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    print(f"[blocked interpreter] wall {time.perf_counter() - t0:.1f} s, user "
          f"{after.ru_utime - before.ru_utime:.1f} s, sys {after.ru_stime - before.ru_stime:.1f} s")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


SCRIPT_IMPORTS = f"""
import sys
import importlib, multiprocessing, pkgutil
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
{CPP_EXT}
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


def test_port_imports_without_jax_stack(tmp_path):
    proc = run_blocked(tmp_path, SCRIPT_IMPORTS, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert "blocked in a spawned process" in lines
    assert any(line.startswith("imported ") for line in lines)
    assert lines[-1] == "cpp_extension loaded: False"


def test_imported_towns_and_the_dataset_run_without_h5py_pil_cv2(tmp_path):
    proc = run_blocked(tmp_path, SCRIPT_WITHOUT_IMAGE_LIBS, timeout=300,
                       blocked=BLOCKED + IMAGE_LIBS)
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
