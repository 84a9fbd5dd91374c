"""The student's closed loop with its published sparse LiDAR encoder
(`student_spconv.voxels8`) at small sizes on the CPU: the cell is found by
name, the port agrees with the reference (its voxels exactly), and the
control and a run whose timed path is broken underneath come out not
correct: the state left unchanged, half the worlds' control replaced, one
value altered, one voxel dropped (which `voxel_flips` catches).

The LiDAR sees only the ground around the car (0.5 m high, 1.5 m range), so
the reference's dense convolutions cover a few columns of the 41 x 672 x 672
grid and a run takes seconds.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from port_bench import harness, registry
from port_bench.tests import test_pb_reference as base
from port_bench.tests.small import student_small

CELL = "student_spconv.voxels8"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def spconv_small():
    bench = registry.load_benchmark()
    small_tr, small_conf = student_small()
    tr = registry.traffic(registry.workload(bench, CELL)["traffic"])
    tr.update({k: small_tr[k] for k in ("worlds", "vehicles", "warmup_ticks", "trace_ticks",
                                        "checks", "history_calls", "sim")})
    conf = registry.config(bench, "student_spconv")
    conf.update({k: small_conf[k] for k in ("backbone_depth", "image_size", "model")})
    conf["lidar"].update(n_beams=4, n_azimuth=64, z_mount=0.5, lower_fov=-60.0, max_range=1.5)
    return tr, conf


def run(seed=2**31 + 17, **kw):
    traffic, conf = spconv_small()
    return harness.run_cell(registry.load_benchmark(), CELL, seed, 1.0, False, "cpu",
                            time.perf_counter(), traffic=traffic, conf=conf, **kw)


def test_the_cell_finds_its_files():
    bench = registry.load_benchmark()
    cell = registry.workload(bench, CELL)
    assert cell["chips"] == 1
    conf = registry.config(bench, cell["config"])
    assert conf["lidar_encoder"] == "sparse" and conf["reduced"] == []
    tr = registry.traffic(cell["traffic"])
    assert tr["loop"] == "student_spconv" and tr["limits"]["voxel_flips"] == 0
    traced = {m["name"] for m in registry.metrics(bench, CELL, True)}
    assert {"student_lidar_ms", "lidar_sparse_ms", "voxels_per_tick", "k5_roofline",
            "k6_roofline", "k7_roofline", "syncs_per_tick", "mfu_pct.loop"} <= traced
    assert {m["name"] for m in registry.metrics(bench, CELL, False)} == \
        {"env_steps_per_s", "tick_ms_p95", "setup_s"}


def test_port_agrees_with_reference():
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    for name in ("camera_gap", "lidar_gap", "sensor_flips", "fusion_gap", "world_gap",
                 "world_flips", "voxel_flips"):
        assert out["checks"][name]["value"] == 0, name
    assert out["checks"]["encoder_gap"]["value"] < 1e-5


def test_control_is_not_correct():
    out = run(control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["encoder_gap"]["value"] > out["checks"]["encoder_gap"]["limit"]


def _dropped_voxel(monkeypatch):
    """The last voxel of the batch dropped from the voxelizer's output."""
    from thinktwice_tpu_torch.ops import voxelize

    real = voxelize.voxelize

    def drop(points, mask, spec):
        v = real(points, mask, spec)
        n = int(v.n[0]) - 1
        return dataclasses.replace(
            v, feats=v.feats[:n], coords=v.coords[:n], point_idx=v.point_idx[:n],
            counts=v.counts[:n], n=torch.tensor([n, int(v.n[1])], dtype=torch.int32))

    monkeypatch.setattr(voxelize, "voxelize", drop)


@pytest.mark.parametrize("fault", [base._unchanged_state, base._half_batch,
                                   base._altered_answer, _dropped_voxel])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]
    if fault is _dropped_voxel:
        assert out["checks"]["voxel_flips"]["value"] >= 1
