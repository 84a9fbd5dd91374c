"""The metrics' arithmetic on synthetic records, and the frozen bounds
against the port's smoke on tiny inputs."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from port_bench import registry
from port_bench.counts.device_busy import busy_us, idle_gaps


def read(name, run):
    return registry.reader(name)(run)


def test_rates_are_over_the_whole_window():
    run = {"units": 64 * 250, "steps": 250, "window_s": 8.0}
    assert read("env_steps_per_s", run) == pytest.approx(2000.0)


def test_tick_p95_is_over_all_ticks():
    rng = np.random.default_rng(0)
    ms = list(rng.exponential(30.0, 997))
    assert read("tick_ms_p95", {"step_ms": ms}) == pytest.approx(float(np.percentile(ms, 95)))
    # a median of chunks would hide this one long stall among short ticks
    ms = [10.0] * 90 + [500.0] * 10
    assert read("tick_ms_p95", {"step_ms": ms}) == 500.0


def test_idle_from_overlapping_intervals():
    kernels = [("a", 0.0, 100.0), ("b", 50.0, 150.0), ("c", 400.0, 500.0)]
    assert busy_us([(a, b) for _, a, b in kernels]) == 250.0
    # 250 us busy in 2 traced ticks; the window's untraced ticks take 0.5 ms
    # each: 125 / 500 busy, however long the traced window was
    run = {"trace": {"kernels": kernels, "window_s": 5000e-6, "steps": 2},
           "step_ms": [0.5, 0.5, 0.5]}
    assert read("device_idle_pct.loop", run) == pytest.approx(75.0)
    assert read("kernels_per_tick", run) == 1.5
    assert read("device_idle_pct.loop", {**run, "step_ms": []}) is None
    assert idle_gaps([(0, 100), (50, 150), (400, 500)], 0, 600) == [(150, 400), (500, 600)]


def test_spans_and_mfu():
    run = {"spans": {"expert_control": [2.0, 4.0], "step_world": [1.0],
                     "cameras_from_state": [1.0, 1.0], "lidar_from_state": [2.0, 2.0],
                     "student_forward": [10.0]},
           "policy_calls": 2, "flops_per_call": 1e12, "window_s": 2.0, "steps": 4,
           "peak_flop_per_s": 1e14}
    assert read("expert_ms", run) == 3.0
    assert read("step_world_ms", run) == 1.0
    assert read("sensors_ms", run) == 3.0
    assert read("student_forward_ms", run) == 10.0
    assert read("mfu_pct.loop", run) == pytest.approx(1.0)
    # nothing to read: nothing reported, never a 0
    assert read("expert_ms", {"spans": {}}) is None
    assert read("k1_roofline", {"spans": {}}) is None
    assert read("mfu_pct.loop", {"spans": {}}) is None


def _smoke():
    root = registry.ROOT
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def test_frozen_k1_bound_gives_the_smokes_counts():
    """The frozen bound on a tiny world's K1 inputs equals chip_smoke.py's."""
    from thinktwice_tpu_torch.config import bench_config
    from thinktwice_tpu_torch.rollout import grid_world
    from thinktwice_tpu_torch.sensors.birdview import birdview_inputs

    from port_bench.counts.k1_bound import k1_bound

    cfg = bench_config()
    g = torch.Generator().manual_seed(3)
    town, state = grid_world(cfg, 2, 6, device="cpu", generator=g)
    prims, ego = birdview_inputs(cfg.birdview, town, state)
    ms, by, pairs = _smoke().k1_bound(cfg.birdview, prims, ego)
    bv = cfg.birdview
    mine = k1_bound(bv.width, bv.pixels_ev_to_bottom, bv.pixels_per_meter, prims, ego)
    assert pairs > 0
    assert (mine["bound_ms"], mine["bound_by"], mine["pairs"]) == (ms, by, pairs)


def test_frozen_k2_bound_gives_the_smokes_counts():
    from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, SimConfig
    from thinktwice_tpu_torch.rollout import grid_world

    from port_bench.counts.k2_bound import k2_bound

    cfg = Config(sim=SimConfig(max_vehicles=8, max_walkers=4, max_route_len=256,
                               max_scenarios=4),
                 camera=CameraConfig(height=32, width=64),
                 lidar=LidarConfig(n_beams=4, n_azimuth=64))
    g = torch.Generator().manual_seed(4)
    town, state = grid_world(cfg, 2, 6, device="cpu", generator=g)
    smoke = _smoke()
    inputs = smoke.k2_inputs(cfg, town, state)
    want = smoke.k2_bound(inputs)
    got = k2_bound([(o, d, t, grid) for _, o, d, t, grid in inputs])
    assert want["pairs"] > 0
    for k in ("bound_ms", "bound_by", "pairs", "tests"):
        assert got[k] == want[k], k


def test_peaks_are_the_data_sheets():
    from port_bench.counts.peaks import HBM_BYTES_PER_S, flop_per_s

    assert HBM_BYTES_PER_S == 3.35e12
    assert flop_per_s("float32") == 67e12
    assert flop_per_s("bfloat16") == 989e12
    assert os.path.exists(os.path.join(registry.HERE, "counts", "peaks.json"))
