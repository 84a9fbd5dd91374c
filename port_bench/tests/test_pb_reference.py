"""The reference agrees with the port at small sizes on the CPU, its
control (the next lower precision in the program's place) comes out not
correct, and so does a run whose timed path is broken underneath.

Each test drives the rest of a run (set-up, the window, the comparison)
with the harness's look for a card skipped, at the cell's small sizes.
"""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import harness, registry
from port_bench.tests.small import roach_small, student_small

ROACH, STUDENT = "roach_rl6.grid64", "student_rl6.loop8"
CELLS = [(ROACH, roach_small), (STUDENT, student_small)]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run(cell, small, seed=2**31 + 17, **kw):
    traffic, conf = small()
    return harness.run_cell(registry.load_benchmark(), cell, seed, 1.0, False, "cpu",
                            time.perf_counter(), traffic=traffic, conf=conf, **kw)


@pytest.mark.parametrize("cell,small", CELLS)
def test_port_agrees_with_reference(cell, small):
    out = run(cell, small)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    for name, c in out["checks"].items():
        assert c["value"] == 0, name


@pytest.mark.parametrize("cell,small", CELLS)
def test_control_is_not_correct(cell, small):
    out = run(cell, small, control=True)
    assert not out["correct"], out["checks"]


def _unchanged_state(monkeypatch):
    from thinktwice_tpu_torch.sim import step as sim_step

    real = sim_step.step_world

    def step_world(cfg, town, state, control, draws=None, generator=None):
        _, events = real(cfg, town, state, control, draws=draws, generator=generator)
        return state, events

    monkeypatch.setattr(sim_step, "step_world", step_world)


def _half_batch(monkeypatch):
    """The policy's control of the second half of the worlds replaced by the
    mean over the first half (the expert's, and the student's fused one)."""
    from thinktwice_tpu_torch.agents import expert, thinktwice_driver

    def halve(ctrl):
        h = ctrl.shape[0] // 2
        out = ctrl.clone()
        out[h:] = ctrl[:h].mean(dim=0)
        return out

    real = expert.expert_control

    def expert_control(cfg, policy, town, state):
        ctrl, sup = real(cfg, policy, town, state)
        return halve(ctrl), sup

    monkeypatch.setattr(expert, "expert_control", expert_control)
    real_fuse = thinktwice_driver.controls_from_outputs

    def controls_from_outputs(outs, agent, speed, tp):
        ctrl, agent = real_fuse(outs, agent, speed, tp)
        return halve(ctrl), agent

    monkeypatch.setattr(thinktwice_driver, "controls_from_outputs", controls_from_outputs)


def _altered_answer(monkeypatch):
    """One value flipped where it is produced: a birdview mask bit (K1's
    output) and a camera pixel (K2's path)."""
    from thinktwice_tpu_torch.agents import thinktwice_driver
    from thinktwice_tpu_torch.sensors import birdview

    real_bits = birdview.birdview_bits

    def birdview_bits(cfg, prims, ego):
        bits = real_bits(cfg, prims, ego).clone()
        bits[0, 100, 96] ^= 1 << 4
        return bits

    monkeypatch.setattr(birdview, "birdview_bits", birdview_bits)
    real_cams = thinktwice_driver.cameras_from_state

    def cameras_from_state(*a, **kw):
        out = dict(real_cams(*a, **kw))
        rgb = out["rgb"].clone()
        rgb[0, 0, 0, 0, 0] += 0.5
        out["rgb"] = rgb
        return out

    monkeypatch.setattr(thinktwice_driver, "cameras_from_state", cameras_from_state)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer])
@pytest.mark.parametrize("cell,small", CELLS)
def test_broken_timed_path_is_not_correct(cell, small, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell, small)
    assert not out["correct"], out["checks"]
