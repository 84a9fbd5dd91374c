"""The expert trainers' device cross-check (`train/crosscheck.py`) on the
CPU: two runs from the same weights and draws agree exactly, and the
comparison flags a run whose dones, metrics or gradients differ."""

import dataclasses

import pytest
import torch

from thinktwice_tpu_torch.config import Config, SimConfig
from thinktwice_tpu_torch.train import crosscheck
from thinktwice_tpu_torch.train.ppo import make_policy

torch.set_num_threads(1)

CFG = Config(sim=SimConfig(max_vehicles=16, max_walkers=8, max_lights=64,
                           max_stop_signs=8, max_route_len=256, max_scenarios=8))


@pytest.mark.parametrize("kind", ["ppo", "bc"])
def test_same_run_agrees_and_a_changed_one_does_not(kind):
    start, anchor = (make_policy(CFG, "cpu", torch.Generator().manual_seed(seed)).state_dict()
                     for seed in (4, 8))
    a = crosscheck.small_iterate(kind, CFG, "cpu", start, anchor, seed=2)
    b = crosscheck.small_iterate(kind, CFG, "cpu", start, anchor, seed=2)
    assert a.launches == b.launches == 0
    assert set(a.metrics) >= ({"anchor_kl"} if kind == "ppo" else {"cl_completion"})
    r = crosscheck.compare(a, b)
    assert r["ok"] and r["dones_equal"] and r["metric_err"] == 0.0 and r["grad_err"] == 0.0
    assert r["cos"] == pytest.approx(1.0, abs=1e-12)

    leaf = max(b.grads, key=lambda k: float(b.grads[k].norm()))
    flipped = dataclasses.replace(a, grads={**a.grads, leaf: -a.grads[leaf]})
    done = dataclasses.replace(a, done=~a.done)
    worst = next(iter(b.metrics))
    metric = dataclasses.replace(a, metrics={**a.metrics, worst: a.metrics[worst] + 1.0})
    for bad in (flipped, done, metric):
        assert not crosscheck.compare(bad, b)["ok"]
