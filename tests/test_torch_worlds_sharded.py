"""PyTorch port parity: the world-parallel rollout of thinktwice_tpu_torch
sharded over a 2-rank gloo group on the CPU, against the JAX package's
batched_rollout over a 2-device `worlds` mesh and against the port's own
one-process run.

Four worlds of the grid town (two per rank) drive 24 ticks with the
autopilot. Their standing traffic is primed just short of the NPC recycle
(as in tests/test_torch_timegated.py), so the first tick respawns it at
the candidate spawns each world draws: a rank that took another world's
draws would end elsewhere.
- With the JAX key chain's draws of all four worlds, each rank cut to its
  rows: every count of summarize_events over the ranks equals the JAX
  mesh run's, and the mean completion agrees to 1e-4 (the tolerance of
  the one-process comparison in tests/test_torch_metrics_log.py).
- With those draws and with draws from a seeded generator (each rank
  draws for all four worlds and keeps its rows): the final worlds
  gathered from the ranks equal the port's one-process run of the four
  worlds bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_metrics_log import chain_draws
from test_torch_sim import configs, jax_reset_batch, towns, two_routes
from thinktwice_tpu.agents.autopilot import autopilot_control as jax_autopilot
from thinktwice_tpu.parallel import worlds as j_worlds
from thinktwice_tpu_torch.agents.autopilot import autopilot_control
from thinktwice_tpu_torch.parallel import ranks
from thinktwice_tpu_torch.parallel import worlds as t_worlds
from thinktwice_tpu_torch.parallel.launch import spawn
from thinktwice_tpu_torch.sim.state import state_from_arrays, state_to_arrays

torch.set_num_threads(1)

N_STEPS = 24
SEED = 11


@pytest.fixture(autouse=True)
def one_thread_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def start():
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    routes = np.concatenate([two_routes(), two_routes()[::-1]])
    jstate, _ = jax_reset_batch(jcfg, jtown, routes, seed=6, n_vehicles=8)
    tr = jstate.traffic
    stood = jcfg.sim.npc_recycle_s - 0.4 * jcfg.sim.dt
    jstate = dataclasses.replace(jstate, traffic=dataclasses.replace(
        tr, stop_s=jnp.where(tr.active, stood, tr.stop_s),
        speed=jnp.where(tr.active, 0.0, tr.speed)))
    draws = chain_draws(jstate.rng, jcfg.sim.max_vehicles, jtown.spawn.shape[0], N_STEPS)
    arrays = state_to_arrays(state_from_arrays(jstate, device="cpu"))
    return jcfg, tcfg, jtown, ttown, jstate, arrays, draws


def assert_same(a, b, path=""):
    for k in b:
        if isinstance(b[k], dict):
            assert_same(a[k], b[k], f"{path}{k}.")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=path + k)


@pytest.mark.parametrize("draws_from", ["jax chain", "generator"])
def test_sharded_rollout_matches_one_process_and_jax_mesh(start, draws_from):
    jcfg, tcfg, jtown, ttown, jstate, arrays, draws = start
    draws = draws if draws_from == "jax chain" else None
    out = spawn(ranks.autopilot_rollout_rank, 2,
                args=(tcfg, ttown, arrays, draws, N_STEPS, SEED),
                devices=["cpu", "cpu"], timeout=120)
    assert out[0]["summary"] == out[1]["summary"] and out[1]["final"] is None

    one = t_worlds.batched_rollout(tcfg, ttown, state_from_arrays(arrays, device="cpu"),
                                   autopilot_control, N_STEPS, draws=draws,
                                   generator=torch.Generator().manual_seed(SEED))
    assert out[0]["final"]["tick"].tolist() == [N_STEPS] * 4
    assert_same(out[0]["final"], state_to_arrays(one))
    assert out[0]["summary"] == t_worlds.summarize_events(one)

    if draws is not None:
        mesh = j_worlds.make_world_mesh(jax.devices()[:2])
        ref = j_worlds.summarize_events(j_worlds.batched_rollout(
            jcfg, jtown, jstate, jax_autopilot, N_STEPS, mesh=mesh))
        got = out[0]["summary"]
        assert got.keys() == ref.keys()
        for k in ref:
            if k == "mean_completion":
                assert abs(got[k] - ref[k]) < 1e-4
            else:
                assert got[k] == ref[k], k
        assert got["mean_completion"] > 0.0
