"""PyTorch port parity: the rollout recorder, the metrics log and the
world-parallel rollout of thinktwice_tpu_torch against thinktwice_tpu on the
CPU, with the autopilot driving two worlds of the grid town.

The JAX recorder rolls one world at a time and draws from its key; the
port's rolls the batch and takes the same draws (the key chain of each
world, as in tests/test_torch_evaluator.py). Frames: counters, flags and
ticks equal, floats within 1e-3 (m, m/s, rad) after 24 ticks; the metric
functions on one world's frames within the same tolerance; the summary of
batched_rollout equal in every count, its mean completion within 1e-4.
"""

import jax
import numpy as np
import torch

from test_torch_evaluator import _split_tick
from test_torch_sim import configs, jax_reset_batch, towns, two_routes
from thinktwice_tpu.agents.autopilot import autopilot_control as jax_autopilot
from thinktwice_tpu.harness import metrics_log as j_log
from thinktwice_tpu.parallel import worlds as j_worlds
from thinktwice_tpu_torch.agents.autopilot import autopilot_control
from thinktwice_tpu_torch.harness import metrics_log as t_log
from thinktwice_tpu_torch.parallel import worlds as t_worlds
from thinktwice_tpu_torch.sim.state import state_from_arrays
from thinktwice_tpu_torch.sim.step import StepDraws

torch.set_num_threads(1)

TOL = 1e-3
N_STEPS, EVERY = 24, 4


def chain_draws(keys, n_vehicles: int, n_spawn: int, n_steps: int) -> list[StepDraws]:
    """Each tick's draws from each world's key (no world is done here)."""
    out = []
    for _ in range(n_steps):
        keys, normal, cand = _split_tick(keys, n_vehicles, n_spawn)
        out.append(StepDraws(steer_normal=torch.tensor(np.asarray(normal)),
                             recycle_cand=torch.tensor(np.asarray(cand).astype(np.int64))))
    return out


def start():
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=6, n_vehicles=8)
    draws = chain_draws(jstate.rng, jcfg.sim.max_vehicles, jtown.spawn.shape[0], N_STEPS)
    return jcfg, tcfg, jtown, ttown, jstate, draws


def test_record_rollout_and_metrics_match(tmp_path):
    jcfg, tcfg, jtown, ttown, jstate, draws = start()
    final, frames = t_log.record_rollout(tcfg, ttown, state_from_arrays(jstate, device="cpu"),
                                         autopilot_control, N_STEPS, EVERY, draws=draws)
    assert final.tick.tolist() == [N_STEPS, N_STEPS]
    for b in range(2):
        one = jax.tree.map(lambda x: x[b], jstate)
        _, ref = j_log.record_rollout(jcfg, jtown, one, jax_autopilot, N_STEPS, EVERY)
        got = t_log.world_frames(frames, b)
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            assert got[k].shape == v.shape, k
            if v.dtype.kind == "f":
                np.testing.assert_allclose(got[k], v, rtol=0, atol=TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), err_msg=k)

        t_m, j_m = t_log.MetricsLog(got), j_log.MetricsLog(ref)
        assert t_m.get_total_frame_count() == j_m.get_total_frame_count() == N_STEPS // EVERY
        assert t_m.get_actor_ids_with_type_id("walker") == j_m.get_actor_ids_with_type_id("walker")
        for actor in (0, 1, 3, t_m.V + 1):
            assert t_m.get_actor_alive_frames(actor) == j_m.get_actor_alive_frames(actor)
            np.testing.assert_allclose(t_m.get_actor_transform(actor, 2)[0],
                                       j_m.get_actor_transform(actor, 2)[0], atol=TOL)
            assert abs(t_m.get_actor_velocity(actor, 3) - j_m.get_actor_velocity(actor, 3)) < TOL
        np.testing.assert_allclose(t_log.distance_between(t_m, 0, 1),
                                   j_log.distance_between(j_m, 0, 1), rtol=0, atol=TOL)
        route = two_routes()[b, :, :2]
        np.testing.assert_allclose(t_log.distance_to_route(t_m, route),
                                   j_log.distance_to_route(j_m, route), rtol=0, atol=TOL)
        assert t_m.get_elapsed_time(1) == j_m.get_elapsed_time(1)

    path = str(tmp_path / "frames.npz")
    t_log.save(path, frames)
    back = t_log.load(path)
    assert back.keys() == frames.keys()
    for k in frames:
        np.testing.assert_array_equal(back[k], frames[k])
    assert float(frames["ego_speed"][-1].min()) > 0.5      # the egos drive


def test_batched_rollout_summary_matches():
    jcfg, tcfg, jtown, ttown, jstate, draws = start()
    j_final = j_worlds.batched_rollout(jcfg, jtown, jstate, jax_autopilot, N_STEPS)
    t_final = t_worlds.batched_rollout(tcfg, ttown, state_from_arrays(jstate, device="cpu"),
                                       autopilot_control, N_STEPS, draws=draws)
    a, b = t_worlds.summarize_events(t_final), j_worlds.summarize_events(j_final)
    assert a.keys() == b.keys()
    for k in a:
        if k == "mean_completion":
            assert abs(a[k] - b[k]) < 1e-4
        else:
            assert a[k] == b[k], k
    assert a["mean_completion"] > 0.0
    np.testing.assert_allclose(t_final.ego.pos.numpy(), np.asarray(j_final.ego.pos),
                               rtol=0, atol=TOL)


def test_batched_reset_matches_reset_world():
    jcfg, tcfg, jtown, ttown, jstate, _ = start()
    routes = torch.as_tensor(two_routes())
    g = torch.Generator().manual_seed(0)
    u = torch.rand((2, ttown.spawn.shape[0]), generator=g)
    from thinktwice_tpu_torch.sim.reset import reset_world
    from thinktwice_tpu_torch.sim.state import state_to_arrays

    a = state_to_arrays(t_worlds.batched_reset(tcfg, ttown, routes, 8, spawn_uniform=u))
    b = state_to_arrays(reset_world(tcfg, ttown, routes, n_vehicles=8, spawn_uniform=u))

    def same(x, y):
        for k in x:
            if isinstance(x[k], dict):
                same(x[k], y[k])
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)

    same(a, b)
