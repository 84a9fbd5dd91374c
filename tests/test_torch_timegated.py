"""PyTorch port parity: the world's time-gated paths of thinktwice_tpu_torch
against thinktwice_tpu on the CPU.

Their timers start at zero and a few seconds of ticks reach none of them,
so the JAX reference state is set just short of each threshold, converted
to the port, and both packages step it a few ticks with the same
jax.random draws (as tests/test_torch_sim.py does):
- world 0: the ego stands (slow 24.98 s, blocked 89.87 s) and its traffic
  has stood 19.98 s: the NPC recycle at npc_recycle_s (sim/step.py), the
  courtesy yield to an ego slow for over 25 s (sim/traffic.py) of an NPC
  placed 14 m behind the ego in its lane, then the blocked criterion
  (sim/criteria.py) and the freeze of a done world;
- world 1: the timeout is three ticks away;
- world 2: the ego is ~2 m short of its route's end at 8 m/s: route
  completion, its event and the freeze;
- world 3: traffic stood 19.98 s beside a moving ego: the recycle again.
Events must be equal on every tick and states within 1e-4 (poses in
meters); each path must fire.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_sim import (
    assert_tree_matches,
    configs,
    jax_batch_step,
    jax_reset_batch,
    jax_step_draws,
    towns,
    two_routes,
)
from thinktwice_tpu_torch.maps.town import traffic_light_states
from thinktwice_tpu_torch.sim.state import state_from_arrays
from thinktwice_tpu_torch.sim.step import ROUTE_WIN, route_window, step_world
from thinktwice_tpu_torch.sim.traffic import ego_red_ahead, traffic_policy

torch.set_num_threads(1)

N_TICKS = 8
CONTROLS = np.array([[0.0, 0.0, 1.0], [0.0, 0.3, 0.0], [0.0, 0.5, 0.0], [0.0, 0.3, 0.0]],
                    np.float32)


def _set(x, i, v):
    return x.at[i].set(v)


def primed_state(jcfg, jtown):
    """Four worlds, each set just short of its thresholds (see above)."""
    routes = np.concatenate([two_routes(), two_routes()])
    jstate, _ = jax_reset_batch(jcfg, jtown, routes, seed=9, n_vehicles=12)
    sim = jcfg.sim
    crit, tr, ego = jstate.criteria, jstate.traffic, jstate.ego
    dt = sim.dt
    crit = dataclasses.replace(
        crit,
        slow_s=_set(crit.slow_s, 0, 25.0 - 0.4 * dt),
        blocked_s=_set(crit.blocked_s, 0, sim.blocked_time - 2.6 * dt),
        route_idx=_set(crit.route_idx, 2, routes.shape[1] - 8),
    )
    stood = sim.npc_recycle_s - 0.4 * dt
    stop_s = jnp.where(jnp.arange(4)[:, None] % 3 == 0, stood, tr.stop_s)
    speed = jnp.where(jnp.arange(4)[:, None] % 3 == 0, 0.0, tr.speed)
    # world 0's NPC 0 waits 14 m behind the ego in its lane (just arrived)
    behind = np.asarray(routes[0, 0, :2]) - [14.0, 0.0]
    lane = np.linalg.norm(np.asarray(jtown.lane_pts) - behind, axis=-1)
    lane = np.where(np.abs(np.asarray(jtown.lane_yaw)) < 0.1, lane, np.inf)
    tr = dataclasses.replace(
        tr, stop_s=_set(stop_s * tr.active, (0, 0), 0.0), speed=speed,
        pos=_set(tr.pos, (0, 0), jnp.asarray(behind, jnp.float32)),
        yaw=_set(tr.yaw, (0, 0), 0.0), active=_set(tr.active, (0, 0), True),
        wp_idx=_set(tr.wp_idx, (0, 0), int(np.argmin(lane)) + 2))
    end = routes[2, -5]
    ego = dataclasses.replace(
        ego,
        pos=_set(ego.pos, 2, jnp.asarray(end[:2])),
        yaw=_set(ego.yaw, 2, float(end[2])),
        speed=_set(_set(ego.speed, 2, 8.0), 0, 0.0),
    )
    # the timeout: time_s + dt > timeout_per_meter * route_len_m + timeout_base
    limit = sim.timeout_per_meter * float(jstate.route_len_m[1]) + sim.timeout_base
    tick = _set(jstate.tick, 1, int(limit / dt) - 2)
    return dataclasses.replace(jstate, criteria=crit, traffic=tr, ego=ego, tick=tick)


def courtesy_changes_accel(cfg, town, state, world: int) -> bool:
    """Whether the port's traffic policy on `state` yields to world's ego
    because it has been slow for over 25 s (the same call with the slow
    timer at zero gives other accelerations)."""
    win = route_window(state.route, state.criteria.route_idx, ROUTE_WIN)
    tl = traffic_light_states(town, state.time_s)
    tr, ego, wk = state.traffic, state.ego, state.walkers

    def accel(slow_s):
        return traffic_policy(cfg.sim, town, tl, tr.pos, tr.yaw, tr.speed, tr.extent,
                              tr.wp_idx, tr.active, ego.pos, ego.yaw, ego.extent, ego.speed,
                              wk.pos, wk.extent, wk.active, ego_route=win[..., :2],
                              ego_slow_s=slow_s,
                              ego_held_red=ego_red_ahead(town, tl, win))[1]

    slow = state.criteria.slow_s
    assert float(slow[world]) > 25.0
    return not torch.equal(accel(slow)[world], accel(torch.zeros_like(slow))[world])


def test_time_gated_paths_match_jax():
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    jstate = primed_state(jcfg, jtown)
    tstate = state_from_arrays(jstate, device="cpu")
    assert_tree_matches(tstate, jstate, tol=0.0)
    step = jax_batch_step(jcfg, jtown)
    n_spawn = jtown.spawn.shape[0]
    ctrl = np.broadcast_to(CONTROLS, (4, 3))

    recycled = np.zeros(4, bool)
    courtesy = False
    done_at = {}
    completed = np.zeros(4, bool)
    for tick in range(N_TICKS):
        if float(tstate.criteria.slow_s[0]) > 25.0 and not bool(tstate.criteria.done[0]):
            courtesy |= courtesy_changes_accel(tcfg, ttown, tstate, 0)
        before = tstate
        draws = jax_step_draws(jstate, n_spawn)
        jstate, jev = step(jstate, jnp.asarray(ctrl))
        tstate, tev = step_world(tcfg, ttown, tstate, torch.as_tensor(ctrl), draws=draws)
        assert_tree_matches(tev, jev)
        assert_tree_matches(tstate, jstate)

        moved = torch.linalg.norm(tstate.traffic.pos - before.traffic.pos, dim=-1)
        reset = (before.traffic.stop_s > 0) & (tstate.traffic.stop_s == 0) & (moved > 5.0)
        recycled |= reset.any(dim=1).numpy()
        completed |= tev.route_complete.numpy()
        for b in range(4):
            if bool(before.criteria.done[b]):
                # a done world is frozen: only its tick moves, no event fires
                for f in ("ego", "traffic", "walkers", "criteria", "history"):
                    new, old = getattr(tstate, f), getattr(before, f)
                    for g in dataclasses.fields(new):
                        assert torch.equal(getattr(new, g.name)[b], getattr(old, g.name)[b]), \
                            (b, f, g.name)
                assert int(tstate.tick[b]) == int(before.tick[b]) + 1
                assert not any(bool(getattr(tev, g.name)[b]) for g in dataclasses.fields(tev))
            elif bool(tstate.criteria.done[b]):
                done_at[b] = tick

    crit = tstate.criteria
    assert recycled[0] and recycled[3], recycled
    assert courtesy
    assert bool(crit.blocked[0]) and not bool(crit.timeout[0])
    assert bool(crit.timeout[1]) and not bool(crit.blocked[1])
    assert completed[2] and bool(crit.finished[2])
    assert not bool(crit.done[3])
    # every done world had ticks left to show its freeze
    assert set(done_at) == {0, 1, 2} and max(done_at.values()) < N_TICKS - 2, done_at
