"""PyTorch port parity at the bench's traffic density: the closed-loop Roach
rollout of thinktwice_tpu_torch against thinktwice_tpu's on the bench's first
two worlds (bench.py:89-119: 120 vehicles in 128 slots, the grid town's
eastbound routes, the spawn keys of jax.random.key(42)) for 40 ticks, the
policy every 2.

At this density the rule brakes stop the egos within ~1 s, so the window
covers the start, the stop and the standstill. Each expert call's control,
only_ap_brake flag and each rule brake (forecast and stopped-vehicle cone,
red light, stop sign, junction yield) must agree; the events on every tick
and the counters at the end must be equal, ego speeds and poses within
1e-2 (the slice test's tolerance: the JAX side renders with its XLA
birdview, whose edge pixels may differ from K1's plain version).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from test_torch_sim import configs, jax_step_draws, towns
from test_torch_slice import RL6
from thinktwice_tpu.agents.autopilot import junction_yield as jax_junction_yield
from thinktwice_tpu.agents.autopilot import red_sign_caps as jax_red_sign_caps
from thinktwice_tpu.agents.expert import expert_control as jax_expert_control
from thinktwice_tpu.agents.expert import hazard_brake as jax_hazard_brake
from thinktwice_tpu.sim.reset import reset_world as jax_reset_world
from thinktwice_tpu.sim.step import step_world as jax_step_world
from thinktwice_tpu_torch.agents.autopilot import junction_yield, red_sign_caps
from thinktwice_tpu_torch.agents.expert import expert_control, hazard_brake
from thinktwice_tpu_torch.rollout import grid_routes, stack_events
from thinktwice_tpu_torch.sim.state import state_from_arrays
from thinktwice_tpu_torch.sim.step import step_world

torch.set_num_threads(1)

# bench.py's capacities and traffic; its first two worlds
BENCH = dict(max_vehicles=128, max_walkers=8, max_lights=256, max_stop_signs=32,
             max_route_len=384, max_scenarios=8)
N_VEHICLES, N_BENCH_WORLDS, N_WORLDS = 120, 64, 2
N_TICKS, POLICY_EVERY = 40, 2
TOL = 1e-2   # m and m/s after 40 ticks
BRAKES = ("hazard", "red", "sign", "yield")


def _rule_brakes(spd, hazard, caps, yld):
    v_red, d_red, v_sign, d_sign = caps
    v_yield, d_conf, w_arc = yld
    return (
        hazard,
        ((d_red < 30.0) & (spd > v_red + 0.5)) | (d_red < 4.5),
        ((d_sign < 12.0) & (spd > v_sign + 0.5)) | (v_sign < 0.2),
        ((d_conf < w_arc - 1.0) & (spd > v_yield + 0.5)) | (d_conf < 4.0),
    )


def jax_expert(jcfg, params, jtown):
    """vmapped JAX expert -> (control, only_ap_brake, rule brakes (4, B))."""

    def one(s):
        ctrl, sup = jax_expert_control(jcfg, params, jtown, s)
        brakes = _rule_brakes(
            s.ego.speed, jax_hazard_brake(jcfg, s, stopped_cone=True),
            jax_red_sign_caps(jcfg, jtown, s), jax_junction_yield(jcfg, jtown, s))
        return ctrl, sup["only_ap_brake"], jnp.stack(brakes)

    return jax.jit(jax.vmap(one, out_axes=(0, 0, 1)))


def port_brakes(tcfg, ttown, state):
    return torch.stack(_rule_brakes(
        state.ego.speed, hazard_brake(tcfg, state, stopped_cone=True),
        red_sign_caps(tcfg, ttown, state), junction_yield(tcfg, ttown, state)))


def test_bench_density_rollout_matches_jax():
    jcfg, tcfg = configs(**BENCH)
    jtown, ttown = towns()
    with open(RL6, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    routes = jnp.asarray(grid_routes(N_BENCH_WORLDS, BENCH["max_route_len"])[:N_WORLDS])
    keys = jax.random.split(jax.random.key(42), N_BENCH_WORLDS)[:N_WORLDS]
    jstate = jax.vmap(lambda r, k: jax_reset_world(
        jcfg, jtown, r, k, n_vehicles=N_VEHICLES))(routes, keys)
    tstate = state_from_arrays(jstate, device="cpu")

    from thinktwice_tpu_torch.weights import load_roach_policy

    policy = load_roach_policy(RL6, tcfg, device="cpu")
    jexpert = jax_expert(jcfg, params, jtown)
    jstep = jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))
    n_spawn = jtown.spawn.shape[0]
    jevents, tevents, ap_brakes = [], [], 0
    for t in range(N_TICKS):
        if t % POLICY_EVERY == 0:
            jctrl, japb, jbrakes = jexpert(jstate)
            tctrl, sup = expert_control(tcfg, policy, ttown, tstate)
            np.testing.assert_allclose(tctrl.numpy(), np.asarray(jctrl), rtol=0,
                                       atol=1e-3, err_msg=f"control, tick {t}")
            np.testing.assert_array_equal(sup["only_ap_brake"].numpy(), np.asarray(japb),
                                          err_msg=f"only_ap_brake, tick {t}")
            tbrakes = port_brakes(tcfg, ttown, tstate).numpy()
            for name, a, b in zip(BRAKES, tbrakes, np.asarray(jbrakes)):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} brake, tick {t}")
            ap_brakes += int(np.asarray(japb).sum())
        draws = jax_step_draws(jstate, n_spawn)
        jstate, jev = jstep(jstate, jctrl)
        tstate, tev = step_world(tcfg, ttown, tstate, torch.tensor(np.asarray(jctrl)),
                                 draws=draws)
        jevents.append(jev)
        tevents.append(tev)
        np.testing.assert_allclose(tstate.ego.speed.numpy(), np.asarray(jstate.ego.speed),
                                   rtol=0, atol=TOL, err_msg=f"ego speed, tick {t}")

    # the window covers the rule brakes that stop the egos at this density,
    # and the standstill after them
    assert ap_brakes > 0
    assert bool((np.asarray(jstate.ego.speed) < 0.05).all())
    ev = stack_events(tevents)
    for f in dataclasses.fields(ev):
        ref = np.stack([np.asarray(getattr(e, f.name)) for e in jevents])
        np.testing.assert_array_equal(getattr(ev, f.name).numpy(), ref, err_msg=f.name)
    for name in ("n_collision_vehicle", "n_collision_walker", "n_collision_static",
                 "n_red_light", "n_stop_sign", "route_idx", "ticks", "done"):
        np.testing.assert_array_equal(getattr(tstate.criteria, name).numpy(),
                                      np.asarray(getattr(jstate.criteria, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tstate.criteria.dist_driven.numpy(),
                               np.asarray(jstate.criteria.dist_driven), rtol=0, atol=TOL)
    np.testing.assert_allclose(tstate.ego.pos.numpy(), np.asarray(jstate.ego.pos),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tstate.traffic.pos.numpy(), np.asarray(jstate.traffic.pos),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(tstate.traffic.active.numpy(),
                                  np.asarray(jstate.traffic.active))
