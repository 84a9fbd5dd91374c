"""PyTorch port parity: the world (reset, step, scenarios, criteria, traffic)
of thinktwice_tpu_torch against thinktwice_tpu on the CPU.

Both sides get the same inputs: routes made with numpy, states converted
from the JAX package's, and the random draws (spawn uniforms, ControlLoss
noise, recycle candidates) computed with jax.random from the JAX state's key
and handed to the port. Events, criteria counters, light states and the
history ring must be equal; float fields within 1e-4 (poses in meters).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinktwice_tpu.config import Config as JaxConfig
from thinktwice_tpu.config import SimConfig as JaxSimConfig
from thinktwice_tpu.maps.procedural import make_grid_town as jax_grid_town
from thinktwice_tpu.sim.reset import make_scenarios as jax_make_scenarios
from thinktwice_tpu.sim.reset import reset_world as jax_reset_world
from thinktwice_tpu.sim.step import step_world as jax_step_world
from thinktwice_tpu_torch.config import Config, SimConfig
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.maps.town import town_from_arrays
from thinktwice_tpu_torch.sim import scenarios as scen_lib
from thinktwice_tpu_torch.sim.reset import make_scenarios, reset_world
from thinktwice_tpu_torch.sim.state import (
    ScenarioState,
    state_from_arrays,
    state_to_arrays,
    tree_map,
)
from thinktwice_tpu_torch.sim.step import StepDraws, step_world

torch.set_num_threads(1)

# the capacities of the JAX suite's small_cfg (tests/conftest.py)
SMALL = dict(max_vehicles=16, max_walkers=8, max_lights=64, max_stop_signs=8,
             max_route_len=256, max_scenarios=8)
POSE_TOL = 1e-4   # m; float fields of a state after 20 ticks


def configs(**sim):
    kw = {**SMALL, **sim}
    return JaxConfig(sim=JaxSimConfig(**kw)), Config(sim=SimConfig(**kw))


def towns():
    return (jax_grid_town(n_blocks=2, block=100.0),
            make_grid_town(n_blocks=2, block=100.0, device="cpu"))


def two_routes(n: int = 256) -> np.ndarray:
    """World 0 drives east through the junction at (100, 100); world 1 drives
    east along the bottom perimeter road past the stop sign at (-5.5, -1.75)."""
    out = []
    for x0, y, length in ((74.0, 98.25, 120.0), (-20.0, -1.75, 150.0)):
        xs = np.linspace(x0, x0 + length, n)
        out.append(np.stack([xs, np.full_like(xs, y), np.zeros_like(xs)], 1))
    return np.stack(out).astype(np.float32)


def jax_spawn_uniform(keys, n_spawn):
    """The uniforms reset_world draws from each world's key."""
    return jax.vmap(
        lambda k: jax.random.uniform(jax.random.split(k)[1], (n_spawn,))
    )(keys)


def jax_step_draws(jstate, n_spawn: int) -> StepDraws:
    """The draws step_world makes from each world's key in jstate."""
    V = jstate.traffic.active.shape[1]
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(jstate.rng)
    normal = jax.vmap(lambda k: jax.random.normal(k, ()))(sub[:, 1])
    cand = jax.vmap(lambda k: jax.random.randint(k, (V,), 0, n_spawn))(sub[:, 2])
    return StepDraws(
        steer_normal=torch.tensor(np.asarray(normal)),
        recycle_cand=torch.as_tensor(np.asarray(cand).astype(np.int64)),
    )


def jax_batch_step(jcfg, jtown):
    return jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))


def assert_tree_matches(port, ref, tol=POSE_TOL, path="", field_tol=None):
    """Every field of the port's dataclass tree against the same-named field
    of the JAX one: floats within tol (or field_tol[name]), everything else
    equal."""
    field_tol = field_tol or {}
    for f in dataclasses.fields(port):
        a = getattr(port, f.name)
        b = getattr(ref, f.name)
        name = path + f.name
        if dataclasses.is_dataclass(a):
            assert_tree_matches(a, b, tol, name + ".", field_tol)
            continue
        a = a.detach().cpu().numpy()
        b = np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=field_tol.get(name, tol),
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


def rollout_pair(jcfg, tcfg, jtown, ttown, jstate, controls):
    """Step both packages through controls (T, B, 3) with the same draws;
    events must match on every tick. -> (port state, JAX state)."""
    tstate = state_from_arrays(jstate, device="cpu")
    step = jax_batch_step(jcfg, jtown)
    n_spawn = jtown.spawn.shape[0]
    for ctrl in controls:
        draws = jax_step_draws(jstate, n_spawn)
        jstate, jev = step(jstate, jnp.asarray(ctrl))
        tstate, tev = step_world(tcfg, ttown, tstate, torch.as_tensor(ctrl), draws=draws)
        assert_tree_matches(tev, jev)
    return tstate, jstate


def jax_reset_batch(jcfg, jtown, routes, seed, n_vehicles, scenario=None):
    keys = jax.random.split(jax.random.key(seed), routes.shape[0])
    if scenario is None:
        fn = jax.vmap(lambda r, k: jax_reset_world(jcfg, jtown, r, k, n_vehicles=n_vehicles))
        return fn(jnp.asarray(routes), keys), keys
    fn = jax.vmap(lambda r, k, sc: jax_reset_world(
        jcfg, jtown, r, k, n_vehicles=n_vehicles, scenario=sc))
    return fn(jnp.asarray(routes), keys, scenario), keys


def test_town_matches():
    """The port's grid town is the JAX package's, and so is the JAX town
    converted with town_from_arrays."""
    jtown, ttown = towns()
    for town in (ttown, town_from_arrays(jtown, device="cpu")):
        for f in dataclasses.fields(town):
            a = getattr(town, f.name).numpy()
            b = np.asarray(getattr(jtown, f.name))
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f.name)


def test_state_converts_both_ways():
    jcfg, _ = configs()
    jtown, _ = towns()
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=6, n_vehicles=5)
    tstate = state_from_arrays(jstate, device="cpu")
    assert_tree_matches(tstate, jstate, tol=0.0)
    again = state_from_arrays(state_to_arrays(tstate), device="cpu")
    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()), again, tstate)


@pytest.mark.parametrize("n_vehicles", [0, 12])
def test_reset_world_matches(n_vehicles):
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    routes = two_routes()
    jstate, keys = jax_reset_batch(jcfg, jtown, routes, seed=3, n_vehicles=n_vehicles)
    u = jax_spawn_uniform(keys, jtown.spawn.shape[0])
    tstate = reset_world(tcfg, ttown, torch.as_tensor(routes), n_vehicles=n_vehicles,
                         spawn_uniform=torch.tensor(np.asarray(u)))
    # exact, but for the route's cumulative length: XLA's cumsum adds in
    # another order than torch's (1.5e-5 m apart on these routes), 1e-4 m
    cum_tol = {"route_cumlen": POSE_TOL, "route_len_m": POSE_TOL}
    assert_tree_matches(tstate, jstate, tol=0.0, field_tol=cum_tol)
    assert int(tstate.traffic.active.sum()) == 2 * n_vehicles


def test_step_world_matches_over_20_ticks():
    """Traffic around a junction and along the perimeter; the ego starts at
    8 m/s, steers and brakes."""
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=5, n_vehicles=12)
    ego = dataclasses.replace(jstate.ego, speed=jnp.full((2,), 8.0))
    jstate = dataclasses.replace(jstate, ego=ego)
    rng = np.random.default_rng(0)
    controls = np.zeros((20, 2, 3), np.float32)
    controls[:, :, 0] = rng.uniform(-0.2, 0.2, (20, 2))
    controls[:, :, 1] = rng.uniform(0.0, 1.0, (20, 2))
    controls[12:16, 1, 2] = 1.0
    tstate, jstate = rollout_pair(jcfg, tcfg, jtown, ttown, jstate, controls)
    assert_tree_matches(tstate, jstate)
    assert int(tstate.history.count[0]) == 16      # the ring wrapped
    assert float(tstate.traffic.speed.max()) > 1.0   # traffic moved


def _scenarios(cfg_jax, cfg_port, route):
    """ControlLoss at the start, a walker crossing, a braking lead vehicle in
    the top slot, and a light manipulator forcing the junction lights red."""
    V = cfg_port.sim.max_vehicles
    p0 = route[0, :2]
    kinds = np.array([scen_lib.KIND_CONTROL_LOSS, scen_lib.KIND_DYNAMIC_CROSSING,
                      scen_lib.KIND_LEAD_VEHICLE_BRAKE, scen_lib.KIND_TL_MANIPULATOR])
    trig = np.stack([p0, p0 + [6.0, 0.0], p0 + [2.0, 0.0], [100.0, 100.0]]).astype(np.float32)
    actor = np.array([0, 0, V - 1, 0])
    params = np.array([[10.0, 0.0, 0.0, 0.0], [20.0, np.pi / 2, 4.0, 0.0],
                       [10.0, 0.0, 0.0, 0.0], [60.0, 0.0, 0.0, 2.0]], np.float32)
    return (jax_make_scenarios(cfg_jax, kinds, trig, actor, params),
            make_scenarios(cfg_port, kinds, trig, actor, params, device="cpu"))


def test_scenarios_match():
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    routes = two_routes()
    pairs = [_scenarios(jcfg, tcfg, r) for r in routes]
    jscen = jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs])
    tscen = tree_map(lambda *xs: torch.cat(xs), *[p[1] for p in pairs])
    assert_tree_matches(tscen, jscen)
    jstate, _ = jax_reset_batch(jcfg, jtown, routes, seed=1, n_vehicles=8, scenario=jscen)
    ego = dataclasses.replace(jstate.ego, speed=jnp.full((2,), 6.0))
    jstate = dataclasses.replace(jstate, ego=ego)
    controls = np.tile(np.array([0.0, 0.5, 0.0], np.float32), (20, 2, 1))
    tstate, jstate = rollout_pair(jcfg, tcfg, jtown, ttown, jstate, controls)
    assert_tree_matches(tstate, jstate)
    assert isinstance(tstate.scenario, ScenarioState)
    # every kind fired (the manipulator only near world 0's junction), the
    # walker and the lead vehicle are out
    assert bool((tstate.scenario.state[:, :3] > 0).all())
    assert int(tstate.scenario.state[0, 3]) == scen_lib.RUNNING
    assert bool(tstate.walkers.active[:, 0].all())
    assert bool(tstate.traffic.active[:, -1].all())
