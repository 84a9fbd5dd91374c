"""PyTorch port parity: the route evaluator of thinktwice_tpu_torch against
thinktwice_tpu's `evaluate_routes` on the CPU, with the autopilot.

The port's evaluator takes its random numbers from a draws provider; here
the provider mirrors the reference's split chain: jax.random.key(seed)
split once per batch, then into per-world reset keys, and each tick's draws
from each world's key, which a done world keeps (JaxChainDraws). So both
packages drive the same worlds.

Grid town, the JAX suite's small_cfg capacities, 4 vehicles, 3 routes in
batches of 2 (the final batch padded), one of them with scenarios from
derive_map_triggers + build_route_scenarios, 64-tick segments and a cap of
320 ticks. The records must be equal in status and infraction counts, and
within 1e-2 in the scores, route_length and duration_game
(duration_system is wall time). A resumed call over one more route runs
only that route, and its document equals the reference's the same way.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sim import configs, towns
from thinktwice_tpu.agents.autopilot import autopilot_control as jax_autopilot
from thinktwice_tpu.harness import evaluator as j_eval
from thinktwice_tpu_torch.agents.autopilot import autopilot_control
from thinktwice_tpu_torch.agents.thinktwice_driver import SensorDraws
from thinktwice_tpu_torch.harness import evaluator as t_eval
from thinktwice_tpu_torch.sensors.lidar import LidarDraws
from thinktwice_tpu_torch.sim import weather as t_weather
from thinktwice_tpu_torch.sim.state import state_to_arrays
from thinktwice_tpu_torch.sim.step import StepDraws

torch.set_num_threads(1)

RECORD_TOL = 1e-2   # scores, route_length and duration_game of a record
SEGMENT, MAX_STEPS = 64, 320


class JaxChainDraws:
    """Draws provider of the reference's key chain: per batch, split the
    running key, split the batch key into per-world reset keys; reset takes
    (state key, spawn key) = split(world key); every tick splits each
    world's state key into (next, scenario, recycle), and a done world keeps
    its key. With `sensor_cfg`, each policy call also gets the cameras' and
    the lidar's draws from each world's key and tick."""

    def __init__(self, seed: int, sensor_cfg=None):
        self.rng = jax.random.key(seed)
        self.sensor_cfg = sensor_cfg

    def __call__(self, n_worlds, town):
        self.rng, sub = jax.random.split(self.rng)
        pair = jax.vmap(jax.random.split)(jax.random.split(sub, n_worlds))
        n_spawn = town.spawn.shape[0]
        spawn = jax.vmap(lambda k: jax.random.uniform(k, (n_spawn,)))(pair[:, 1])
        keys = {"now": pair[:, 0]}

        def step(state):
            V = state.traffic.active.shape[1]
            nxt, normal, cand = _split_tick(keys["now"], V, n_spawn)
            done = state.criteria.done.cpu().numpy()[:, None]
            keys["now"] = jax.random.wrap_key_data(np.where(
                done, jax.random.key_data(keys["now"]), jax.random.key_data(nxt)))
            return StepDraws(steer_normal=torch.tensor(np.asarray(normal)),
                             recycle_cand=torch.as_tensor(np.asarray(cand).astype(np.int64)))

        def sensors(state):
            ticks = jnp.asarray(state.tick.cpu().numpy().astype(np.int32))
            noise, keep, jitter = _sensor_draws(keys["now"], ticks, self.sensor_cfg)
            return SensorDraws(rain_noise=torch.tensor(np.asarray(noise)),
                               lidar=LidarDraws(torch.tensor(np.asarray(keep)),
                                                torch.tensor(np.asarray(jitter))))

        return t_eval.BatchDraws(
            spawn_uniform=torch.tensor(np.asarray(spawn)), step=step,
            policy=sensors if self.sensor_cfg is not None else None)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _split_tick(keys, V, n_spawn):
    """(next keys, steer normals (B,), recycle candidates (B, V)): the draws
    of sim/step.py from each world's key."""
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    normal = jax.vmap(lambda k: jax.random.normal(k, ()))(sub[:, 1])
    cand = jax.vmap(lambda k: jax.random.randint(k, (V,), 0, n_spawn))(sub[:, 2])
    return sub[:, 0], normal, cand


@functools.partial(jax.jit, static_argnums=2)
def _sensor_draws(keys, ticks, cfg):
    """The draws of the JAX cameras and lidar from each world's key and tick
    (tests/test_torch_student.py _jax_sensor_draws)."""
    cam, lid = cfg.camera, cfg.lidar
    P = lid.n_beams * lid.n_azimuth

    def one(k, t):
        noise = jax.random.normal(jax.random.fold_in(k, t),
                                  (cam.n_cams, cam.height, cam.width, 3))
        k1, k2 = jax.random.split(jax.random.fold_in(k, t + 7919))
        return noise, jax.random.uniform(k1, (P,)), jax.random.normal(k2, (P, 3))

    return jax.vmap(one)(keys, ticks)


def straight_route(x0, y, length, n=128):
    xs = np.linspace(x0, x0 + length, n)
    return np.stack([xs, np.full_like(xs, y), np.zeros_like(xs)], 1).astype(np.float32)


ROUTES = [
    straight_route(8.0, -1.75, 60.0),
    straight_route(70.0, 98.25, 70.0, 200),    # through the lit junction (100, 100)
    straight_route(20.0, 198.25, 50.0),
    straight_route(120.0, -1.75, 45.0),        # the resumed call's extra route
]
IDS = ["r0", "r1", "r2", "r3"]


def route_scenarios(jcfg, tcfg, jtown, ttown, routes):
    """Map triggers and scenario states of route 1 in both packages; equal
    triggers."""
    j_trig = j_eval.derive_map_triggers(jtown, routes[1])
    t_trig = t_eval.derive_map_triggers(ttown, routes[1])
    assert [(t.scenario_type, t.pos.tolist(), float(t.yaw_deg)) for t in t_trig] == \
        [(t.scenario_type, t.pos.tolist(), float(t.yaw_deg)) for t in j_trig]
    assert {t.scenario_type for t in t_trig} == {"Scenario3", "Scenario7"}
    j_sc = j_eval.build_route_scenarios(jcfg, routes[1], j_trig)
    t_sc = t_eval.build_route_scenarios(tcfg, routes[1], t_trig, device="cpu")
    for name, v in state_to_arrays(t_sc).items():
        np.testing.assert_array_equal(v[0], np.asarray(getattr(j_sc, name)).astype(v.dtype),
                                      err_msg=name)
    n = len(routes)
    return ([None, j_sc] + [None] * (n - 2), [None, t_sc] + [None] * (n - 2))


def assert_records_match(t_recs, j_recs):
    assert [r["index"] for r in t_recs] == [r["index"] for r in j_recs]
    for a, b in zip(t_recs, j_recs):
        tag = f"route {a['route_id']}"
        assert (a["route_id"], a["status"]) == (b["route_id"], b["status"]), tag
        assert {k: len(v) for k, v in a["infractions"].items()} == \
            {k: len(v) for k, v in b["infractions"].items()}, tag
        for k in ("score_route", "score_penalty", "score_composed"):
            np.testing.assert_allclose(a["scores"][k], b["scores"][k], rtol=0,
                                       atol=RECORD_TOL, err_msg=f"{k}, {tag}")
        for k in ("route_length", "duration_game"):
            np.testing.assert_allclose(a["meta"][k], b["meta"][k], rtol=0,
                                       atol=RECORD_TOL, err_msg=f"{k}, {tag}")
        assert a["meta"]["duration_system"] > 0.0


def assert_documents_match(t_doc, j_doc):
    assert t_doc.keys() == j_doc.keys()
    assert_records_match(t_doc["_checkpoint"]["records"], j_doc["_checkpoint"]["records"])
    for key in ("progress",):
        assert t_doc["_checkpoint"][key] == j_doc["_checkpoint"][key]
    tg, jg = t_doc["_checkpoint"]["global_record"], j_doc["_checkpoint"]["global_record"]
    assert tg["status"] == jg["status"]
    assert [e[:2] for e in tg["meta"].get("exceptions", [])] == \
        [e[:2] for e in jg["meta"].get("exceptions", [])]
    for k in tg["scores"]:
        np.testing.assert_allclose(tg["scores"][k], jg["scores"][k], rtol=0, atol=RECORD_TOL)
    for k in tg["infractions"]:
        np.testing.assert_allclose(tg["infractions"][k], jg["infractions"][k],
                                   rtol=RECORD_TOL, atol=RECORD_TOL, err_msg=k)
    for k in ("entry_status", "eligible", "sensors", "labels"):
        assert t_doc[k] == j_doc[k]


def test_evaluate_routes_autopilot_matches_jax(tmp_path):
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    j_scen, t_scen = route_scenarios(jcfg, tcfg, jtown, ttown, ROUTES)
    kw = dict(n_vehicles=4, max_steps=MAX_STEPS, worlds_per_batch=2, seed=3,
              segment_steps=SEGMENT)
    paths = {p: str(tmp_path / f"{p}.json") for p in "tj"}

    j_g = j_eval.evaluate_routes(jcfg, jtown, ROUTES[:3], IDS[:3], jax_autopilot,
                                 out_path=paths["j"], scenarios=j_scen[:3], **kw)
    t_g = t_eval.evaluate_routes(tcfg, ttown, ROUTES[:3], IDS[:3], autopilot_control,
                                 out_path=paths["t"], scenarios=t_scen[:3],
                                 draws=JaxChainDraws(3), **kw)
    t_doc, j_doc = (json.load(open(paths[p])) for p in "tj")
    assert_documents_match(t_doc, j_doc)
    assert t_g["scores"] == t_doc["_checkpoint"]["global_record"]["scores"]
    assert len(t_doc["_checkpoint"]["records"]) == 3
    # the routes are driven: some progress, a finished route and an infraction
    # or a failure among them
    scores = [r["scores"]["score_route"] for r in t_doc["_checkpoint"]["records"]]
    assert min(scores) > 5.0
    assert "Completed" in [r["status"] for r in t_doc["_checkpoint"]["records"]]
    assert j_g["status"] == t_g["status"]

    # resume over one more route: only it runs (one batch, padded)
    log = []
    t_eval.evaluate_routes(tcfg, ttown, ROUTES, IDS, autopilot_control,
                           out_path=paths["t"], scenarios=t_scen, resume=True,
                           draws=JaxChainDraws(3), batch_log=log, **kw)
    j_eval.evaluate_routes(jcfg, jtown, ROUTES, IDS, jax_autopilot,
                           out_path=paths["j"], scenarios=j_scen, resume=True, **kw)
    assert [b["routes"] for b in log] == [1] and log[0]["worlds"] == 2
    t_doc, j_doc = (json.load(open(paths[p])) for p in "tj")
    assert [r["index"] for r in t_doc["_checkpoint"]["records"]] == [0, 1, 2, 3]
    assert_documents_match(t_doc, j_doc)


def test_policy_every_must_divide_segment():
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    with pytest.raises(ValueError):
        j_eval.evaluate_routes(jcfg, jtown, ROUTES[:1], IDS[:1], jax_autopilot,
                               worlds_per_batch=1, max_steps=100, segment_steps=255,
                               policy_every=2)
    with pytest.raises(ValueError):
        t_eval.evaluate_routes(tcfg, ttown, ROUTES[:1], IDS[:1], autopilot_control,
                               worlds_per_batch=1, max_steps=100, segment_steps=255,
                               policy_every=2)


def test_default_draws_follow_the_seed():
    """Without a provider, a seed gives the same records twice, another seed
    another spawn; the policy holds its control over policy_every ticks;
    each world gets its route's weather (DEFAULT without one)."""
    _, tcfg = configs()
    _, ttown = towns()
    calls, weathers = [], []

    def policy(cfg, town, state):
        calls.append(int(state.tick[0]))
        weathers.append(state.weather.numpy().copy())
        return autopilot_control(cfg, town, state)

    rain = t_weather.WEATHERS["11"]
    kw = dict(n_vehicles=6, max_steps=32, worlds_per_batch=2, segment_steps=16,
              policy_every=4, weathers=[None, rain])
    runs = []
    for seed in (5, 5, 6):
        log = []
        g = t_eval.evaluate_routes(tcfg, ttown, ROUTES[:2], IDS[:2], policy, seed=seed,
                                   batch_log=log, **kw)
        runs.append(g)
        assert log[0]["ticks"] == 32
    assert calls[:8] == [0, 4, 8, 12, 16, 20, 24, 28]
    np.testing.assert_array_equal(weathers[0], np.stack([t_weather.DEFAULT, rain]))
    assert runs[0] == runs[1]
    gen = t_eval.GeneratorDraws(5)
    a, b = gen(2, ttown), t_eval.GeneratorDraws(6)(2, ttown)
    assert not torch.equal(a.spawn_uniform, b.spawn_uniform)
    assert torch.equal(a.spawn_uniform, t_eval.GeneratorDraws(5)(2, ttown).spawn_uniform)
