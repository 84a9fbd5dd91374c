"""PyTorch port parity: the harness's host-side modules and the autopilot of
thinktwice_tpu_torch against thinktwice_tpu on the CPU.

- Town route helpers, weather, statistics, route parser, result writer and
  openscenario (numpy copies): equal arrays, equal strings, and equal JSON
  documents from the same criteria. The routes XML, the scenarios JSON and
  the .xosc are written to tmp_path here.
- autopilot_control: on states of the bench's density (120 vehicles on the
  grid town) and on crafted states (a turn, a stop sign, a junction, a
  blocked ego), the port and vmap of the JAX function agree to 1e-3 in each
  control and each speed cap of the debug dict, and exactly in the brake
  and in the hazard and creep flags.
"""

import dataclasses
import json
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sim import configs, jax_reset_batch, jax_step_draws, towns, two_routes
from thinktwice_tpu.agents.autopilot import autopilot_control as jax_autopilot
from thinktwice_tpu.harness import openscenario as j_osc
from thinktwice_tpu.harness import result_writer as j_writer
from thinktwice_tpu.harness import route_parser as j_parser
from thinktwice_tpu.harness import statistics as j_stats
from thinktwice_tpu.maps import town as j_town
from thinktwice_tpu.sim import weather as j_weather
from thinktwice_tpu.sim.state import CriteriaState as JCriteria
from thinktwice_tpu.sim.step import step_world as jax_step_world
from thinktwice_tpu_torch.agents.autopilot import autopilot_control
from thinktwice_tpu_torch.harness import openscenario as t_osc
from thinktwice_tpu_torch.harness import result_writer as t_writer
from thinktwice_tpu_torch.harness import route_parser as t_parser
from thinktwice_tpu_torch.harness import statistics as t_stats
from thinktwice_tpu_torch.maps import town as t_town
from thinktwice_tpu_torch.rollout import grid_routes
from thinktwice_tpu_torch.sim import weather as t_weather
from thinktwice_tpu_torch.sim.state import CriteriaState, state_from_arrays, tree_map

torch.set_num_threads(1)

CTRL_TOL = 1e-3     # autopilot controls and speed caps on the same state
FLAGS = ("hazard", "creep")
BENCH = dict(max_vehicles=128, max_walkers=8, max_lights=256, max_stop_signs=32,
             max_route_len=384, max_scenarios=8)

# ---------------------------------------------------------------------------
# town route helpers and weather


KEYPOINTS = [
    (np.array([[0.0, 0.0], [50.0, 0.0], [50.0, 40.0]]), np.array([0.0, 0.0, 90.0])),
    (np.array([[0.0, 0.0], [30.0, 10.0], [30.0, 10.0], [60.0, -5.0]]),
     np.array([10.0, 20.0, 20.0, -30.0])),
]


@pytest.mark.parametrize("spacing,max_len", [(1.0, None), (0.5, 64), (2.0, 500)])
@pytest.mark.parametrize("case", range(len(KEYPOINTS)))
def test_route_helpers_match(case, spacing, max_len):
    xy, yaw = KEYPOINTS[case]
    a = t_town.interpolate_route(xy, yaw, spacing, max_len)
    b = j_town.interpolate_route(xy, yaw, spacing, max_len)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    s = np.linspace(0.0, 1.0, 7)
    np.testing.assert_array_equal(
        t_town._hermite(xy[0], xy[1], xy[1], xy[0], s),
        j_town._hermite(xy[0], xy[1], xy[1], xy[0], s))
    np.testing.assert_array_equal(t_town.densify_polyline(xy, spacing),
                                  j_town.densify_polyline(xy, spacing))
    assert t_town.route_length(a) == j_town.route_length(b)


WEATHER_XML = [
    '<route id="0"/>',
    '<route id="1"><weather cloudiness="80" sun_altitude_angle="-10"/></route>',
    '<route id="2"><weather precipitation="40" wetness="30"/>'
    '<weather fog_density="12" fog_distance="20" precipitation="55"/></route>',
]


def test_weather_matches():
    assert list(t_weather.PRESETS) == list(j_weather.PRESETS)
    for table in ("PRESETS", "WEATHERS"):
        for k, v in getattr(j_weather, table).items():
            np.testing.assert_array_equal(getattr(t_weather, table)[k], v, err_msg=k)
    np.testing.assert_array_equal(t_weather.DEFAULT, j_weather.DEFAULT)
    for text in WEATHER_XML:
        elem = ET.fromstring(text)
        a, b = t_weather.parse_weather_elem(elem), j_weather.parse_weather_elem(elem)
        np.testing.assert_array_equal(a, b, err_msg=text)
        assert t_weather.is_night(a) == j_weather.is_night(b)


# ---------------------------------------------------------------------------
# statistics and the result writer


def criteria_arrays(n_worlds: int = 6, seed: int = 0) -> dict:
    """A batch of criteria with varied counters, flags and distances."""
    rng = np.random.default_rng(seed)

    def ints(hi):
        return rng.integers(0, hi, n_worlds).astype(np.int32)

    def flags(p):
        return rng.random(n_worlds) < p

    out = dict(
        n_collision_vehicle=ints(3), n_collision_walker=ints(2),
        n_collision_static=ints(2), n_red_light=ints(3), n_stop_sign=ints(2),
        collision_latch=np.zeros((n_worlds, 3), bool),
        collision_cd=np.zeros((n_worlds, 3), np.float32),
        coll_pos=np.zeros((n_worlds, 2), np.float32),
        coll_pos_valid=np.zeros(n_worlds, bool),
        tl_latch=np.zeros((n_worlds, 4), bool),
        stop_in_zone=np.zeros((n_worlds, 2), bool),
        stop_has_stopped=np.zeros((n_worlds, 2), bool),
        route_idx=ints(200),
        route_completion=rng.random(n_worlds).astype(np.float32),
        route_deviation=flags(0.3),
        dist_driven=(rng.random(n_worlds) * 200).astype(np.float32),
        dist_offlane=(rng.random(n_worlds) * 10).astype(np.float32),
        blocked_s=np.zeros(n_worlds, np.float32),
        blocked=flags(0.3), slow_s=np.zeros(n_worlds, np.float32),
        timeout=flags(0.3), finished=flags(0.3), done=np.ones(n_worlds, bool),
        ticks=ints(3000),
    )
    out["dist_driven"][0] = 0.0          # no distance: offlane over the 1e-6 floor
    out["finished"][1], out["n_collision_vehicle"][1] = True, 0
    return out


def documents(arrays, stop_penalty, tmp_path):
    """Both packages' result documents (and files) from the same criteria."""
    t_crit = state_from_arrays(arrays, device="cpu", cls=CriteriaState)
    j_crit = JCriteria(**{k: jnp.asarray(v) for k, v in arrays.items()})
    out = []
    for stats, crit, conv, name in (
            (t_stats, t_crit, lambda c: tree_map(lambda x: x.cpu(), c), "t"),
            (j_stats, j_crit, jax.device_get, "j")):
        host = conv(crit)
        recs = []
        for w in range(len(arrays["ticks"])):
            one = (tree_map(lambda x: x[w], host) if name == "t"
                   else jax.tree.map(lambda x: x[w], host))
            rr = stats.RouteResult.from_criteria(
                f"r{w}", w, one, 100.0 + 17.5 * w,
                duration_game_s=float(one.ticks) * 0.05, duration_system_s=1.25)
            recs.append(stats.compute_route_statistics(rr, stop_penalty))
        g = stats.compute_global_statistics(recs, total_routes=len(recs) + 1)
        path = tmp_path / f"{name}.json"
        stats.save_results(str(path), recs, g)
        out.append((recs, g, stats.results_document(recs, g), path))
    return out


@pytest.mark.parametrize("stop_penalty", [j_stats.PENALTY_STOP, 1.0])
def test_statistics_documents_match(stop_penalty, tmp_path):
    (t_recs, t_g, t_doc, t_path), (j_recs, j_g, j_doc, j_path) = documents(
        criteria_arrays(), stop_penalty, tmp_path)
    for name in ("PENALTY_COLLISION_PEDESTRIAN", "PENALTY_COLLISION_VEHICLE",
                 "PENALTY_COLLISION_STATIC", "PENALTY_TRAFFIC_LIGHT", "PENALTY_STOP",
                 "INFRACTION_KEYS"):
        assert getattr(t_stats, name) == getattr(j_stats, name)
    assert json.dumps(t_doc) == json.dumps(j_doc)
    assert t_path.read_bytes() == j_path.read_bytes()
    assert t_stats.load_results(str(t_path)) == j_stats.load_results(str(j_path))
    assert (t_stats.resume_done_indices(str(t_path))
            == j_stats.resume_done_indices(str(j_path)) == set(range(6)))
    assert t_stats.resume_done_indices(str(t_path) + ".missing") == set()
    statuses = {r["status"] for r in t_recs}
    assert "Completed" in statuses and len(statuses) > 1


def test_result_writer_matches(tmp_path, capsys):
    (_, _, t_doc, _), (_, _, j_doc, _) = documents(criteria_arrays(seed=1),
                                                  j_stats.PENALTY_STOP, tmp_path)
    for t_rec, j_rec in zip(t_doc["_checkpoint"]["records"], j_doc["_checkpoint"]["records"]):
        assert t_writer.route_report(t_rec) == j_writer.route_report(j_rec)
    assert t_writer.global_report(t_doc) == j_writer.global_report(j_doc)
    t_writer.print_results(t_doc)
    a = capsys.readouterr().out
    j_writer.print_results(j_doc)
    assert a == capsys.readouterr().out


# ---------------------------------------------------------------------------
# route parser


ROUTES_XML = """<?xml version="1.0" encoding="UTF-8"?>
<routes>
  <route id="0" town="Town01">
    <weather cloudiness="10" sun_altitude_angle="45"/>
    <waypoint x="0.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0.0"/>
    <waypoint x="60.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0.0"/>
    <waypoint x="90.0" y="30.0" z="0.0" pitch="0" roll="0" yaw="90.0"/>
  </route>
  <route id="7" town="Town02">
    <waypoint x="10.0" y="-5.0" z="0.0" yaw="180.0"/>
    <waypoint x="-40.0" y="-5.0" z="0.0" yaw="180.0"/>
  </route>
</routes>
"""

SCENARIOS_JSON = {"available_scenarios": [
    {"Town01": [
        {"scenario_type": "Scenario3", "available_event_configurations": [
            {"transform": {"x": "30.0", "y": "1.0", "z": "0", "yaw": "0"}},
            {"transform": {"x": "500.0", "y": "1.0", "z": "0", "yaw": "0"}}]},
        {"scenario_type": "Scenario7", "available_event_configurations": [
            {"transform": {"x": "88.0", "y": "20.0", "yaw": "90"}}]}]},
    {"Town02": [
        {"scenario_type": "Scenario1", "available_event_configurations": [
            {"transform": {"x": "0.0", "y": "-5.0", "yaw": "180"}}]}]},
]}


def test_route_parser_matches(tmp_path):
    routes = tmp_path / "routes.xml"
    routes.write_text(ROUTES_XML)
    scen = tmp_path / "scenarios.json"
    scen.write_text(json.dumps(SCENARIOS_JSON))
    assert t_parser.SCENARIO_NAME_TO_KIND == j_parser.SCENARIO_NAME_TO_KIND
    for route_filter in (None, "7"):
        t_specs = t_parser.parse_routes_file(str(routes), route_filter)
        j_specs = j_parser.parse_routes_file(str(routes), route_filter)
        assert len(t_specs) == len(j_specs) == (2 if route_filter is None else 1)
        for a, b in zip(t_specs, j_specs):
            assert (a.route_id, a.town) == (b.route_id, b.town)
            for f in ("keypoints", "keypoint_yaws", "weather"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
            for max_len in (None, 128):
                dense = a.dense(1.0, max_len)
                np.testing.assert_array_equal(dense, b.dense(1.0, max_len))
            np.testing.assert_array_equal(t_parser.downsample_route(dense, 20.0),
                                          j_parser.downsample_route(dense, 20.0))
            t_trig = t_parser.parse_scenarios_file(str(scen), a.town)
            j_trig = j_parser.parse_scenarios_file(str(scen), b.town)
            assert len(t_trig) == len(j_trig) > 0
            t_m = t_parser.match_scenarios_to_route(t_trig, dense)
            j_m = j_parser.match_scenarios_to_route(j_trig, dense)
            assert [(t.scenario_type, t.pos.tolist(), t.yaw_deg) for t in t_m] == \
                [(t.scenario_type, t.pos.tolist(), t.yaw_deg) for t in j_m]
    assert len(t_parser.match_scenarios_to_route(
        t_parser.parse_scenarios_file(str(scen), "Town01"),
        t_parser.parse_routes_file(str(routes), "0")[0].dense())) == 2


# ---------------------------------------------------------------------------
# openscenario


XOSC = """<?xml version="1.0"?>
<OpenSCENARIO>
  <FileHeader description="cut-in and crossing" author="test"/>
  <ParameterDeclarations>
    <ParameterDeclaration name="leadSpeed" parameterType="double" value="6.5"/>
    <ParameterDeclaration name="trig" parameterType="double" value="18"/>
  </ParameterDeclarations>
  <RoadNetwork><LogicFile filepath="Town04"/></RoadNetwork>
  <Entities>
    <ScenarioObject name="hero"><Vehicle name="ego">
      <BoundingBox><Dimensions length="4.9" width="2.1" height="1.5"/></BoundingBox>
      <Properties><Property name="type" value="ego_vehicle"/></Properties>
    </Vehicle></ScenarioObject>
    <ScenarioObject name="lead"><Vehicle name="car">
      <BoundingBox><Dimensions length="4.0" width="1.8" height="1.5"/></BoundingBox>
    </Vehicle></ScenarioObject>
    <ScenarioObject name="cross"><Vehicle name="car2"/></ScenarioObject>
    <ScenarioObject name="walker"><Pedestrian name="p"/></ScenarioObject>
    <ScenarioObject name="ghost"><Vehicle name="car3"/></ScenarioObject>
  </Entities>
  <Storyboard>
    <Init><Actions>
      <GlobalAction><EnvironmentAction><Environment>
        <Weather cloudState="overcast">
          <Sun azimuth="1.0" elevation="0.5" intensity="1"/>
          <Fog visualRange="400"/>
          <Precipitation precipitationType="rain" intensity="0.4"/>
        </Weather>
      </Environment></EnvironmentAction></GlobalAction>
      <Private entityRef="hero"><PrivateAction><TeleportAction><Position>
        <WorldPosition x="0" y="0" h="0"/></Position></TeleportAction></PrivateAction></Private>
      <Private entityRef="lead"><PrivateAction><TeleportAction><Position>
        <WorldPosition x="30" y="0.5" h="0.1"/></Position></TeleportAction></PrivateAction></Private>
      <Private entityRef="cross"><PrivateAction><TeleportAction><Position>
        <WorldPosition x="60" y="-20" h="1.57"/></Position></TeleportAction></PrivateAction></Private>
      <Private entityRef="walker"><PrivateAction><TeleportAction><Position>
        <WorldPosition x="45" y="4" h="-1.57"/></Position></TeleportAction></PrivateAction></Private>
      <Private entityRef="ghost"><PrivateAction><TeleportAction><Position>
        <LanePosition roadId="1" laneId="-1" s="10"/></Position></TeleportAction></PrivateAction></Private>
    </Actions></Init>
    <Story name="s"><Act name="a">
      <ManeuverGroup name="m1"><Actors><EntityRef entityRef="lead"/></Actors>
        <Maneuver name="m"><Event name="e1">
          <Action><PrivateAction><LongitudinalAction><SpeedAction>
            <SpeedActionTarget><AbsoluteTargetSpeed value="$leadSpeed"/></SpeedActionTarget>
          </SpeedAction></LongitudinalAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="c">
            <ByEntityCondition><EntityCondition>
              <RelativeDistanceCondition value="$trig" rule="lessThan"/>
            </EntityCondition></ByEntityCondition></Condition></ConditionGroup></StartTrigger>
        </Event></Maneuver></ManeuverGroup>
      <ManeuverGroup name="m2"><Actors><EntityRef entityRef="cross"/></Actors>
        <Maneuver name="m"><Event name="e2">
          <Action><PrivateAction><LongitudinalAction><SpeedAction>
            <SpeedActionTarget><AbsoluteTargetSpeed value="8"/></SpeedActionTarget>
          </SpeedAction></LongitudinalAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="c">
            <ByValueCondition><SimulationTimeCondition value="3" rule="greaterThan"/>
            </ByValueCondition></Condition></ConditionGroup></StartTrigger>
        </Event></Maneuver></ManeuverGroup>
      <ManeuverGroup name="m3"><Actors><EntityRef entityRef="walker"/></Actors>
        <Maneuver name="m"><Event name="e3">
          <Action><PrivateAction><LongitudinalAction><SpeedAction>
            <SpeedActionTarget><AbsoluteTargetSpeed value="2"/></SpeedActionTarget>
          </SpeedAction></LongitudinalAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="c">
            <ByValueCondition><StoryboardElementStateCondition state="end"/>
            </ByValueCondition></Condition></ConditionGroup></StartTrigger>
        </Event></Maneuver></ManeuverGroup>
    </Act></Story>
    <StopTrigger><ConditionGroup><Condition name="end">
      <ByValueCondition><SimulationTimeCondition value="40" rule="greaterThan"/>
      </ByValueCondition></Condition></ConditionGroup></StopTrigger>
  </Storyboard>
</OpenSCENARIO>
"""


def test_openscenario_matches(tmp_path):
    path = tmp_path / "case.xosc"
    path.write_text(XOSC)
    a, b = t_osc.parse_xosc(str(path)), j_osc.parse_xosc(str(path))
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "weather":
            np.testing.assert_array_equal(va, vb)
        elif f.name == "entities":
            assert [dataclasses.asdict(e) for e in va] == [dataclasses.asdict(e) for e in vb]
        else:
            assert va == vb, f.name
    assert len(a.entities) == 3 and a.unsupported
    for caps in ((8, 4), (2, 1)):
        ta, tb = t_osc.to_scenario_arrays(a, *caps), j_osc.to_scenario_arrays(b, *caps)
        assert ta.keys() == tb.keys()
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    empty = dataclasses.replace(a, entities=[])
    assert t_osc.to_scenario_arrays(empty, 8, 4) is None


# ---------------------------------------------------------------------------
# autopilot_control


def jax_autopilot_fn(jcfg, jtown):
    return jax.jit(jax.vmap(lambda s: jax_autopilot(jcfg, jtown, s, debug=True)))


def assert_autopilot_matches(jfn, tcfg, ttown, jstate, tag):
    """The port on the JAX state against the vmapped JAX autopilot jfn. ->
    the JAX controls and debug dict."""
    j_ctrl, j_dbg = jfn(jstate)
    t_ctrl, t_dbg = autopilot_control(tcfg, ttown, state_from_arrays(jstate, device="cpu"),
                                      debug=True)
    j_ctrl = np.asarray(j_ctrl)
    np.testing.assert_allclose(t_ctrl.numpy(), j_ctrl, rtol=0, atol=CTRL_TOL, err_msg=tag)
    np.testing.assert_array_equal(t_ctrl[:, 2].numpy(), j_ctrl[:, 2], err_msg=f"brake, {tag}")
    assert t_dbg.keys() == j_dbg.keys()
    for k, v in j_dbg.items():
        if k in FLAGS:
            np.testing.assert_array_equal(t_dbg[k].numpy(), np.asarray(v), err_msg=f"{k}, {tag}")
        else:
            np.testing.assert_allclose(t_dbg[k].numpy(), np.asarray(v), rtol=0, atol=CTRL_TOL,
                                       err_msg=f"{k}, {tag}")
    return j_ctrl, {k: np.asarray(v) for k, v in j_dbg.items()}


def test_autopilot_matches_at_bench_density():
    """The bench's first four worlds (120 vehicles in 128 slots), driven by
    the JAX autopilot for 30 ticks; every tick's state goes to both."""
    jcfg, tcfg = configs(**BENCH)
    jtown, ttown = towns()
    routes = jnp.asarray(grid_routes(64, BENCH["max_route_len"])[:4])
    keys = jax.random.split(jax.random.key(42), 64)[:4]
    from thinktwice_tpu.sim.reset import reset_world as jax_reset_world

    jstate = jax.vmap(lambda r, k: jax_reset_world(jcfg, jtown, r, k, n_vehicles=120))(
        routes, keys)
    jstate = dataclasses.replace(jstate, ego=dataclasses.replace(
        jstate.ego, speed=jnp.asarray([6.0, 3.0, 0.0, 8.0])))
    step = jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))
    jfn = jax_autopilot_fn(jcfg, jtown)
    brakes = 0
    for t in range(30):
        ctrl, dbg = assert_autopilot_matches(jfn, tcfg, ttown, jstate, f"tick {t}")
        brakes += int(ctrl[:, 2].sum())
        jstate, _ = step(jstate, jnp.asarray(ctrl))
    assert 0 < brakes < 4 * 30


def turn_route(n: int = 256) -> np.ndarray:
    """East on y = 98.25, then a left turn north at the junction (100, 100)."""
    return j_town.interpolate_route(
        np.array([[60.0, 98.25], [98.25, 98.25], [101.75, 110.0], [101.75, 200.0]]),
        np.array([0.0, 0.0, 90.0, 90.0]), 1.0, n)


def test_autopilot_matches_on_crafted_states():
    """A left turn, the junction and stop-sign routes of the world tests,
    with walkers out, at speed and blocked for 20 s; 12 ticks each."""
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    routes = np.concatenate([two_routes(), turn_route()[None]]).astype(np.float32)
    jstate, _ = jax_reset_batch(jcfg, jtown, routes, seed=3, n_vehicles=10)
    B = routes.shape[0]
    walkers = jstate.walkers
    wpos = np.asarray(walkers.pos).copy()
    wpos[:, 0] = [[82.0, 97.0], [-8.0, -3.0], [90.0, 96.0]]
    jstate = dataclasses.replace(
        jstate,
        ego=dataclasses.replace(jstate.ego, speed=jnp.asarray([5.0, 7.0, 4.0])),
        walkers=dataclasses.replace(
            walkers, pos=jnp.asarray(wpos),
            active=walkers.active.at[:, 0].set(True),
            speed=walkers.speed.at[:, 0].set(1.2),
            yaw=walkers.yaw.at[:, 0].set(jnp.pi / 2)),
    )
    blocked = dataclasses.replace(jstate, criteria=dataclasses.replace(
        jstate.criteria, blocked_s=jnp.full((B,), 20.0)),
        ego=dataclasses.replace(jstate.ego, speed=jnp.zeros((B,))))
    step = jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))
    jfn = jax_autopilot_fn(jcfg, jtown)
    seen = {k: False for k in FLAGS}
    for name, st in (("moving", jstate), ("blocked", blocked)):
        for t in range(12):
            ctrl, dbg = assert_autopilot_matches(jfn, tcfg, ttown, st, f"{name} {t}")
            for k in FLAGS:
                seen[k] |= bool(dbg[k].any())
            st, _ = step(st, jnp.asarray(ctrl))
    assert all(seen.values()), seen


def test_autopilot_follows_state_draws():
    """The port's autopilot closes the loop with the port's world step: the
    same draws give the same egos as the JAX loop for 20 ticks."""
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=8, n_vehicles=6)
    tstate = state_from_arrays(jstate, device="cpu")
    jfn = jax.jit(jax.vmap(lambda s: jax_autopilot(jcfg, jtown, s)))
    step = jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))
    from thinktwice_tpu_torch.sim.step import step_world

    for _ in range(20):
        draws = jax_step_draws(jstate, jtown.spawn.shape[0])
        jctrl = jfn(jstate)
        jstate, _ = step(jstate, jctrl)
        tstate, _ = step_world(tcfg, ttown, tstate, autopilot_control(tcfg, ttown, tstate),
                               draws=draws)
    np.testing.assert_allclose(tstate.ego.pos.numpy(), np.asarray(jstate.ego.pos),
                               rtol=0, atol=CTRL_TOL)
    np.testing.assert_array_equal(tstate.criteria.route_idx.numpy(),
                                  np.asarray(jstate.criteria.route_idx))
    assert float(tstate.criteria.dist_driven.min()) > 0.1
