"""OpenSCENARIO (.xosc) subset parser -> the scenario slot arrays (a copy
of `thinktwice_tpu/harness/openscenario.py`, numpy only).

The parsed storyboard is compiled once, on the host, into the fixed-capacity
arrays every scenario source uses (`sim/reset.py:make_scenarios`), and the
batched state machines of `sim/scenarios.py` run it.

Supported subset:
- FileHeader / ParameterDeclarations with $-substitution,
- RoadNetwork/LogicFile (town name),
- Entities: Vehicle / Pedestrian ScenarioObjects with bounding boxes,
- Init TeleportAction WorldPosition (x, y, h); LanePosition needs an
  OpenDRIVE map and is reported in `unsupported`,
- Init EnvironmentAction -> the 10-param weather vector (sun azimuth /
  elevation, precipitation, fog),
- per-entity Storyboard events: the first SpeedAction per maneuver with a
  StartTrigger of RelativeDistanceCondition / ReachPositionCondition /
  TraveledDistanceCondition / SimulationTimeCondition.

Each non-ego entity becomes one scenario slot:
- Pedestrian -> kind 1 (walker dash),
- Vehicle heading within 45 deg of the ego's -> kind 6 (lead vehicle with a
  speed cap),
- otherwise -> kind 5 (crossing vehicle at a junction).
Trigger positions: the entity's own Init teleport; a distance trigger arms
when the ego comes within `value` meters of it.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np


@dataclasses.dataclass
class OscEntity:
    name: str
    category: str            # "vehicle" | "pedestrian" | "misc"
    extent: tuple            # (half_len, half_width)
    pos: tuple | None        # (x, y) from Init TeleportAction WorldPosition
    yaw: float               # heading (rad)
    target_speed: float      # first SpeedAction absolute target (m/s)
    trigger_kind: str        # "distance" | "time" | "none"
    trigger_value: float     # meters or seconds


@dataclasses.dataclass
class OscScenario:
    town: str
    description: str
    entities: list           # [OscEntity] non-ego
    ego_pos: tuple | None
    ego_yaw: float
    weather: np.ndarray | None   # (10,) sim/weather.py convention
    duration_s: float            # StopTrigger SimulationTime, if any
    unsupported: list            # [str] features seen but outside the subset


def _params(root) -> dict:
    out = {}
    for p in root.iter("ParameterDeclaration"):
        out[p.get("name")] = p.get("value")
    return out


def _sub(v: str | None, params: dict):
    if v is None:
        return None
    if v.startswith("$"):
        return params.get(v[1:], v)
    return v


def _world_pos(node):
    wp = node.find(".//WorldPosition")
    if wp is None:
        return None, 0.0
    return ((float(wp.get("x", 0)), float(wp.get("y", 0))),
            float(wp.get("h", 0)))


def _weather_vec(env) -> np.ndarray | None:
    """EnvironmentAction -> the 10-param WeatherParameters vector
    (sim/weather.py: cloud, rain, puddles, wind, sun_azimuth, sun_altitude,
    fog_density, fog_distance, wetness, fog_falloff)."""
    w = env.find(".//Weather")
    if w is None:
        return None
    sun = w.find("Sun")
    fog = w.find("Fog")
    rain = w.find("Precipitation")
    cloud = {"free": 0.0, "cloudy": 60.0, "overcast": 80.0, "rainy": 90.0}.get(
        w.get("cloudState", "free"), 0.0)
    rain_i = float(rain.get("intensity", 0.0)) * 100.0 if rain is not None else 0.0
    vis = float(fog.get("visualRange", 1e5)) if fog is not None else 1e5
    fog_density = float(np.clip(100.0 * (1.0 - vis / 1000.0), 0.0, 100.0))
    az = np.degrees(float(sun.get("azimuth", 0.0))) if sun is not None else 0.0
    alt = np.degrees(float(sun.get("elevation", 1.31))) if sun is not None else 75.0
    return np.asarray(
        [cloud, rain_i, rain_i * 0.5, 0.0, az, alt,
         fog_density, max(vis, 0.0) if vis < 1e5 else 0.0,
         rain_i * 0.3, 0.2 if fog_density > 0 else 0.0],
        np.float64)


def parse_xosc(path: str) -> OscScenario:
    tree = ET.parse(path)
    root = tree.getroot()
    params = _params(root)
    unsupported = []

    header = root.find("FileHeader")
    desc = header.get("description", "") if header is not None else ""
    logic = root.find(".//RoadNetwork/LogicFile")
    town = logic.get("filepath", "") if logic is not None else ""

    # --- entities ---------------------------------------------------------
    ents: dict[str, OscEntity] = {}
    ego_name = None
    for so in root.iter("ScenarioObject"):
        name = so.get("name")
        veh = so.find("Vehicle")
        ped = so.find("Pedestrian")
        node = veh if veh is not None else ped
        cat = ("vehicle" if veh is not None
               else "pedestrian" if ped is not None else "misc")
        half_l, half_w = 2.25, 1.05
        if node is not None:
            dims = node.find(".//BoundingBox/Dimensions")
            if dims is not None:
                half_l = float(dims.get("length", 4.5)) / 2.0
                half_w = float(dims.get("width", 2.1)) / 2.0
            props = {p.get("name"): p.get("value")
                     for p in node.iter("Property")}
            if props.get("type") == "ego_vehicle":
                ego_name = name
        ents[name] = OscEntity(
            name=name, category=cat, extent=(half_l, half_w),
            pos=None, yaw=0.0, target_speed=0.0,
            trigger_kind="none", trigger_value=0.0)
    if ego_name is None and "hero" in ents:
        ego_name = "hero"

    # --- init actions -----------------------------------------------------
    weather = None
    init = root.find(".//Storyboard/Init")
    if init is not None:
        env = init.find(".//EnvironmentAction")
        if env is not None:
            weather = _weather_vec(env)
        for priv in init.iter("Private"):
            name = priv.get("entityRef")
            if name not in ents:
                continue
            tp = priv.find(".//TeleportAction")
            if tp is not None:
                if tp.find(".//LanePosition") is not None:
                    unsupported.append(
                        f"LanePosition init for {name} (needs OpenDRIVE)")
                pos, yaw = _world_pos(tp)
                ents[name].pos = pos
                ents[name].yaw = yaw

    # --- storyboard events (first SpeedAction per entity) -----------------
    for mg in root.iter("ManeuverGroup"):
        actors = [e.get("entityRef") for e in mg.findall(".//Actors/EntityRef")]
        for ev in mg.iter("Event"):
            sa = ev.find(".//SpeedAction")
            if sa is None:
                continue
            tgt = sa.find(".//AbsoluteTargetSpeed")
            spd = float(_sub(tgt.get("value"), params) or 0.0) if tgt is not None else 0.0
            trig_kind, trig_val = "none", 0.0
            cond = ev.find(".//StartTrigger//Condition")
            if cond is not None:
                rd = cond.find(".//RelativeDistanceCondition")
                st = cond.find(".//SimulationTimeCondition")
                rp = cond.find(".//ReachPositionCondition")
                td = cond.find(".//TraveledDistanceCondition")
                if rd is not None:
                    trig_kind = "distance"
                    trig_val = float(_sub(rd.get("value"), params) or 0.0)
                elif rp is not None:
                    trig_kind = "distance"
                    trig_val = float(_sub(rp.get("tolerance"), params) or 5.0)
                elif td is not None:
                    trig_kind = "distance"
                    trig_val = float(_sub(td.get("value"), params) or 0.0)
                elif st is not None:
                    trig_kind = "time"
                    trig_val = float(_sub(st.get("value"), params) or 0.0)
                else:
                    unsupported.append(
                        f"trigger {ET.tostring(cond, encoding='unicode')[:60]}")
            for name in actors:
                e = ents.get(name)
                if e is None or e.target_speed > 0.0:
                    continue   # keep the FIRST speed event only (subset)
                e.target_speed = spd
                e.trigger_kind = trig_kind
                e.trigger_value = trig_val

    # --- stop trigger -----------------------------------------------------
    duration = 0.0
    stop = root.find(".//Storyboard/StopTrigger")
    if stop is not None:
        st = stop.find(".//SimulationTimeCondition")
        if st is not None:
            duration = float(_sub(st.get("value"), params) or 0.0)

    ego = ents.pop(ego_name, None) if ego_name else None
    return OscScenario(
        town=town, description=desc,
        entities=[e for e in ents.values() if e.pos is not None],
        ego_pos=ego.pos if ego else None,
        ego_yaw=ego.yaw if ego else 0.0,
        weather=weather, duration_s=duration, unsupported=unsupported)


def to_scenario_arrays(osc: OscScenario, max_vehicles: int,
                       max_walkers: int):
    """OscScenario -> kwargs for sim/reset.py:make_scenarios.

    Walker entities take walker slots round-robin; vehicle entities take the
    top traffic slots (the allocation of harness/evaluator.py
    build_route_scenarios). Returns None when no entity maps."""
    kinds, poss, actors, params = [], [], [], []
    w_slot, v_slot = 0, max_vehicles - 1
    for e in osc.entities:
        if e.category == "pedestrian":
            kind = 1
            actor = w_slot % max(max_walkers, 1)
            w_slot += 1
        else:
            # lead-vehicle when the adversary points the same way the ego
            # does at its own spawn; crossing adversary otherwise
            dyaw = abs(np.arctan2(np.sin(e.yaw - osc.ego_yaw),
                                  np.cos(e.yaw - osc.ego_yaw)))
            kind = 6 if dyaw < np.pi / 4 else 5
            actor = v_slot
            v_slot = max(v_slot - 1, 0)
        # trigger point: the entity's own position; distance triggers arm
        # when the ego closes to trigger_value of it (param[0])
        r = (e.trigger_value if e.trigger_kind == "distance" else 15.0)
        kinds.append(kind)
        poss.append(e.pos)
        actors.append(actor)
        params.append([max(r, 5.0), e.yaw, e.target_speed, 0.0])
    if not kinds:
        return None
    return dict(
        kinds=np.asarray(kinds),
        trigger_pos=np.asarray(poss, np.float64),
        actor_idx=np.asarray(actors),
        params=np.asarray(params, np.float64),
    )
