"""Route XML and scenario JSON ingestion, the leaderboard's on-disk formats
(a copy of `thinktwice_tpu/harness/route_parser.py`, numpy only).

A route XML holds <route id town> elements of posed <waypoint x y yaw>
keypoints and an optional <weather>; a scenario JSON holds the trigger
transforms of each scenario type per town. Both become dense routes and
scenario slot specs.
"""

from __future__ import annotations

import dataclasses
import json
import xml.etree.ElementTree as ET

import numpy as np

from thinktwice_tpu_torch.maps.town import interpolate_route
from thinktwice_tpu_torch.sim.weather import parse_weather_elem


@dataclasses.dataclass
class RouteSpec:
    route_id: str
    town: str
    keypoints: np.ndarray      # (K, 2) x, y
    keypoint_yaws: np.ndarray  # (K,) degrees
    weather: np.ndarray | None = None  # (10,) sim.weather params

    def dense(self, spacing: float = 1.0, max_len: int | None = None,
              planner=None) -> np.ndarray:
        """(N, 3) dense (x, y, yaw_rad).

        With `planner` (a `maps.router.RasterPlanner` of the route's town,
        or any object whose plan(keypoints, yaws, spacing, max_len) plans
        over its roads) the planner densifies; without it, a posed Hermite
        spline (fine for procedural towns whose routes come from the lane
        graph already; it cuts corners off the road for sparse imported
        keypoints)."""
        if planner is not None:
            return planner.plan(self.keypoints, self.keypoint_yaws,
                                spacing, max_len)
        return interpolate_route(self.keypoints, self.keypoint_yaws, spacing, max_len)


def parse_routes_file(path: str, route_id_filter: str | None = None) -> list[RouteSpec]:
    """Route XML -> list of RouteSpec, each with its route's weather."""
    tree = ET.parse(path)
    routes = []
    for route in tree.iter("route"):
        rid = route.attrib["id"]
        if route_id_filter is not None and rid != route_id_filter:
            continue
        town = route.attrib.get("town", "")
        pts, yaws = [], []
        for wp in route.iter("waypoint"):
            pts.append((float(wp.attrib["x"]), float(wp.attrib["y"])))
            yaws.append(float(wp.attrib["yaw"]))
        routes.append(
            RouteSpec(
                route_id=rid,
                town=town,
                keypoints=np.asarray(pts, np.float64),
                keypoint_yaws=np.asarray(yaws, np.float64),
                weather=parse_weather_elem(route),
            )
        )
    return routes


@dataclasses.dataclass
class ScenarioTrigger:
    scenario_type: str         # e.g. "Scenario3"
    pos: np.ndarray            # (2,) trigger x, y
    yaw_deg: float


def parse_scenarios_file(path: str, town: str) -> list[ScenarioTrigger]:
    """Scenario JSON -> the trigger list of one town.

    Format: {"available_scenarios": [{"TownXX": [{"scenario_type": ...,
    "available_event_configurations": [{"transform": {x, y, z, yaw}, ...}]}]}]}
    """
    with open(path) as f:
        doc = json.load(f)
    out = []
    for town_block in doc.get("available_scenarios", []):
        if town not in town_block:
            continue
        for scen in town_block[town]:
            stype = scen.get("scenario_type", "")
            for event in scen.get("available_event_configurations", []):
                tr = event.get("transform", {})
                out.append(
                    ScenarioTrigger(
                        scenario_type=stype,
                        pos=np.asarray(
                            [float(tr.get("x", 0)), float(tr.get("y", 0))], np.float64
                        ),
                        yaw_deg=float(tr.get("yaw", 0)),
                    )
                )
    return out


def match_scenarios_to_route(
    triggers: list[ScenarioTrigger],
    dense_route: np.ndarray,
    max_distance: float = 10.0,
) -> list[ScenarioTrigger]:
    """Keep triggers whose position lies within max_distance of the route."""
    if not triggers:
        return []
    pts = dense_route[:, :2]
    out = []
    for t in triggers:
        d = np.min(np.linalg.norm(pts - t.pos[None], axis=1))
        if d < max_distance:
            out.append(t)
    return out


# Leaderboard scenario names -> the scenario kinds of sim/scenarios.py.
SCENARIO_NAME_TO_KIND = {
    "Scenario1": 2,   # ControlLoss
    "Scenario2": 3,   # FollowLeadingVehicle (lead brakes)
    "Scenario3": 1,   # DynamicObjectCrossing (walker darts out)
    "Scenario4": 6,   # VehicleTurningRoute (cyclist crosses the turn)
    "Scenario5": 7,   # OtherLeadingVehicle (slow lead + blocked overtake)
    "Scenario6": 5,   # ManeuverOppositeDirection -> oncoming vehicle
    "Scenario7": 4,   # SignalJunctionCrossingRoute
    "Scenario8": 4,   # NoSignalJunctionCrossingRoute
    "Scenario9": 4,
    "Scenario10": 5,
}


def downsample_route(dense_route: np.ndarray, sample_factor: float = 50.0) -> np.ndarray:
    """Sparse GPS-style plan: ~1 point per sample_factor meters plus the
    endpoints."""
    d = np.linalg.norm(np.diff(dense_route[:, :2], axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(d)])
    keep = [0]
    next_s = sample_factor
    for i, s in enumerate(cum):
        if s >= next_s:
            keep.append(i)
            next_s += sample_factor
    if keep[-1] != len(dense_route) - 1:
        keep.append(len(dense_route) - 1)
    return dense_route[np.asarray(keep)]
