"""Driving Score statistics in the leaderboard's result schema (a copy of
`thinktwice_tpu/harness/statistics.py`, numpy only).

- penalties: pedestrian 0.50, vehicle 0.60, static 0.65, red light 0.70,
  stop 0.80 (1.0 for the longest6 benchmark);
- per route: score_penalty = prod(penalty^count) x (1 - offlane_pct/100);
  score_composed = max(score_route x score_penalty, 0);
- global: mean scores over routes; infractions per completed km
  (route_completion x route_length / 1000, floored at 0.001).

The JSON document is the leaderboard's results document, so its tooling
parses it unchanged. `RouteResult.from_criteria` takes one world's
`CriteriaState` (the port's, sliced to one world, as host tensors or numpy)
or plain numbers.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

PENALTY_COLLISION_PEDESTRIAN = 0.50
PENALTY_COLLISION_VEHICLE = 0.60
PENALTY_COLLISION_STATIC = 0.65
PENALTY_TRAFFIC_LIGHT = 0.70
PENALTY_STOP = 0.80

INFRACTION_KEYS = [
    "collisions_pedestrian",
    "collisions_vehicle",
    "collisions_layout",
    "red_light",
    "stop_infraction",
    "outside_route_lanes",
    "route_dev",
    "route_timeout",
    "vehicle_blocked",
]


@dataclasses.dataclass
class RouteResult:
    route_id: str
    index: int
    route_length_m: float
    completion_pct: float          # 0..100
    n_collision_walker: int = 0
    n_collision_vehicle: int = 0
    n_collision_static: int = 0
    n_red_light: int = 0
    n_stop_sign: int = 0
    offlane_pct: float = 0.0       # 0..100 of driven distance off-lane
    deviated: bool = False
    timed_out: bool = False
    blocked: bool = False
    finished: bool = False
    duration_game_s: float = 0.0
    duration_system_s: float = 0.0

    @classmethod
    def from_criteria(
        cls, route_id: str, index: int, crit, route_length_m: float,
        duration_game_s: float = 0.0, duration_system_s: float = 0.0,
    ) -> "RouteResult":
        """Build from one world's sim.state.CriteriaState on the host: each
        field a 0-d tensor, a numpy scalar or a number."""
        dist = float(crit.dist_driven)
        off = float(crit.dist_offlane)
        return cls(
            route_id=route_id,
            index=index,
            route_length_m=route_length_m,
            completion_pct=100.0 * float(crit.route_completion),
            n_collision_walker=int(crit.n_collision_walker),
            n_collision_vehicle=int(crit.n_collision_vehicle),
            n_collision_static=int(crit.n_collision_static),
            n_red_light=int(crit.n_red_light),
            n_stop_sign=int(crit.n_stop_sign),
            offlane_pct=100.0 * off / max(dist, 1e-6),
            deviated=bool(crit.route_deviation),
            timed_out=bool(crit.timeout),
            blocked=bool(crit.blocked),
            finished=bool(crit.finished),
            duration_game_s=duration_game_s,
            duration_system_s=duration_system_s,
        )


def compute_route_statistics(
    r: RouteResult, stop_penalty: float = PENALTY_STOP
) -> dict:
    """Per-route record."""
    score_route = 100.0 if r.finished else r.completion_pct
    score_penalty = (
        PENALTY_COLLISION_PEDESTRIAN ** r.n_collision_walker
        * PENALTY_COLLISION_VEHICLE ** r.n_collision_vehicle
        * PENALTY_COLLISION_STATIC ** r.n_collision_static
        * PENALTY_TRAFFIC_LIGHT ** r.n_red_light
        * stop_penalty ** r.n_stop_sign
        * max(1.0 - r.offlane_pct / 100.0, 0.0)
    )
    status = "Completed"
    if not r.finished:
        status = "Failed"
        if r.timed_out:
            status += " - Agent timed out"
        elif r.deviated:
            status += " - Agent deviated from the route"
        elif r.blocked:
            status += " - Agent got blocked"

    infractions = {
        "collisions_pedestrian": ["collision"] * r.n_collision_walker,
        "collisions_vehicle": ["collision"] * r.n_collision_vehicle,
        "collisions_layout": ["collision"] * r.n_collision_static,
        "red_light": ["ran red light"] * r.n_red_light,
        "stop_infraction": ["ran stop"] * r.n_stop_sign,
        "outside_route_lanes": (
            [f"{r.offlane_pct:.2f}% off lanes"] if r.offlane_pct > 0 else []
        ),
        "route_dev": ["deviation"] if r.deviated else [],
        "route_timeout": ["Route timeout."] if r.timed_out else [],
        "vehicle_blocked": ["blocked"] if r.blocked else [],
    }
    return {
        "route_id": r.route_id,
        "index": r.index,
        "status": status,
        "infractions": infractions,
        "meta": {
            "route_length": r.route_length_m,
            "duration_game": r.duration_game_s,
            "duration_system": r.duration_system_s,
        },
        "scores": {
            "score_route": score_route,
            "score_penalty": score_penalty,
            "score_composed": max(score_route * score_penalty, 0.0),
        },
    }


def compute_global_statistics(records: list[dict], total_routes: Optional[int] = None) -> dict:
    """Aggregate record over the routes."""
    total = total_routes or len(records)
    g_scores = {"score_route": 0.0, "score_penalty": 0.0, "score_composed": 0.0}
    g_infr = {k: 0.0 for k in INFRACTION_KEYS}
    status = "Completed"
    exceptions = []
    for rec in records:
        for k in g_scores:
            g_scores[k] += rec["scores"][k]
        # the leaderboard keeps score_route as a percentage here, so "km" is
        # inflated 100x; matched exactly so the per-km infraction numbers are
        # comparable to the leaderboard's own documents
        km = max(
            rec["scores"]["score_route"] * rec["meta"]["route_length"] / 1000.0,
            0.001,
        )
        for k in INFRACTION_KEYS:
            g_infr[k] += len(rec["infractions"].get(k, [])) / km
        if rec["status"] != "Completed":
            status = "Failed"
            exceptions.append((rec["route_id"], rec["index"], rec["status"]))
    for k in g_scores:
        g_scores[k] /= max(float(total), 1.0)
    return {
        "route_id": -1,
        "index": -1,
        "status": status,
        "infractions": g_infr,
        "scores": g_scores,
        "meta": {"exceptions": exceptions} if exceptions else {},
    }


def results_document(records: list[dict], global_record: dict) -> dict:
    """The full results document of the leaderboard's schema."""
    return {
        "_checkpoint": {
            "global_record": global_record,
            "progress": [len(records), len(records)],
            "records": records,
        },
        "entry_status": "Finished",
        "eligible": True,
        "sensors": [],
        "values": [
            f"{global_record['scores']['score_composed']:.3f}",
            f"{global_record['scores']['score_route']:.3f}",
            f"{global_record['scores']['score_penalty']:.3f}",
        ],
        "labels": ["Driving score", "Route completion", "Infraction penalty"],
    }


def save_results(path: str, records: list[dict], global_record: dict) -> None:
    with open(path, "w") as f:
        json.dump(results_document(records, global_record), f, indent=2)


def load_results(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resume_done_indices(path: str) -> set[int]:
    """Route indices already present in a results file (route-level
    resume)."""
    try:
        doc = load_results(path)
    except (OSError, json.JSONDecodeError):
        return set()
    return {rec["index"] for rec in doc.get("_checkpoint", {}).get("records", [])}
