"""World reset: routes -> initial WorldState for a batch of worlds
(counterpart of `thinktwice_tpu/sim/reset.py`).

The spawn draw (one uniform number per spawn point and world) is an
optional input; by default it comes from a torch.Generator on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.ttref.config import Config
from port_bench.reference.ttref.maps.town import TownMap
from port_bench.reference.ttref.sim import weather as weather_lib
from port_bench.reference.ttref.sim.state import (
    EgoState,
    ScenarioState,
    TrafficState,
    WalkerState,
    WorldState,
    zero_criteria,
    zero_history,
    zero_scenarios,
)

VEHICLE_EXTENT = (2.45, 1.06)   # lincoln.mkz2017-class half-sizes
WALKER_EXTENT = (0.4, 0.4)


def route_cumlen(route):
    """(B, R, >=2) -> (B, R) cumulative meters along each route."""
    d = torch.linalg.norm(torch.diff(route[..., :2], dim=-2), dim=-1)
    zero = torch.zeros_like(d[..., :1])
    return torch.cat([zero, torch.cumsum(d, dim=-1)], dim=-1)


def nearest_lane_idx(town: TownMap, xy):
    """(..., 2) -> (...,) index of the nearest valid lane waypoint."""
    d = torch.linalg.norm(town.lane_pts - xy[..., None, :], dim=-1)
    d = torch.where(town.lane_valid, d, 1e9)
    return torch.argmin(d, dim=-1)


def reset_world(cfg: Config, town: TownMap, routes, n_vehicles: int = 0,
                spawn_uniform=None, scenario: ScenarioState | None = None,
                weather=None, generator: torch.Generator | None = None
                ) -> WorldState:
    """routes (B, R, 3) dense (x, y, yaw) on the town's device.
    spawn_uniform (B, SP) in [0, 1): the spawn draw; the V best-scoring
    spawn points (valid, more than 15 m from the ego, then the draw) take
    the traffic slots, of which the first n_vehicles are active."""
    sim = cfg.sim
    dev = routes.device
    B = routes.shape[0]
    V, W = sim.max_vehicles, sim.max_walkers
    SP = town.spawn.shape[0]
    if spawn_uniform is None:
        spawn_uniform = torch.rand((B, SP), generator=generator, device=dev)

    ego = EgoState(
        pos=routes[:, 0, :2],
        yaw=routes[:, 0, 2],
        speed=torch.zeros((B,), device=dev),
        extent=torch.tensor([sim.ego_extent_x, sim.ego_extent_y],
                            device=dev).expand(B, 2).clone(),
        control=torch.zeros((B, 3), device=dev),
    )

    # traffic spawn: valid spawn points away from the ego score in (2, 3)
    d_ego = torch.linalg.norm(town.spawn[:, :2] - ego.pos[:, None], dim=-1)
    score = (
        spawn_uniform
        + town.spawn_valid.to(torch.float32)
        + (d_ego > 15.0).to(torch.float32)
    )
    pick = torch.topk(score, V, dim=-1, sorted=True).indices    # (B, V)
    chosen = town.spawn[pick]
    chosen_ok = town.spawn_valid[pick] & (torch.gather(d_ego, 1, pick) > 15.0)
    slot_on = torch.arange(V, device=dev) < n_vehicles
    active = slot_on & chosen_ok

    traffic = TrafficState(
        pos=chosen[..., :2],
        yaw=chosen[..., 2],
        speed=torch.zeros((B, V), device=dev),
        extent=torch.tensor(VEHICLE_EXTENT, device=dev).expand(B, V, 2).clone(),
        wp_idx=nearest_lane_idx(town, chosen[..., :2]),
        active=active,
        stop_s=torch.zeros((B, V), device=dev),
    )
    walkers = WalkerState(
        pos=torch.full((B, W, 2), 1e6, device=dev),
        yaw=torch.zeros((B, W), device=dev),
        speed=torch.zeros((B, W), device=dev),
        extent=torch.tensor(WALKER_EXTENT, device=dev).expand(B, W, 2).clone(),
        active=torch.zeros((B, W), dtype=torch.bool, device=dev),
    )
    if weather is None:
        weather = weather_lib.DEFAULT
    weather = torch.as_tensor(np.asarray(weather, np.float32), device=dev)
    if weather.dim() == 1:
        weather = weather.expand(B, -1).clone()

    cum = route_cumlen(routes)
    n_lights = town.tl_valid.shape[0]
    return WorldState(
        tick=torch.zeros((B,), dtype=torch.int64, device=dev),
        ego=ego,
        traffic=traffic,
        walkers=walkers,
        route=routes,
        route_cumlen=cum,
        route_len_m=cum[:, -1],
        criteria=zero_criteria(cfg, B, n_lights, town.stop_valid.shape[0], dev),
        history=zero_history(cfg, B, n_lights, dev),
        scenario=scenario if scenario is not None else zero_scenarios(cfg, B, dev),
        weather=weather,
    )

