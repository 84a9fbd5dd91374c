"""Config tree of the closed-loop Roach rollout.

A copy of the dataclasses of `thinktwice_tpu/config.py` that this package
reads (`SimConfig`, `BirdviewConfig`, `RoachConfig` and the `Config` that
holds them), with the same field names and defaults, so a test can build one
of each from the same numbers. The camera, lidar, student-model and training
configs join when the modules that read them are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """World-step semantics (20 Hz tick, kinematic bicycle, IDM traffic)."""

    dt: float = 0.05
    max_vehicles: int = 128
    max_walkers: int = 32
    max_lights: int = 64
    max_stop_signs: int = 32
    max_route_len: int = 1024
    max_scenarios: int = 32

    # kinematic bicycle constants (World-on-Rails EgoModel)
    front_wb: float = -0.090769015
    rear_wb: float = 1.4178275
    steer_gain: float = 0.36848336
    brake_accel: float = -4.952399
    throt_accel: float = 0.5633837
    drag: float = 0.02

    # background-traffic policy
    npc_cruise_speed: float = 6.0
    npc_accel: float = 3.0
    npc_decel: float = 6.0
    npc_gap: float = 4.5
    npc_time_headway: float = 1.2
    npc_max_yaw_rate: float = 1.2
    npc_lookahead: float = 6.0
    tl_stop_distance: float = 24.0
    npc_recycle_s: float = 20.0
    courtesy_yield: bool = True

    # route progress / failure semantics
    blocked_speed: float = 0.1
    blocked_time: float = 90.0
    timeout_per_meter: float = 0.8
    timeout_base: float = 5.0
    offroute_allowance: float = 30.0
    offlane_allowed_dist: float = 1.3

    ego_extent_x: float = 2.45
    ego_extent_y: float = 1.06


@dataclasses.dataclass(frozen=True)
class BirdviewConfig:
    """Roach privileged BEV raster: 192 x 192 px at 5 px/m."""

    width: int = 192
    pixels_ev_to_bottom: int = 40
    pixels_per_meter: float = 5.0
    history_idx: Tuple[int, ...] = (-16, -11, -6, -1)
    history_len: int = 16
    scale_bbox: bool = True
    route_thickness: float = 8.0
    stopline_thickness: float = 3.0
    n_route_points: int = 80

    @property
    def n_channels(self) -> int:
        # road, route, lane, then vehicles, walkers, lights per history frame
        return 3 + 3 * len(self.history_idx)


@dataclasses.dataclass(frozen=True)
class RoachConfig:
    """Privileged expert: XtMaCNN trunk plus Beta policy and value heads."""

    features_dim: int = 256
    states_neurons: Tuple[int, ...] = (256,)
    policy_head: Tuple[int, ...] = (256, 256)
    value_head: Tuple[int, ...] = (256, 256)
    action_dim: int = 2
    state_dim: int = 6


@dataclasses.dataclass(frozen=True)
class Config:
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    birdview: BirdviewConfig = dataclasses.field(default_factory=BirdviewConfig)
    roach: RoachConfig = dataclasses.field(default_factory=RoachConfig)


def bench_config() -> Config:
    """The closed-loop bench's capacities: 120 background vehicles in 128
    slots, 8 walkers, 256 lights, 32 stop signs, 384-point routes and 8
    scenario slots."""
    return Config(
        sim=SimConfig(
            max_vehicles=128,
            max_walkers=8,
            max_lights=256,
            max_stop_signs=32,
            max_route_len=384,
            max_scenarios=8,
        )
    )
