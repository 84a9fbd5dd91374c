"""WorldState: a batch of simulated worlds as dataclasses of tensors
(counterpart of `thinktwice_tpu/sim/state.py`).

Every field carries a leading world axis B. The field names are those of the
JAX package, so a state converts both ways with `state_from_arrays` and
`state_to_arrays`. The JAX state's PRNG key has no counterpart here: the
world step takes its random draws as an input or from a torch.Generator.
Integer fields are int64 (int32 in the JAX package) so they index tensors
directly; the light-state history stays int8.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.reference.ttref import resolve_device
from port_bench.reference.ttref.config import Config


@dataclasses.dataclass(frozen=True)
class EgoState:
    pos: torch.Tensor          # (B, 2) world meters
    yaw: torch.Tensor          # (B,) rad
    speed: torch.Tensor        # (B,) m/s
    extent: torch.Tensor       # (B, 2) half-sizes
    control: torch.Tensor      # (B, 3) last applied (steer, throttle, brake)


@dataclasses.dataclass(frozen=True)
class TrafficState:
    pos: torch.Tensor          # (B, V, 2)
    yaw: torch.Tensor          # (B, V)
    speed: torch.Tensor        # (B, V)
    extent: torch.Tensor       # (B, V, 2)
    wp_idx: torch.Tensor       # (B, V) i64 target index into town.lane_pts
    active: torch.Tensor       # (B, V) bool
    stop_s: torch.Tensor       # (B, V) seconds stationary (recycle rule)


@dataclasses.dataclass(frozen=True)
class WalkerState:
    pos: torch.Tensor          # (B, W, 2)
    yaw: torch.Tensor          # (B, W)
    speed: torch.Tensor        # (B, W)
    extent: torch.Tensor       # (B, W, 2)
    active: torch.Tensor       # (B, W) bool


@dataclasses.dataclass(frozen=True)
class CriteriaState:
    """Infraction accumulators of the leaderboard criteria."""

    n_collision_vehicle: torch.Tensor   # (B,) i64
    n_collision_walker: torch.Tensor
    n_collision_static: torch.Tensor
    n_red_light: torch.Tensor
    n_stop_sign: torch.Tensor
    collision_latch: torch.Tensor       # (B, 3) bool
    collision_cd: torch.Tensor          # (B, 3) f32 refractory seconds
    coll_pos: torch.Tensor              # (B, 2)
    coll_pos_valid: torch.Tensor        # (B,) bool
    tl_latch: torch.Tensor              # (B, NL) bool
    stop_in_zone: torch.Tensor          # (B, NS) bool
    stop_has_stopped: torch.Tensor      # (B, NS) bool
    route_idx: torch.Tensor             # (B,) i64
    route_completion: torch.Tensor      # (B,) f32
    route_deviation: torch.Tensor       # (B,) bool
    dist_driven: torch.Tensor           # (B,) f32
    dist_offlane: torch.Tensor          # (B,) f32
    blocked_s: torch.Tensor             # (B,) f32
    blocked: torch.Tensor               # (B,) bool
    slow_s: torch.Tensor                # (B,) f32
    timeout: torch.Tensor               # (B,) bool
    finished: torch.Tensor              # (B,) bool
    done: torch.Tensor                  # (B,) bool
    ticks: torch.Tensor                 # (B,) i64


@dataclasses.dataclass(frozen=True)
class HistoryState:
    """Ring buffers feeding the birdview's history channels."""

    veh_pose: torch.Tensor     # (B, Hh, V, 5) x, y, yaw, ext_x, ext_y
    veh_active: torch.Tensor   # (B, Hh, V) bool
    wlk_pose: torch.Tensor     # (B, Hh, W, 5)
    wlk_active: torch.Tensor   # (B, Hh, W) bool
    tl_state: torch.Tensor     # (B, Hh, NL) int8
    ptr: torch.Tensor          # (B,) i64 next slot
    count: torch.Tensor        # (B,) i64 valid entries (saturates at Hh)


@dataclasses.dataclass(frozen=True)
class ScenarioState:
    """Adversarial scenario slots (armed -> running -> done)."""

    kind: torch.Tensor         # (B, S) i64
    trigger_pos: torch.Tensor  # (B, S, 2)
    state: torch.Tensor        # (B, S) i64
    timer: torch.Tensor        # (B, S) f32
    actor_idx: torch.Tensor    # (B, S) i64
    param: torch.Tensor        # (B, S, 4) f32


@dataclasses.dataclass(frozen=True)
class WorldState:
    tick: torch.Tensor         # (B,) i64
    ego: EgoState
    traffic: TrafficState
    walkers: WalkerState
    route: torch.Tensor        # (B, R, 3) dense route (x, y, yaw)
    route_cumlen: torch.Tensor  # (B, R)
    route_len_m: torch.Tensor  # (B,)
    criteria: CriteriaState
    history: HistoryState
    scenario: ScenarioState
    weather: torch.Tensor      # (B, 10)

    @property
    def time_s(self) -> torch.Tensor:
        return self.tick.to(torch.float32) * 0.05

    @property
    def n_worlds(self) -> int:
        return self.tick.shape[0]


@dataclasses.dataclass(frozen=True)
class Events:
    """Per-step event pulses, (B,) bool each."""

    collision_vehicle: torch.Tensor
    collision_walker: torch.Tensor
    collision_static: torch.Tensor
    red_light: torch.Tensor
    stop_sign: torch.Tensor
    route_complete: torch.Tensor


_NESTED = {
    "ego": EgoState,
    "traffic": TrafficState,
    "walkers": WalkerState,
    "criteria": CriteriaState,
    "history": HistoryState,
    "scenario": ScenarioState,
}


def tree_map(fn, *trees):
    """Apply fn leaf-wise over dataclasses of tensors with equal structure."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{
            f.name: tree_map(fn, *[getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(t0)
        })
    return fn(*trees)


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def state_from_arrays(obj, device="cuda", cls=WorldState):
    """A port state from any object (or nested mapping) with the same field
    names holding arrays with a leading world axis, for example the JAX
    package's WorldState of a vmapped batch read as numpy. Fields the port
    does not hold (the JAX PRNG key) are ignored."""
    device = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = _get(obj, f.name)
        if f.name in _NESTED:
            kwargs[f.name] = state_from_arrays(v, device, _NESTED[f.name])
            continue
        a = np.array(v)
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        kwargs[f.name] = torch.as_tensor(a, device=device)
    return cls(**kwargs)


def state_to_arrays(state) -> dict:
    """A port state (any of the dataclasses above) as nested dicts of numpy
    arrays keyed by field name."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = (state_to_arrays(v) if dataclasses.is_dataclass(v)
                       else v.detach().cpu().numpy())
    return out


def zero_criteria(cfg: Config, B: int, n_lights: int, n_stops: int,
                  device) -> CriteriaState:
    """Latch arrays are sized to the town's light and stop-sign tables."""

    def z(*shape, dtype=torch.float32):
        return torch.zeros((B, *shape), dtype=dtype, device=device)

    i64 = torch.int64
    return CriteriaState(
        n_collision_vehicle=z(dtype=i64),
        n_collision_walker=z(dtype=i64),
        n_collision_static=z(dtype=i64),
        n_red_light=z(dtype=i64),
        n_stop_sign=z(dtype=i64),
        collision_latch=z(3, dtype=torch.bool),
        collision_cd=z(3),
        coll_pos=z(2),
        coll_pos_valid=z(dtype=torch.bool),
        tl_latch=z(n_lights, dtype=torch.bool),
        stop_in_zone=z(n_stops, dtype=torch.bool),
        stop_has_stopped=z(n_stops, dtype=torch.bool),
        route_idx=z(dtype=i64),
        route_completion=z(),
        route_deviation=z(dtype=torch.bool),
        dist_driven=z(),
        dist_offlane=z(),
        blocked_s=z(),
        blocked=z(dtype=torch.bool),
        slow_s=z(),
        timeout=z(dtype=torch.bool),
        finished=z(dtype=torch.bool),
        done=z(dtype=torch.bool),
        ticks=z(dtype=i64),
    )


def zero_history(cfg: Config, B: int, n_lights: int, device) -> HistoryState:
    Hh = cfg.birdview.history_len
    V, W = cfg.sim.max_vehicles, cfg.sim.max_walkers
    return HistoryState(
        veh_pose=torch.zeros((B, Hh, V, 5), device=device),
        veh_active=torch.zeros((B, Hh, V), dtype=torch.bool, device=device),
        wlk_pose=torch.zeros((B, Hh, W, 5), device=device),
        wlk_active=torch.zeros((B, Hh, W), dtype=torch.bool, device=device),
        tl_state=torch.full((B, Hh, n_lights), 2, dtype=torch.int8, device=device),
        ptr=torch.zeros((B,), dtype=torch.int64, device=device),
        count=torch.zeros((B,), dtype=torch.int64, device=device),
    )


def zero_scenarios(cfg: Config, B: int, device) -> ScenarioState:
    S = cfg.sim.max_scenarios
    return ScenarioState(
        kind=torch.zeros((B, S), dtype=torch.int64, device=device),
        trigger_pos=torch.zeros((B, S, 2), device=device),
        state=torch.zeros((B, S), dtype=torch.int64, device=device),
        timer=torch.zeros((B, S), device=device),
        actor_idx=torch.zeros((B, S), dtype=torch.int64, device=device),
        param=torch.zeros((B, S, 4), device=device),
    )
