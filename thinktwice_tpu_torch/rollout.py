"""The closed-loop Roach rollout over a batch of worlds: the main path of
the closed-loop workloads (collection, PPO, BC, expert evaluation).

Every `policy_every` ticks the expert (birdview through K1, the Roach CNN,
the rule brakes) computes a control for every world; the control is held
in between, and `step_world` advances all worlds each tick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.agents.expert import expert_control
from thinktwice_tpu_torch.agents.roach import RoachPolicy
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sim.reset import reset_world
from thinktwice_tpu_torch.sim.state import Events, WorldState
from thinktwice_tpu_torch.sim.step import StepDraws, WorldSlice, step_world

POLICY_EVERY = 2   # 10 Hz policy at the 20 Hz tick


def grid_routes(n_worlds: int, route_len: int) -> np.ndarray:
    """(n_worlds, route_len, 3) straight eastbound routes on the right lanes
    of the 2-block grid town's roads y = 100 and y = 200, 180 m long."""
    routes = []
    for i in range(n_worlds):
        lane_y = 98.25 if i % 2 == 0 else 198.25
        x0 = 5.0 + (i % 8) * 2.0
        xs = np.linspace(x0, x0 + 180.0, route_len)
        routes.append(np.stack([xs, np.full_like(xs, lane_y), np.zeros_like(xs)], 1))
    return np.stack(routes).astype(np.float32)


def grid_world(cfg: Config, n_worlds: int, n_vehicles: int, device="cuda",
               generator: torch.Generator | None = None):
    """(town, states): the 2-block grid town and n_worlds reset worlds on
    `device`, their spawns drawn from `generator`."""
    device = resolve_device(device)
    town = make_grid_town(n_blocks=2, block=100.0, device=device)
    routes = torch.as_tensor(grid_routes(n_worlds, cfg.sim.max_route_len),
                             device=device)
    states = reset_world(cfg, town, routes, n_vehicles=n_vehicles,
                         generator=generator)
    return town, states


def rollout(cfg: Config, policy: RoachPolicy, town: TownMap, state: WorldState,
            n_ticks: int, policy_every: int = POLICY_EVERY,
            draws: list[StepDraws] | None = None,
            generator: torch.Generator | None = None,
            worlds: WorldSlice | None = None):
    """Drive every world n_ticks ticks with the Roach expert. draws, when
    given, holds each tick's random draws (for parity tests); else they
    come from `generator`. With worlds, state holds those rows of a larger
    batch (one rank's share), and each tick's draws are made for the whole
    batch and cut to them. Returns (final state, list of per-tick Events,
    list of the controls the expert computed)."""
    events: list[Events] = []
    controls = []
    ctrl = None
    for t in range(n_ticks):
        if t % policy_every == 0:
            ctrl, _ = expert_control(cfg, policy, town, state)
            controls.append(ctrl)
        tick = None if draws is None else draws[t]
        if worlds is not None:
            tick = worlds.step_draws(town, state, tick, generator)
        state, ev = step_world(cfg, town, state, ctrl, draws=tick, generator=generator)
        events.append(ev)
    return state, events, controls


def stack_events(events: list[Events]) -> Events:
    """Per-tick Events -> one Events of (T, B) tensors."""
    return Events(**{
        f.name: torch.stack([getattr(e, f.name) for e in events])
        for f in dataclasses.fields(Events)
    })
