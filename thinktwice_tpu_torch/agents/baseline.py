"""Baseline harness agents, the reference's non-learned ego drivers, for a
batch of worlds (counterpart of `thinktwice_tpu/agents/baseline.py`):

- `npc_control`: the leaderboard's NPC agent, a stock planner: pure pursuit
  on the dense route at a fixed 20 km/h, stopping for leaders (the traffic
  module's front gap) and its own approach's red light;
- `dummy_control`: a constant crawl, the harness's plumbing check.

Both take (cfg, town, state) and return (B, 3) controls, the policy
interface of `harness/evaluator.py`.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.geometry import wrap_angle
from thinktwice_tpu_torch.maps.town import TownMap, traffic_light_states
from thinktwice_tpu_torch.sim.state import WorldState
from thinktwice_tpu_torch.sim.traffic import _front_gap, _red_light_dist

NPC_TARGET_SPEED = 20.0 / 3.6  # the stock planner's 20 km/h


def dummy_control(cfg: Config, town: TownMap, state: WorldState):
    """(B, 3) constant straight-line crawl: steer 0, throttle 0.3, brake 0."""
    del cfg, town
    ctrl = torch.tensor([0.0, 0.3, 0.0], device=state.tick.device)
    return ctrl.expand(state.n_worlds, 3).clone()


def npc_control(cfg: Config, town: TownMap, state: WorldState):
    """(B, 3) control of the stock planner: route pure pursuit at a fixed
    target speed, stopping for leaders and its own approach's red light (no
    stop signs, curvature shaping, hazard forecast or creep)."""
    del cfg
    ego = state.ego
    route, cum, idx = state.route, state.route_cumlen, state.criteria.route_idx
    B, n = route.shape[:2]
    b = torch.arange(B, device=route.device)

    # lateral: plain pure pursuit
    L = torch.clamp(2.5 + 0.7 * ego.speed, 3.0, 8.0)
    tidx = torch.clamp(torch.searchsorted(cum, (cum[b, idx] + L)[:, None])[:, 0], 0, n - 1)
    to_t = route[b, tidx, :2] - ego.pos
    err = wrap_angle(torch.atan2(to_t[:, 1], to_t[:, 0]) - ego.yaw)
    steer = torch.clamp(2.0 * err, -1.0, 1.0)

    # leader gap, the band logic of the background traffic
    tr, wk = state.traffic, state.walkers
    all_pos = torch.cat([tr.pos, wk.pos], dim=1)
    no_self = torch.zeros((B, 1, all_pos.shape[1]), dtype=torch.bool, device=route.device)
    gap = _front_gap(ego.pos[:, None], ego.yaw[:, None], all_pos,
                     torch.cat([tr.yaw, wk.yaw], dim=1), torch.cat([tr.extent, wk.extent], dim=1),
                     torch.cat([tr.active, wk.active], dim=1), no_self,
                     self_ext_x=ego.extent[:, 0, None])[:, 0]
    v_gap = torch.clamp((gap - 2.5) / 1.2, 0.0, NPC_TARGET_SPEED)

    # own-approach red light
    tl_states = traffic_light_states(town, state.time_s)
    d_red = _red_light_dist(town, tl_states, ego.pos[:, None], ego.yaw[:, None])[:, 0]
    v_red = torch.where(d_red < 12.0, torch.clamp((d_red - 2.0) / 2.0, 0.0, NPC_TARGET_SPEED),
                        NPC_TARGET_SPEED)

    v_des = torch.clamp_max(torch.minimum(v_gap, v_red), NPC_TARGET_SPEED)
    throttle = torch.clamp(0.9 * (v_des - ego.speed), 0.0, 0.75)
    brake = (ego.speed > v_des + 0.7) | ((v_des < 0.2) & (ego.speed > 0.05))
    throttle = torch.where(brake, 0.0, throttle)
    return torch.stack([steer, throttle, brake.to(torch.float32)], dim=-1)
