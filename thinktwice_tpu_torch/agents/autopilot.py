"""The rule caps that the Roach expert's brake shares with the rule-based
autopilot (counterpart of `red_sign_caps` and `junction_yield` in
`thinktwice_tpu/agents/autopilot.py`). The autopilot's own control law is
not on the closed-loop Roach rollout and is not ported yet.
"""

from __future__ import annotations

import math

import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.geometry import segments_intersect, wrap_angle
from thinktwice_tpu_torch.maps.town import (
    TL_RED,
    TL_YELLOW,
    TownMap,
    traffic_light_states,
)
from thinktwice_tpu_torch.sim.state import WorldState

CRUISE = 7.0
COMFORT_DECEL = 3.0      # m/s^2 of the stop-distance speed profiles
W_RED = 48               # route points scanned for a red stop line
W_YLD = 22               # route points scanned for a crossing stream


def _stop_profile(dist, margin):
    """Speed that comfortably stops `margin` m before a point `dist` m ahead."""
    d = torch.clamp_min(dist - margin, 0.0)
    return torch.sqrt(2.0 * COMFORT_DECEL * d)


def _window(state: WorldState, n: int):
    R = state.route.shape[1]
    idx = state.criteria.route_idx
    widx = torch.clamp(idx[:, None] + torch.arange(n, device=idx.device), 0, R - 1)
    return idx, widx


def _gather_route(route, widx, cols):
    return torch.gather(route[..., cols], 1, widx[..., None].expand(-1, -1, len(cols)))


def red_sign_caps(cfg: Config, town: TownMap, state: WorldState):
    """(v_red, d_red, v_sign, d_sign), each (B,): the red-light and
    stop-sign speed caps. The governing light is the one whose stop line the
    ego's route crosses ahead (the criterion's geometry); a stop sign
    governs while it is ahead, aligned, within 3.5 m laterally and not yet
    stopped at, by longitudinal distance."""
    ego = state.ego
    cum = state.route_cumlen
    idx, widx = _window(state, W_RED)
    tl_states = traffic_light_states(town, state.time_s)
    wpts = _gather_route(state.route, widx, [0, 1])
    seg_yaw = _gather_route(state.route, widx[:, :-1], [2])[..., 0]
    crossing = segments_intersect(
        wpts[:, :-1, None], wpts[:, 1:, None],
        town.tl_stopline[:, 0], town.tl_stopline[:, 1],
    )                                                        # (B, W-1, NL)
    hd_ok = torch.abs(wrap_angle(town.tl_yaw - seg_yaw[..., None])) < math.pi / 3
    stopping = (tl_states == TL_RED) | (tl_states == TL_YELLOW)
    cand = crossing & hd_ok & stopping[:, None, :] & town.tl_valid
    seg_d = (torch.gather(cum, 1, widx[:, :-1])
             - torch.gather(cum, 1, idx[:, None]))
    d_red = torch.min(torch.where(torch.any(cand, dim=-1), seg_d, 1e4), dim=-1).values
    v_red = torch.where(d_red < 30.0, _stop_profile(d_red, 3.0),
                        torch.full_like(d_red, CRUISE))

    rel = town.stop_pos - ego.pos[:, None]                   # (B, NS, 2)
    d_stop = torch.linalg.norm(rel, dim=-1)
    fwd = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], dim=-1)
    ahead = rel[..., 0] * fwd[:, None, 0] + rel[..., 1] * fwd[:, None, 1]
    lat = torch.abs(rel[..., 0] * -fwd[:, None, 1] + rel[..., 1] * fwd[:, None, 0])
    aligned = torch.abs(wrap_angle(town.stop_yaw - ego.yaw[:, None])) < math.pi / 3
    pending = (
        town.stop_valid & aligned & (ahead > -1.0) & (d_stop < 12.0)
        & (lat < 3.5) & ~state.criteria.stop_has_stopped
    )
    d_sign = torch.min(
        torch.where(pending, torch.clamp_min(ahead, 0.0), 1e4), dim=-1
    ).values
    v_sign = torch.where(d_sign < 12.0, _stop_profile(d_sign, 1.5),
                         torch.full_like(d_sign, CRUISE))
    return v_red, d_red, v_sign, d_sign


def junction_yield(cfg: Config, town: TownMap, state: WorldState):
    """(v_yield, d_conf, w_arc), each (B,): stop before a crossing stream.
    Over the next W_YLD route points, a moving crossing vehicle whose ~4.5 s
    swept box covers a route point makes the ego stop 3 m short of it."""
    ego = state.ego
    cum = state.route_cumlen
    idx, yidx = _window(state, W_YLD)
    ypts = _gather_route(state.route, yidx, [0, 1])          # (B, W, 2)
    ryaws = _gather_route(state.route, yidx, [2])[..., 0]
    tr = state.traffic
    relp = ypts[:, :, None, :] - tr.pos[:, None, :, :]       # (B, W, V, 2)
    cv = torch.cos(tr.yaw)[:, None, :]
    sv = torch.sin(tr.yaw)[:, None, :]
    px = relp[..., 0] * cv + relp[..., 1] * sv
    py = -relp[..., 0] * sv + relp[..., 1] * cv
    sweep = torch.clamp(tr.speed * 4.5, 0.0, 18.0)
    infl = ego.extent[:, 1, None] + 0.4                      # (B, 1)
    reach_x = (tr.extent[..., 0] + infl)[:, None, :]
    hit = (
        (px > -reach_x)
        & (px < reach_x + sweep[:, None, :])
        & (torch.abs(py) < (tr.extent[..., 1] + infl)[:, None, :])
    )
    crossing_v = (
        torch.abs(wrap_angle(tr.yaw[:, None, :] - ryaws[..., None])) > math.pi / 4
    )
    conflict = hit & crossing_v & tr.active[:, None, :] & (tr.speed > 0.3)[:, None, :]
    cum0 = torch.gather(cum, 1, idx[:, None])
    d_conf = torch.min(
        torch.where(torch.any(conflict, dim=-1), torch.gather(cum, 1, yidx) - cum0, 1e4),
        dim=-1,
    ).values
    w_arc = torch.gather(cum, 1, yidx[:, -1:])[:, 0] - cum0[:, 0]
    v_yield = torch.where(d_conf < w_arc - 1.0, _stop_profile(d_conf, 3.0),
                          torch.full_like(d_conf, CRUISE))
    return v_yield, d_conf, w_arc
