"""Rule-based route-following autopilot for the ego vehicles of a batch of
worlds (counterpart of `thinktwice_tpu/agents/autopilot.py`), and the rule
caps that the Roach expert's brake shares with it.

Control law (`autopilot_control`):
- lateral: pure pursuit on an arc-length lookahead point (speed-adaptive,
  shrunk by the upcoming turn) plus a cross-track term;
- longitudinal: v_des = min(cruise, curve slowdown, red-light and stop-sign
  stop profiles, leader gap, junction yield), zero on the expert's hazard
  forecast, served by a throttle/brake law;
- anti-deadlock creep: blocked > 15 s with a clear path ahead -> creep.
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
from thinktwice_tpu_torch.sim.traffic import _front_gap

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


def _at(values, idx):
    """values (B, R) or (B, R, C) at the per-world index idx (B,)."""
    return values[torch.arange(idx.shape[0], device=idx.device), idx]


def autopilot_control(cfg: Config, town: TownMap, state: WorldState,
                      debug: bool = False):
    """-> (B, 3) control (steer, throttle, brake).

    With debug=True returns (control, dict of the v_des components, each
    (B,)) so a stall can be attributed to gap/red/sign/curve/hazard."""
    ego = state.ego
    route = state.route
    cum = state.route_cumlen
    idx = state.criteria.route_idx
    n = route.shape[1]
    cum0 = _at(cum, idx)
    ryaw = _at(route[..., 2], idx)

    def ahead_idx(meters):
        """(B,) first route index at least `meters` past the ego's point
        (searchsorted's left side, as jnp.searchsorted)."""
        j = torch.searchsorted(cum, (cum0 + meters)[:, None])[:, 0]
        return torch.clamp(j, 0, n - 1)

    def turn_ahead(meters):
        return torch.abs(wrap_angle(_at(route[..., 2], ahead_idx(meters)) - ryaw))

    # ---- lateral: arc-length pure pursuit, turn-shrunk lookahead ----------
    turn8 = turn_ahead(8.0)
    L = torch.clamp_min(
        torch.clamp(2.5 + 0.7 * ego.speed, 3.0, 8.0) - 3.0 * turn8, 2.0
    )
    target = _at(route[..., :2], ahead_idx(L))
    to_t = target - ego.pos
    bearing = torch.atan2(to_t[:, 1], to_t[:, 0])
    err = wrap_angle(bearing - ego.yaw)
    nvec = torch.stack([-torch.sin(ryaw), torch.cos(ryaw)], dim=-1)
    off = ego.pos - _at(route[..., :2], idx)
    xtrack = off[:, 0] * nvec[:, 0] + off[:, 1] * nvec[:, 1]   # +: ego left of route
    steer = torch.clamp(2.5 * err - 0.4 * xtrack, -1.0, 1.0)

    # ---- curvature slowdown ----------------------------------------------
    t10, t20 = turn_ahead(10.0), turn_ahead(20.0)
    cruise = torch.full_like(t10, CRUISE)
    v_curve = torch.where(t10 > 0.5, 2.2, torch.where(t10 > 0.25, 3.5, cruise))
    v_curve = torch.minimum(v_curve, torch.where(t20 > 0.5, 4.0, cruise))

    # ---- leader / crossing-actor gap -------------------------------------
    tr, wk = state.traffic, state.walkers
    all_pos = torch.cat([tr.pos, wk.pos], dim=1)
    all_yaw = torch.cat([tr.yaw, wk.yaw], dim=1)
    all_ext = torch.cat([tr.extent, wk.extent], dim=1)
    all_act = torch.cat([tr.active, wk.active], dim=1)
    no_self = torch.zeros((all_pos.shape[0], 1, all_pos.shape[1]), dtype=torch.bool,
                          device=all_pos.device)
    gap = _front_gap(ego.pos[:, None], ego.yaw[:, None], all_pos, all_yaw, all_ext,
                     all_act, no_self, self_ext_x=ego.extent[:, 0, None])[:, 0]
    v_gap = torch.clamp((gap - 2.5) / 1.2, 0.0, CRUISE)

    # ---- unsignalized-junction yield, red lights and stop signs -----------
    v_yield, d_conf, _ = junction_yield(cfg, town, state)
    v_red, d_red, v_sign, _ = red_sign_caps(cfg, town, state)

    v_des = torch.minimum(
        torch.minimum(v_curve, v_gap),
        torch.minimum(torch.minimum(v_red, v_sign), v_yield),
    )

    # ---- motion-forecast hazard (the expert's ego + actor forecast) -------
    from thinktwice_tpu_torch.agents.expert import hazard_brake

    hazard = hazard_brake(cfg, state)
    v_des = torch.where(hazard, torch.zeros_like(v_des), v_des)

    # ---- anti-deadlock creep: blocked long, nothing within 3 m, no red
    # line or crossing stream within 6 m
    creep = (
        (state.criteria.blocked_s > 15.0) & (gap > 3.0) & (d_red > 6.0)
        & (d_conf > 6.0)
    )
    v_des = torch.where(creep, torch.clamp_min(v_des, 1.5), v_des)

    # ---- throttle / brake -------------------------------------------------
    throttle = torch.clamp(0.9 * (v_des - ego.speed), 0.0, 0.85)
    brake = (ego.speed > v_des + 0.7) | ((v_des < 0.2) & (ego.speed > 0.05))
    brake = brake | (gap < 2.5)
    throttle = torch.where(brake, torch.zeros_like(throttle), throttle)
    control = torch.stack([steer, throttle, brake.to(torch.float32)], dim=-1)
    if debug:
        return control, dict(
            v_curve=v_curve, v_gap=v_gap, v_red=v_red, v_sign=v_sign,
            v_yield=v_yield, d_conf=d_conf,
            hazard=hazard, creep=creep, gap=gap, d_red=d_red,
        )
    return control
