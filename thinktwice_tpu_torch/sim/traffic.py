"""Background traffic: a vectorized stand-in for CARLA's TrafficManager
(counterpart of `thinktwice_tpu/sim/traffic.py`).

It follows the lane network at a cruise speed, keeps a speed-dependent gap
to the actor ahead (IDM-style), stops for red and yellow lights, yields at
junctions by motion forecast, holds short of a blocked junction exit and,
once the ego has waited long, yields to it. Every tensor carries a leading
world axis B; the O(V^2) pairwise logic runs for all worlds at once. The
reasons behind each rule are written at the same place in the JAX module.
"""

from __future__ import annotations

import math

import torch

from thinktwice_tpu_torch.config import SimConfig
from thinktwice_tpu_torch.geometry import segments_intersect, wrap_angle
from thinktwice_tpu_torch.maps.town import TL_RED, TL_YELLOW, TownMap

NPC_ZERO_GAP = 2.0   # bumper gap (m) at which a follower's desired speed is 0
NPC_YIELD_GAP = 1.8  # yield clamps sit below it, so they command a hard stop


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _norm(x):
    return torch.linalg.norm(x, dim=-1)


def _unit(yaw):
    return torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)


def _lookahead_target(town: TownMap, wp_idx, lookahead_m: float):
    """The lane point ~lookahead_m ahead, by chaining successor pointers
    (waypoints are ~2 m apart)."""
    idx = wp_idx
    for _ in range(int(lookahead_m // 2) + 1):
        idx = town.lane_next[idx]
    return town.lane_pts[idx]


def _advance_wp(town: TownMap, wp_idx, pos, yaw):
    """Advance the target waypoint: on proximity (2.5 m) or once passed
    abeam; re-lock onto the closest of the next 8 hops when the chain is
    near; re-acquire the nearest heading-compatible lane point when lost.
    wp_idx (B, V), pos (B, V, 2), yaw (B, V)."""
    target = town.lane_pts[wp_idx]
    d0 = _norm(target - pos)
    lane_dir = _unit(town.lane_yaw[wp_idx])
    beyond = _dot2(pos - target, lane_dir) > 0.0
    wp = torch.where((d0 < 2.5) | beyond, town.lane_next[wp_idx], wp_idx)
    best = wp
    best_d = _norm(town.lane_pts[wp] - pos)
    near_chain = best_d < 12.0
    cur = wp
    for _ in range(8):
        cur = town.lane_next[cur]
        dd = _norm(town.lane_pts[cur] - pos)
        better = (dd + 1.0 < best_d) & near_chain
        best = torch.where(better, cur, best)
        best_d = torch.where(better, dd, best_d)
    d_old = _norm(town.lane_pts[wp_idx] - pos)
    lost = (best_d > 12.0) & (d_old > 12.0)
    stride = 8
    cand_pts = town.lane_pts[::stride]
    cand_yaw = town.lane_yaw[::stride]
    cand_ok = town.lane_valid[::stride]
    dist = _norm(cand_pts[None, None, :, :] - pos[:, :, None, :])
    hd_ok = torch.abs(wrap_angle(cand_yaw - yaw[..., None])) < 1.3
    dist = torch.where(cand_ok & hd_ok, dist, 1e9)
    k = torch.argmin(dist, dim=-1)
    found = torch.gather(dist, -1, k[..., None])[..., 0] < 100.0
    near_idx = k * stride
    return torch.where(lost & found, near_idx, best)


def _front_gap(pos, yaw, all_pos, all_yaw, all_ext, all_active, self_mask,
               self_ext_x=None):
    """Bumper gap to the nearest actor that obstructs each deciding vehicle.

    pos (B, V, 2), yaw (B, V); all_* (B, A, ...) every collidable actor;
    self_mask broadcasts to (B, V, A). Returns (B, V), 1e4 when free. Two
    heading-aware bands: a tight path band for anything in my lane and a
    wider same-direction band for the leader through a curve."""
    fwd = _unit(yaw)
    right = torch.stack([-torch.sin(yaw), torch.cos(yaw)], dim=-1)
    rel = all_pos[:, None, :, :] - pos[:, :, None, :]          # (B, V, A, 2)
    along = _dot2(rel, fwd[:, :, None, :])
    lateral = torch.abs(_dot2(rel, right[:, :, None, :]))
    rel_hdg = wrap_angle(all_yaw[:, None, :] - yaw[:, :, None])
    same_dir = torch.abs(rel_hdg) < math.pi / 3
    crossing = torch.abs(torch.sin(rel_hdg))
    eff_w = (all_ext[:, None, :, 1] * (1.0 - crossing)
             + all_ext[:, None, :, 0] * crossing)
    in_path = lateral < 1.7 + eff_w
    in_lane = same_dir & (lateral < 2.2 + all_ext[:, None, :, 1])
    in_corridor = (
        (along > 0.1)
        & (along < 40.0)
        & (in_path | in_lane)
        & all_active[:, None, :]
        & ~self_mask
    )
    gap = along - all_ext[:, None, :, 0]
    if self_ext_x is not None:
        gap = gap - self_ext_x[..., None]
    gap = torch.where(in_corridor, gap, 1e4)
    return torch.min(gap, dim=-1).values


def _cross_conflict_yield(pos, yaw, speed, all_pos, all_yaw, all_speed,
                          all_active, self_mask, priority_over_me,
                          is_static_priority):
    """Junction arbitration by forecast: True (B, V) for vehicles whose
    straight-line forecast comes within a safety disc of a higher-priority
    actor's forecast ahead of them. Priority is strict (ego first, then the
    lower slot), so yield cycles cannot form."""
    ts = torch.tensor([0.6, 1.2, 1.8, 2.4], device=pos.device)
    my_fwd = _unit(yaw)                                         # (B, V, 2)
    my_v = my_fwd * torch.clamp_min(speed, 1.5)[..., None]
    my_t = pos[:, :, None, :] + ts[:, None] * my_v[:, :, None, :]  # (B, V, T, 2)
    o_v = _unit(all_yaw) * all_speed[..., None]
    o_t = all_pos[:, :, None, :] + ts[:, None] * o_v[:, :, None, :]  # (B, A, T, 2)
    d = _norm(my_t[:, :, None, :, :] - o_t[:, None, :, :, :])     # (B, V, A, T)
    rel_now = all_pos[:, None, :, :] - pos[:, :, None, :]
    ahead = _dot2(rel_now, my_fwd[:, :, None, :]) > -2.0
    moving = all_speed > 0.5
    disc = torch.where(is_static_priority & ~(all_speed > 0.5), 2.4, 3.0)
    conflict = (
        torch.any(d < disc[:, None, :, None], dim=-1)
        & ahead
        & (moving | is_static_priority)[:, None, :]
        & all_active[:, None, :]
        & ~self_mask
        & priority_over_me
    )
    return torch.any(conflict, dim=-1)


def _approach_line_dist(town: TownMap, pos, yaw):
    """Distance (B, V) to the nearest aligned stop line ahead, and its index.
    The lateral bound covers the stop line's span and the heading cone is
    the red-light criterion's pi/3."""
    fwd = _unit(yaw)
    rel = town.tl_pos[None, None, :, :] - pos[:, :, None, :]    # (B, V, NL, 2)
    along = _dot2(rel, fwd[:, :, None, :])
    lateral = torch.abs(
        rel[..., 0] * (-torch.sin(yaw))[..., None]
        + rel[..., 1] * torch.cos(yaw)[..., None]
    )
    half_len = 0.5 * _norm(town.tl_stopline[:, 1] - town.tl_stopline[:, 0])
    lat_bound = torch.clamp_min(half_len + 1.0, 3.0)
    heading_ok = (
        torch.abs(wrap_angle(town.tl_yaw - yaw[..., None])) < math.pi / 3
    )
    cand = (along > -2.0) & (lateral < lat_bound) & heading_ok & town.tl_valid
    along_c = torch.where(cand, along, 1e4)
    d_near, k = torch.min(along_c, dim=-1)
    # torch.min's index is that of the first minimum, like jnp.argmin
    return d_near, k


def _red_light_dist(town: TownMap, tl_states, pos, yaw):
    """Distance to MY approach stop line when it is red or yellow, else 1e4."""
    d_near, k = _approach_line_dist(town, pos, yaw)
    near_state = torch.gather(tl_states, -1, k)
    stopping = (near_state == TL_RED) | (near_state == TL_YELLOW)
    return torch.where(stopping & (d_near < 1e3), d_near, 1e4)


def ego_red_ahead(town: TownMap, tl_states, route_win):
    """(B,) True when a red or yellow stop line crosses the ego's next route
    window route_win (B, K, 3): the ego is lawfully held."""
    pts = route_win[..., :2]
    seg_yaw = route_win[:, :-1, 2]
    crossing = segments_intersect(
        pts[:, :-1, None], pts[:, 1:, None],
        town.tl_stopline[:, 0], town.tl_stopline[:, 1],
    )                                                           # (B, K-1, NL)
    hd_ok = torch.abs(wrap_angle(town.tl_yaw - seg_yaw[..., None])) < math.pi / 3
    stopping = (tl_states == TL_RED) | (tl_states == TL_YELLOW)
    hit = crossing & hd_ok & stopping[:, None, :] & town.tl_valid
    return torch.any(hit.flatten(1), dim=-1)


def traffic_policy(cfg: SimConfig, town: TownMap, tl_states, veh_pos, veh_yaw,
                   veh_speed, veh_ext, veh_wp, veh_active, ego_pos, ego_yaw,
                   ego_ext, ego_speed, wlk_pos, wlk_ext, wlk_active,
                   ego_route=None, ego_slow_s=None, ego_held_red=None):
    """(yaw_rate, accel, new_wp_idx, loop_jump) for every traffic vehicle of
    every world: veh_* (B, V, ...), ego_* (B, ...), wlk_* (B, W, ...),
    tl_states (B, NL), ego_route (B, K, 2)."""
    B, V = veh_pos.shape[:2]
    dev = veh_pos.device

    # steering: pure pursuit on the lane lookahead point
    target = _lookahead_target(town, veh_wp, cfg.npc_lookahead)
    to_t = target - veh_pos
    bearing = torch.atan2(to_t[..., 1], to_t[..., 0])
    err = wrap_angle(bearing - veh_yaw)
    yaw_rate = torch.clamp(err / 0.5, -cfg.npc_max_yaw_rate, cfg.npc_max_yaw_rate)

    # longitudinal: IDM-lite over the pooled actors (traffic, ego, walkers)
    n_w = wlk_pos.shape[1]
    zeros_w = torch.zeros((B, n_w), device=dev)
    all_pos = torch.cat([veh_pos, ego_pos[:, None], wlk_pos], dim=1)
    all_yaw = torch.cat([veh_yaw, ego_yaw[:, None], zeros_w], dim=1)
    all_ext = torch.cat([veh_ext, ego_ext[:, None], wlk_ext], dim=1)
    all_active = torch.cat(
        [veh_active, torch.ones((B, 1), dtype=torch.bool, device=dev), wlk_active],
        dim=1,
    )
    A = all_pos.shape[1]
    my_idx = torch.arange(V, device=dev)[:, None]
    ot_idx = torch.arange(A, device=dev)[None, :]
    self_mask = ot_idx == my_idx                                 # (V, A)
    gap = _front_gap(veh_pos, veh_yaw, all_pos, all_yaw, all_ext, all_active,
                     self_mask, self_ext_x=veh_ext[..., 0])

    d_red = _red_light_dist(town, tl_states, veh_pos, veh_yaw)
    gap = torch.minimum(
        gap, torch.where(d_red < cfg.tl_stop_distance, d_red - 2.0, 1e4)
    )

    # junction crossing arbitration: ego (slot V) > lower NPC slot
    all_speed = torch.cat([veh_speed, ego_speed[:, None], zeros_w], dim=1)
    priority = (ot_idx == V) | (ot_idx < my_idx)
    must_yield = _cross_conflict_yield(
        veh_pos, veh_yaw, veh_speed, all_pos, all_yaw, all_speed,
        all_active, self_mask, priority,
        is_static_priority=(ot_idx == V)[0],
    )
    # lane-following forecast against the ego's box, ~16 m of lane ahead
    path_idx = veh_wp
    path_pts, path_yaws = [], []
    for _ in range(8):
        path_idx = town.lane_next[path_idx]
        path_pts.append(town.lane_pts[path_idx])
        path_yaws.append(town.lane_yaw[path_idx])
    path = torch.stack(path_pts, dim=2)                          # (B, V, 8, 2)
    path_yaw = torch.stack(path_yaws, dim=2)                     # (B, V, 8)
    rel_path = path - ego_pos[:, None, None, :]
    ce = torch.cos(-ego_yaw)[:, None, None]
    se = torch.sin(-ego_yaw)[:, None, None]
    px = rel_path[..., 0] * ce - rel_path[..., 1] * se
    py = rel_path[..., 0] * se + rel_path[..., 1] * ce
    infl_x = ego_ext[:, 0, None, None] + veh_ext[..., 1:2] + 0.5  # (B, V, 1)
    infl_y = ego_ext[:, 1, None, None] + veh_ext[..., 1:2] + 0.5
    in_box = (torch.abs(px) < infl_x) & (torch.abs(py) < infl_y)
    reach_hops = torch.clamp_min(veh_speed * 3.0 / 2.0, 2.0)
    hop_i = torch.arange(1, 9, dtype=torch.float32, device=dev)
    within = hop_i <= reach_hops[..., None]
    crossing_pt = (
        torch.abs(wrap_angle(path_yaw - ego_yaw[:, None, None])) > math.pi / 4
    )
    lane_conflict = torch.any(in_box & within & crossing_pt, dim=-1)
    gap = torch.where(must_yield | lane_conflict,
                      torch.clamp_max(gap, NPC_YIELD_GAP), gap)

    # junction-box holdback: do not cross my stop line while a stopped
    # vehicle occupies my lane path beyond the junction
    d_line, _ = _approach_line_dist(town, veh_pos, veh_yaw)
    far_path = path[:, :, 3:, :]                                 # hops 4..8
    vdist = _norm(far_path[:, :, :, None, :] - all_pos[:, None, None, :, :])
    stopped_there = (
        (vdist < 2.5)
        & (all_speed[:, None, None, :] < 0.5)
        & all_active[:, None, None, :]
        & ~self_mask[None, :, None, :]
    )
    exit_blocked = torch.any(stopped_there.flatten(2), dim=-1)
    hold = (d_line > 1.0) & (d_line < 10.0) & exit_blocked
    gap = torch.where(hold, torch.minimum(gap, d_line - 2.0), gap)

    # courtesy yield to a long-blocked ego (liveness rule)
    if ego_route is not None and cfg.courtesy_yield:
        dseg = _norm(path[:, :, :, None, :] - ego_route[:, None, None, :, :])
        band = veh_ext[..., 1:2, None] + ego_ext[:, 1, None, None, None] + 3.0
        conf_hop = torch.any(dseg < band, dim=-1)                # (B, V, 8)
        has_conf = torch.any(conf_hop, dim=-1)
        first = torch.argmax(conf_hop.to(torch.int32), dim=-1)
        d_conf = (first.to(torch.float32) + 1.0) * 2.0
        near_ego = _norm(veh_pos - ego_pos[:, None]) < 40.0
        d_self = torch.min(
            _norm(veh_pos[:, :, None, :] - ego_route[:, None, :, :]), dim=-1
        ).values
        in_band = d_self < (veh_ext[..., 1] + ego_ext[:, 1, None] + 3.0)
        courteous = (
            (ego_slow_s[:, None] > 25.0) & has_conf & near_ego & ~in_band
            & ~ego_held_red[:, None]
        )
        gap = torch.where(courteous, torch.minimum(gap, d_conf - 8.0), gap)

    # per-vehicle cruise diversity: golden-ratio spread of 0.8x..1.2x
    slot = torch.arange(V, dtype=torch.float32, device=dev)
    cruise = cfg.npc_cruise_speed * (
        0.8 + 0.4 * torch.remainder(slot * 0.618034, 1.0)
    )

    desired_gap = cfg.npc_gap + veh_speed * cfg.npc_time_headway
    v_des = torch.where(
        gap < desired_gap,
        cruise * torch.clamp((gap - NPC_ZERO_GAP)
                             / torch.clamp_min(desired_gap, 1e-3), 0.0, 1.0),
        cruise,
    )
    # slow through turns: cap speed by the lane heading change ~8 m ahead
    wp_ahead = veh_wp
    for _ in range(4):
        wp_ahead = town.lane_next[wp_ahead]
    turn = torch.abs(wrap_angle(town.lane_yaw[wp_ahead] - veh_yaw))
    v_turn = torch.where(turn > 0.6, 2.5, torch.where(turn > 0.3, 4.0, 1e4))
    v_des = torch.minimum(v_des, v_turn)
    accel = torch.clamp((v_des - veh_speed) / 0.5, -cfg.npc_decel, cfg.npc_accel)

    new_wp = _advance_wp(town, veh_wp, veh_pos, veh_yaw)
    # a successor far from the vehicle is a route-loop link: the step
    # teleports it instead of driving cross-country
    loop_jump = (new_wp != veh_wp) & (
        _norm(town.lane_pts[new_wp] - veh_pos) > 6.0
    )
    return yaw_rate, accel, new_wp, loop_jump
