"""Per-step infraction detectors: the leaderboard criteria for a batch of
worlds (counterpart of `thinktwice_tpu/sim/criteria.py`).

Collisions (analytic OBB tests plus a curb test on the rasters), route
completion by windowed projection, route deviation, off-lane meters, red
lights (stop-line crossing), stop signs (zone state machine), the blocked
timer and the route timeout. Every input carries the world axis B.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.ttref.config import Config
from port_bench.reference.ttref.geometry import (
    box_corners,
    obb_overlap,
    segments_intersect,
    wrap_angle,
)
from port_bench.reference.ttref.maps.town import TL_RED, TownMap
from port_bench.reference.ttref.sim.state import CriteriaState, Events

ROUTE_WINDOW = 64  # waypoints scanned ahead of the current match (~64 m)
CURB_PEN = 0.3     # m of box intrusion over the curb that counts as a hit


def _sample_raster(raster, town: TownMap, xy):
    """Nearest-neighbour sample of a (H, W) raster at world points (..., 2)."""
    px = town.world_to_pixel(xy)
    xi = torch.clamp(px[..., 0].to(torch.int64), 0, raster.shape[1] - 1)
    yi = torch.clamp(px[..., 1].to(torch.int64), 0, raster.shape[0] - 1)
    return raster[yi, xi]


def update_criteria(cfg: Config, town: TownMap, crit: CriteriaState, prev_pos,
                    ego_pos, ego_yaw, ego_speed, ego_ext, veh_pos, veh_yaw,
                    veh_ext, veh_active, wlk_pos, wlk_yaw, wlk_ext, wlk_active,
                    tl_states, route, route_cumlen, route_len_m, time_s):
    """-> (CriteriaState', Events) for B worlds."""
    sim = cfg.sim
    B = ego_pos.shape[0]
    dev = ego_pos.device

    # ---- collisions ------------------------------------------------------
    hit_veh_each = obb_overlap(
        ego_pos[:, None], ego_yaw[:, None], ego_ext[:, None],
        veh_pos, veh_yaw, veh_ext,
    ) & veh_active
    hit_wlk_each = obb_overlap(
        ego_pos[:, None], ego_yaw[:, None], ego_ext[:, None],
        wlk_pos, wlk_yaw, wlk_ext,
    ) & wlk_active
    hit_veh = torch.any(hit_veh_each, dim=-1)
    hit_wlk = torch.any(hit_wlk_each, dim=-1)
    # static layout: a box shrunk by CURB_PEN (corners and long-edge
    # midpoints) on sidewalk and not on road
    inner_ext = torch.clamp_min(ego_ext[:, :2] - CURB_PEN, 0.1)
    corners = box_corners(ego_pos, ego_yaw, inner_ext)            # (B, 4, 2)
    fwd = torch.stack([torch.cos(ego_yaw), torch.sin(ego_yaw)], dim=-1)
    right = torch.stack([-fwd[:, 1], fwd[:, 0]], dim=-1)
    mids = ego_pos[:, None] + torch.stack([
        right * inner_ext[:, 1, None], -right * inner_ext[:, 1, None],
        fwd * inner_ext[:, 0, None], -fwd * inner_ext[:, 0, None],
    ], dim=1)
    probes = torch.cat([corners, mids], dim=1)                    # (B, 8, 2)
    on_sw = _sample_raster(town.sidewalk, town, probes) > 0
    on_rd = _sample_raster(town.road, town, probes) > 0
    hit_static = torch.any(on_sw & ~on_rd, dim=-1)

    overlapping = torch.stack([hit_veh, hit_wlk, hit_static], dim=-1)  # (B, 3)
    rising = overlapping & ~crit.collision_latch
    candidate = rising & (crit.collision_cd <= 0.0)
    d_last = torch.linalg.norm(ego_pos - crit.coll_pos, dim=-1)
    loc_valid = crit.coll_pos_valid & (d_last <= 5.0)
    loc_blocked = loc_valid & (d_last <= 3.0)
    new_event = candidate & ~loc_blocked[:, None]
    counted = torch.any(new_event, dim=-1)
    new_coll_pos = torch.where(counted[:, None], ego_pos, crit.coll_pos)
    new_coll_valid = counted | loc_valid
    new_cd = torch.where(
        new_event, torch.full_like(crit.collision_cd, 5.0),
        torch.clamp_min(crit.collision_cd - sim.dt, 0.0),
    )
    ev_veh, ev_wlk, ev_static = new_event[:, 0], new_event[:, 1], new_event[:, 2]

    # ---- red light: crossed a red stop line this step --------------------
    crossed = segments_intersect(
        prev_pos[:, None], ego_pos[:, None],
        town.tl_stopline[:, 0], town.tl_stopline[:, 1],
    )                                                             # (B, NL)
    heading_ok = torch.abs(wrap_angle(town.tl_yaw - ego_yaw[:, None])) < math.pi / 3
    ran_red_each = (
        crossed & (tl_states == TL_RED) & heading_ok & town.tl_valid
        & ~crit.tl_latch
    )
    ev_red = torch.any(ran_red_each, dim=-1)
    new_tl_latch = crit.tl_latch | ran_red_each

    # ---- stop signs -------------------------------------------------------
    d_stop = torch.linalg.norm(town.stop_pos - ego_pos[:, None], dim=-1)
    aligned = torch.abs(wrap_angle(town.stop_yaw - ego_yaw[:, None])) < math.pi / 3
    in_zone = (d_stop < 4.0) & aligned & town.stop_valid
    stopped_now = ego_speed < sim.blocked_speed
    new_has_stopped = crit.stop_has_stopped | (crit.stop_in_zone & stopped_now[:, None])
    exited = crit.stop_in_zone & ~in_zone
    ran_stop_each = exited & ~new_has_stopped
    ev_stop = torch.any(ran_stop_each, dim=-1)
    new_has_stopped = torch.where(exited, False, new_has_stopped)

    # ---- route progress (windowed projection) ----------------------------
    R = route.shape[1]
    idx0 = crit.route_idx
    offs = torch.arange(ROUTE_WINDOW, device=dev)
    win_idx = torch.clamp(idx0[:, None] + offs, 0, R - 1)         # (B, Wn)
    win_pts = torch.gather(route[..., :2], 1, win_idx[..., None].expand(-1, -1, 2))
    d = torch.linalg.norm(win_pts - ego_pos[:, None], dim=-1)
    min_route_dist, best = torch.min(d, dim=-1)
    best_idx = torch.gather(win_idx, 1, best[:, None])[:, 0]
    new_route_idx = torch.maximum(idx0, best_idx)
    completion = (torch.gather(route_cumlen, 1, new_route_idx[:, None])[:, 0]
                  / torch.clamp_min(route_len_m, 1e-3))

    finished = (completion > 0.99) & (
        torch.linalg.norm(route[:, -1, :2] - ego_pos, dim=-1) < 10.0
    )
    ev_complete = finished & ~crit.finished
    deviation = min_route_dist > sim.offroute_allowance

    # ---- outside route lanes: off-road or wrong-way meters ----------------
    step_dist = torch.linalg.norm(ego_pos - prev_pos, dim=-1)
    on_road = _sample_raster(town.road, town, ego_pos) > 0
    d_lane = torch.linalg.norm(town.lane_pts - ego_pos[:, None], dim=-1)  # (B, L)
    d_lane = torch.where(town.lane_valid, d_lane, 1e9)
    ang_lane = torch.abs(wrap_angle(town.lane_yaw - ego_yaw[:, None]))
    near = d_lane < 3.0
    best_near_ang = torch.min(torch.where(near, ang_lane, math.inf), dim=-1).values
    nearest_ang = torch.gather(ang_lane, 1, torch.argmin(d_lane, dim=-1)[:, None])[:, 0]
    eff_ang = torch.where(torch.any(near, dim=-1), best_near_ang, nearest_ang)
    wrong_way = (eff_ang > 2.0 * math.pi / 3.0) & (ego_speed > 0.5)
    new_dist_driven = crit.dist_driven + step_dist
    new_dist_offlane = crit.dist_offlane + torch.where(
        ~on_road | wrong_way, step_dist, torch.zeros_like(step_dist)
    )

    # ---- blocked / timeout -------------------------------------------------
    zero = torch.zeros((B,), device=dev)
    new_blocked_s = torch.where(ego_speed < sim.blocked_speed,
                                crit.blocked_s + sim.dt, zero)
    blocked = new_blocked_s > sim.blocked_time
    new_slow_s = torch.where(ego_speed < 2.0, crit.slow_s + sim.dt, zero)
    timeout = time_s > (sim.timeout_per_meter * route_len_m + sim.timeout_base)

    new_finished = crit.finished | finished
    done = crit.done | blocked | timeout | deviation | new_finished

    new_crit = CriteriaState(
        n_collision_vehicle=crit.n_collision_vehicle + ev_veh.to(torch.int64),
        n_collision_walker=crit.n_collision_walker + ev_wlk.to(torch.int64),
        n_collision_static=crit.n_collision_static + ev_static.to(torch.int64),
        n_red_light=crit.n_red_light + ev_red.to(torch.int64),
        n_stop_sign=crit.n_stop_sign + ev_stop.to(torch.int64),
        collision_latch=overlapping,
        collision_cd=new_cd,
        coll_pos=new_coll_pos,
        coll_pos_valid=new_coll_valid,
        tl_latch=new_tl_latch,
        stop_in_zone=in_zone,
        stop_has_stopped=new_has_stopped,
        route_idx=new_route_idx,
        route_completion=torch.maximum(crit.route_completion, completion),
        route_deviation=crit.route_deviation | deviation,
        dist_driven=new_dist_driven,
        dist_offlane=new_dist_offlane,
        blocked_s=new_blocked_s,
        blocked=crit.blocked | blocked,
        slow_s=new_slow_s,
        timeout=crit.timeout | timeout,
        finished=new_finished,
        done=done,
        ticks=crit.ticks + 1,
    )
    events = Events(
        collision_vehicle=ev_veh,
        collision_walker=ev_wlk,
        collision_static=ev_static,
        red_light=ev_red,
        stop_sign=ev_stop,
        route_complete=ev_complete,
    )
    return new_crit, events
