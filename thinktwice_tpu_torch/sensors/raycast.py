"""Shared ray-casting core of the camera raster and the lidar (counterpart
of `thinktwice_tpu/sensors/raycast.py`).

The scene is analytic: a textured ground plane (the town rasters), oriented
boxes (vehicles, walkers) and traffic-light fixtures, intersected by one
slab test per ray and box: K2 (`ops/raycast_cuda.py`) on the card, its plain
version on the CPU. Every function takes a leading world axis B.

Semantic ids: 0 none/sky, 1 road, 2 sidewalk, 3 lane marking, 4 vehicle,
5 walker, 6 terrain, 7 pole, 8 tl_green, 9 tl_yellow, 10 tl_red.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.ops.raycast_cuda import MAX_T, box_table, ray_boxes_table

SEM_NONE, SEM_ROAD, SEM_SIDEWALK, SEM_LANE, SEM_VEHICLE, SEM_WALKER = 0, 1, 2, 3, 4, 5
SEM_TERRAIN, SEM_POLE, SEM_TL_GREEN, SEM_TL_YELLOW, SEM_TL_RED = 6, 7, 8, 9, 10
N_SEM_CLASSES = 11

VEHICLE_HEIGHT = 1.6
WALKER_HEIGHT = 1.8


def ray_ground(origins, dirs):
    """Rays vs the z = 0 plane: origins, dirs (..., 3) -> t (...,), MAX_T
    where there is no forward hit."""
    dz = dirs[..., 2]
    t = -origins[..., 2] / torch.where(torch.abs(dz) < 1e-9,
                                       torch.full_like(dz, -1e-9), dz)
    return torch.where((t > 0) & (dz < 0), t, torch.full_like(t, MAX_T))


def ray_boxes(origins, dirs, box_pose, box_active, grid=None):
    """Slab test against N upright boxes per world: origins, dirs (B, R, 3);
    box_pose (B, N, 6) x, y, yaw, ex, ey, z_top or (B, N, 7) with a trailing
    z_base; box_active (B, N). -> (t_min (B, R), idx (B, R)) of the nearest
    hit, MAX_T and -1 where there is none. K2 on the card, its plain
    version on the CPU; grid (rows, cols) as for ray_boxes_table."""
    return ray_boxes_table(origins, dirs, box_table(box_pose, box_active), grid=grid)


def sample_ground_semantic(town: TownMap, pts_xy):
    """Ground-plane semantics at world xy (..., 2) from the town rasters."""
    px = town.world_to_pixel(pts_xy)
    H, W = town.road.shape
    xi = torch.clamp(px[..., 0].to(torch.int64), 0, W - 1)
    yi = torch.clamp(px[..., 1].to(torch.int64), 0, H - 1)
    road = town.road[yi, xi] > 0
    side = town.sidewalk[yi, xi] > 0
    lane = town.lane_all[yi, xi] > 0
    return torch.where(
        lane & road, SEM_LANE,
        torch.where(road, SEM_ROAD, torch.where(side, SEM_SIDEWALK, SEM_TERRAIN)),
    )


def _pad7(pose):
    """Pad a (..., N, 6) box-pose array with a zero z_base column."""
    if pose.shape[-1] >= 7:
        return pose
    return torch.cat([pose, torch.zeros_like(pose[..., :1])], dim=-1)


def cast_scene(town: TownMap, origins, dirs, veh_pose, veh_active,
               wlk_pose, wlk_active, extra_pose=None, extra_active=None,
               extra_class=None, grid=None):
    """Full scene intersection of B worlds.

    origins, dirs (B, R, 3) world frame; veh_pose (B, V, 6); wlk_pose
    (B, W, 6); the optional extra_pose (B, E, 7) are classed static boxes
    (traffic_light_boxes) with per-box semantic ids extra_class (B, E).
    grid (rows, cols): the rays are views x rows x cols in row-major order
    (a camera's pixels, a lidar's beams), which lets K2 cull boxes per tile;
    the result does not depend on it.
    Returns dict: t (B, R) depth along the ray, semantic (B, R) int64,
    shade (B, R) in [0, 1], hit (B, R) bool."""
    B = origins.shape[0]
    V, W = veh_pose.shape[1], wlk_pose.shape[1]
    dev = origins.device
    t_g = ray_ground(origins, dirs)
    poses = [_pad7(veh_pose), _pad7(wlk_pose)]
    actives = [veh_active, wlk_active]
    classes = [torch.full((B, V), SEM_VEHICLE, dtype=torch.int64, device=dev),
               torch.full((B, W), SEM_WALKER, dtype=torch.int64, device=dev)]
    if extra_pose is not None:
        poses.append(extra_pose)
        actives.append(extra_active)
        classes.append(extra_class.to(torch.int64))
    class_table = torch.cat(classes, dim=1)
    t_b, idx_b = ray_boxes(origins, dirs, torch.cat(poses, dim=1),
                           torch.cat(actives, dim=1), grid=grid)

    hit_box = (idx_b >= 0) & (t_b <= t_g)
    hit_g = (t_g < MAX_T) & ~hit_box
    t = torch.minimum(t_g, t_b)

    ground_pts = origins[..., :2] + t_g[..., None] * dirs[..., :2]
    g_sem = sample_ground_semantic(town, ground_pts)
    box_sem = torch.gather(class_table, 1, torch.clamp_min(idx_b, 0))
    sem = torch.where(hit_box, box_sem,
                      torch.where(hit_g, g_sem, torch.full_like(g_sem, SEM_NONE)))
    # ground lit from above; boxes shaded by the view angle
    shade = torch.where(
        hit_g, 1.0,
        torch.clamp(0.45 + 0.55 * torch.abs(dirs[..., 2])
                    + 0.2 * torch.abs(dirs[..., 0]), 0.0, 1.0),
    )
    return {"t": torch.where(t < MAX_T, t, torch.zeros_like(t)), "semantic": sem,
            "shade": shade, "hit": t < MAX_T}


def box_pose_from_state(pos, yaw, extent, height: float):
    """(B, N, 2), (B, N), (B, N, 2), scalar -> (B, N, 6) box poses."""
    return torch.cat([pos, yaw[..., None], extent,
                      torch.full_like(yaw[..., None], height)], dim=-1)


# traffic-light fixture geometry (roadside signal: pole + elevated head)
TL_POLE_OFFSET_M = 3.2      # lateral offset from the stop point to the pole
TL_POLE_HALF_M = 0.15
TL_POLE_TOP_M = 4.6
TL_HEAD_HALF_M = 0.35
TL_HEAD_BASE_M = 4.6
TL_HEAD_TOP_M = 5.9


def traffic_light_boxes(town: TownMap, tl_states):
    """Camera-visible traffic-light fixtures of B worlds -> (pose (B, 2NL, 7),
    active (B, 2NL), class (B, 2NL)).

    Each light is a SEM_POLE pole at the right-hand roadside of its stop
    point plus an elevated head whose class follows the light's phase in
    tl_states (B, NL): 0/1/2 -> SEM_TL_GREEN/YELLOW/RED."""
    B = tl_states.shape[0]
    right = torch.stack([-torch.sin(town.tl_yaw), torch.cos(town.tl_yaw)], dim=-1)
    base = town.tl_pos + TL_POLE_OFFSET_M * right              # (NL, 2)
    nl = base.shape[0]
    col = town.tl_yaw[:, None]

    def fixture(half, top, bottom):
        return torch.cat([base, col, torch.full((nl, 2), half, device=base.device),
                          torch.full((nl, 1), top, device=base.device),
                          torch.full((nl, 1), bottom, device=base.device)], dim=-1)

    pose = torch.cat([fixture(TL_POLE_HALF_M, TL_POLE_TOP_M, 0.0),
                      fixture(TL_HEAD_HALF_M, TL_HEAD_TOP_M, TL_HEAD_BASE_M)], dim=0)
    active = torch.cat([town.tl_valid, town.tl_valid])
    cls = torch.cat([torch.full((B, nl), SEM_POLE, dtype=torch.int64, device=base.device),
                     SEM_TL_GREEN + tl_states.to(torch.int64)], dim=1)
    return (pose.expand(B, -1, -1), active.expand(B, -1), cls)
