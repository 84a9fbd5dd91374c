"""Multi-camera RGB / depth / semantic raster of B worlds (counterpart of
`thinktwice_tpu/sensors/camera.py`).

RGB from the semantic palette and lambert shading, depth in meters along
the optical axis, and the semantic ids, all from one `cast_scene` over the
rays of every camera of every world (one K2 launch on the card). Ideal
pinhole cameras (models/rig.py). The weather's rain noise is an input
(`rain_noise`), drawn from a torch.Generator when not given.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.config import CameraConfig
from thinktwice_tpu_torch.maps.town import TownMap, traffic_light_states
from thinktwice_tpu_torch.models import rig as rig_lib
from thinktwice_tpu_torch.sensors.raycast import (
    VEHICLE_HEIGHT,
    WALKER_HEIGHT,
    box_pose_from_state,
    cast_scene,
    traffic_light_boxes,
)
from thinktwice_tpu_torch.sim.weather import (
    W_ALTITUDE,
    W_CLOUD,
    W_FOG_DENSITY,
    W_FOG_FALLOFF,
    W_RAIN,
)

# semantic id -> RGB (coarse CARLA-like palette)
PALETTE = torch.tensor(
    [
        [70, 130, 180],    # 0 sky
        [90, 90, 90],      # 1 road
        [160, 160, 160],   # 2 sidewalk
        [230, 230, 230],   # 3 lane marking
        [30, 60, 150],     # 4 vehicle
        [220, 20, 60],     # 5 walker
        [70, 120, 50],     # 6 terrain
        [140, 140, 120],   # 7 pole
        [0, 220, 0],       # 8 tl green
        [230, 220, 0],     # 9 tl yellow
        [230, 0, 0],       # 10 tl red
    ],
    dtype=torch.float32,
) / 255.0


def _pixel_rays(cfg: CameraConfig, device):
    """Camera-frame unit ray directions of every pixel -> (H, W, 3)."""
    K = rig_lib.intrinsics(cfg)
    fx, fy, cx, cy = (float(v) for v in (K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    us = torch.arange(cfg.width, dtype=torch.float32, device=device) + 0.5
    vs = torch.arange(cfg.height, dtype=torch.float32, device=device) + 0.5
    x = ((us[None, :] - cx) / fx).expand(cfg.height, cfg.width)
    y = ((vs[:, None] - cy) / fy).expand(cfg.height, cfg.width)
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def camera_rays(cfg: CameraConfig, ego_pos, ego_yaw):
    """World-frame rays of every pixel of every camera of B worlds ->
    (origins (B, N*H*W, 3), dirs (B, N*H*W, 3), R (B, N, 3, 3) cam->world
    rotations)."""
    dev = ego_pos.device
    B = ego_pos.shape[0]
    cam_dirs = _pixel_rays(cfg, dev).reshape(-1, 3)                # (HW, 3)
    c2e = torch.as_tensor(rig_lib.cam_to_ego(cfg), device=dev)     # (N, 4, 4)
    ce, se = torch.cos(ego_yaw), torch.sin(ego_yaw)
    zero, one = torch.zeros_like(ce), torch.ones_like(ce)
    R_ego = torch.stack([torch.stack([ce, -se, zero], -1),
                         torch.stack([se, ce, zero], -1),
                         torch.stack([zero, zero, one], -1)], -2)  # (B, 3, 3)
    R = R_ego[:, None] @ c2e[None, :, :3, :3]                      # (B, N, 3, 3)
    origin_world = torch.cat([ego_pos, zero[:, None]], dim=-1)     # (B, 3)
    t = origin_world[:, None] + (R_ego[:, None] @ c2e[None, :, :3, 3:4])[..., 0]
    dirs = torch.einsum("bnij,rj->bnri", R, cam_dirs)              # (B, N, HW, 3)
    origins = t[:, :, None, :].expand_as(dirs)
    n = dirs.shape[1] * dirs.shape[2]
    return origins.reshape(B, n, 3), dirs.reshape(B, n, 3), R


def render_cameras(cfg: CameraConfig, town: TownMap, ego_pos, ego_yaw,
                   veh_pose, veh_active, wlk_pose, wlk_active, tl_states=None,
                   weather=None, rain_noise=None, generator=None):
    """B worlds' cameras -> dict rgb (B, N, H, W, 3) in [0, 1], depth
    (B, N, H, W) meters along the optical axis, semantic (B, N, H, W) int64.

    veh_pose (B, V, 6) and wlk_pose (B, W, 6) from box_pose_from_state;
    tl_states (B, NL) renders the light fixtures when given; weather (B, 10)
    modulates light, fog and rain, with rain_noise (B, N, H, W, 3) standard
    normals (drawn from generator when not given)."""
    extra = (None, None, None)
    if tl_states is not None:
        extra = traffic_light_boxes(town, tl_states)
    B = ego_pos.shape[0]
    N, H, W = cfg.n_cams, cfg.height, cfg.width
    origins, dirs, R = camera_rays(cfg, ego_pos, ego_yaw)
    hit = cast_scene(town, origins, dirs, veh_pose, veh_active, wlk_pose,
                     wlk_active, extra_pose=extra[0], extra_active=extra[1],
                     extra_class=extra[2], grid=(H, W))
    sem = hit["semantic"].reshape(B, N, H, W)
    rgb = PALETTE.to(origins.device)[sem] * hit["shade"].reshape(B, N, H, W)[..., None]
    # distance along the optical axis (z-depth), like a depth camera
    z_axis = R[..., :, 2]                                          # (B, N, 3)
    cos_z = (dirs.reshape(B, N, H * W, 3) * z_axis[:, :, None, :]).sum(-1)
    zdepth = hit["t"].reshape(B, N, H * W) * cos_z
    depth = torch.where(hit["hit"].reshape(B, N, H * W), zdepth,
                        torch.zeros_like(zdepth)).reshape(B, N, H, W)
    if weather is not None:
        if rain_noise is None:
            rain_noise = torch.randn(rgb.shape, generator=generator,
                                     device=rgb.device)
        rgb = apply_weather(rgb, depth, sem, weather, rain_noise)
    return {"rgb": rgb, "depth": depth, "semantic": sem}


def apply_weather(rgb, depth, sem, weather, rain_noise=None):
    """Photometric weather over B worlds' frames: rgb (B, N, H, W, 3), depth
    and sem (B, N, H, W), weather (B, 10).

    Sun altitude sets the ambient brightness (night floor 0.15); cloudiness
    dims and desaturates; fog blends toward the sky colour with the optical
    depth along the ray; precipitation adds rain_noise (standard normals of
    rgb's shape) scaled by 0.08 x rain, when given."""
    def per_world(v):
        return v.reshape(-1, *([1] * (rgb.dim() - 1)))

    alt = torch.deg2rad(weather[:, W_ALTITUDE])
    sun = torch.clamp(torch.sin(alt), 0.0, 1.0)
    brightness = 0.15 + 0.85 * sun
    cloud = weather[:, W_CLOUD] / 100.0
    brightness = per_world(brightness * (1.0 - 0.25 * cloud))
    cloud = per_world(cloud)
    gray = torch.mean(rgb, dim=-1, keepdim=True)
    out = (rgb * (1.0 - 0.3 * cloud) + gray * 0.3 * cloud) * brightness

    sigma = weather[:, W_FOG_DENSITY] / 100.0 * 0.03 * torch.clamp_min(
        weather[:, W_FOG_FALLOFF], 0.1)
    hit = (sem > 0) | (depth > 0)
    trans = torch.where(hit, torch.exp(-per_world(sigma)[..., 0] * depth),
                        torch.ones_like(depth))[..., None]
    fog_color = torch.tensor([0.65, 0.66, 0.68], device=rgb.device) * brightness
    out = out * trans + fog_color * (1.0 - trans)

    if rain_noise is not None:
        rain = per_world(weather[:, W_RAIN] / 100.0)
        out = out + 0.08 * rain * rain_noise
    return torch.clamp(out, 0.0, 1.0)


def cameras_from_state(cfg: CameraConfig, town: TownMap, state,
                       rain_noise=None, generator=None):
    """The cameras of every world of a WorldState, with the live light
    phases and each world's weather."""
    veh_pose = box_pose_from_state(state.traffic.pos, state.traffic.yaw,
                                   state.traffic.extent, VEHICLE_HEIGHT)
    wlk_pose = box_pose_from_state(state.walkers.pos, state.walkers.yaw,
                                   state.walkers.extent, WALKER_HEIGHT)
    return render_cameras(
        cfg, town, state.ego.pos, state.ego.yaw,
        veh_pose, state.traffic.active, wlk_pose, state.walkers.active,
        tl_states=traffic_light_states(town, state.time_s),
        weather=state.weather, rain_noise=rain_noise, generator=generator,
    )
