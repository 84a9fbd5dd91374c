"""Ray-cast lidar of B worlds (counterpart of `thinktwice_tpu/sensors/lidar.py`).

Beams are a fixed (n_beams x n_azimuth) grid swept in full every tick.
Points come back in the ego frame as (B, P, 4) x, y, z, intensity, with a
validity mask (B, P). The weather's drop and jitter draws are an input
(`LidarDraws`), drawn from a torch.Generator when not given.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from thinktwice_tpu_torch import tracing
from thinktwice_tpu_torch.config import LidarConfig
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sensors.raycast import (
    VEHICLE_HEIGHT,
    WALKER_HEIGHT,
    box_pose_from_state,
    cast_scene,
)
from thinktwice_tpu_torch.sim.weather import W_RAIN, W_WETNESS


@dataclasses.dataclass(frozen=True)
class LidarDraws:
    """The random numbers of one sweep: keep_uniform (B, P) in [0, 1) (a
    return survives the rain where it exceeds 0.25 x rain), jitter_normal
    (B, P, 3) standard normals (range noise scaled by 0.03 x wetness)."""

    keep_uniform: torch.Tensor
    jitter_normal: torch.Tensor


def sample_lidar_draws(cfg: LidarConfig, n_worlds: int, device,
                       generator: torch.Generator | None = None) -> LidarDraws:
    P = cfg.n_beams * cfg.n_azimuth
    return LidarDraws(
        keep_uniform=torch.rand((n_worlds, P), generator=generator, device=device),
        jitter_normal=torch.randn((n_worlds, P, 3), generator=generator, device=device),
    )


def _beam_dirs(cfg: LidarConfig, device):
    """(B*A, 3) unit directions in the ego frame (x forward, z up)."""
    elev = torch.deg2rad(torch.linspace(cfg.upper_fov, cfg.lower_fov, cfg.n_beams,
                                        device=device))
    azim = torch.arange(cfg.n_azimuth, device=device, dtype=torch.float32) * (
        2 * math.pi / cfg.n_azimuth)
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    ca, sa = torch.cos(azim)[None, :], torch.sin(azim)[None, :]
    shape = (cfg.n_beams, cfg.n_azimuth)
    d = torch.stack([(ce * ca).expand(shape), (ce * sa).expand(shape),
                     se.expand(shape)], dim=-1)
    return d.reshape(-1, 3)


def render_lidar(cfg: LidarConfig, town: TownMap, ego_pos, ego_yaw,
                 veh_pose, veh_active, wlk_pose, wlk_active):
    """-> (points (B, P, 4) ego frame, mask (B, P))."""
    dirs_ego = _beam_dirs(cfg, ego_pos.device)                 # (P, 3)
    c, s = torch.cos(ego_yaw), torch.sin(ego_yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([torch.stack([c, -s, zero], -1),
                     torch.stack([s, c, zero], -1),
                     torch.stack([zero, zero, one], -1)], -2)  # (B, 3, 3)
    dirs = dirs_ego[None] @ R.transpose(-1, -2)                # (B, P, 3)
    origin = torch.cat([ego_pos, torch.full_like(c[:, None], cfg.z_mount)], dim=-1)
    origins = origin[:, None, :].expand_as(dirs).contiguous()

    hit = cast_scene(town, origins, dirs.contiguous(), veh_pose, veh_active,
                     wlk_pose, wlk_active, grid=(cfg.n_beams, cfg.n_azimuth))
    t = hit["t"]
    valid = hit["hit"] & (t > 0.5) & (t < cfg.max_range)
    pts_ego = dirs_ego[None] * t[..., None]
    pts_ego = pts_ego + torch.tensor([0.0, 0.0, cfg.z_mount], device=t.device)
    intensity = torch.clamp(1.0 - t / cfg.max_range, 0.0, 1.0)
    points = torch.cat([pts_ego, intensity[..., None]], dim=-1)
    return torch.where(valid[..., None], points, torch.zeros_like(points)), valid


def lidar_from_state(cfg: LidarConfig, town: TownMap, state,
                     draws: LidarDraws | None = None,
                     generator: torch.Generator | None = None):
    """The lidar of every world of a WorldState, with each world's rain
    dropping returns and its wetness jittering ranges."""
    with tracing.span("lidar_from_state"):
        veh_pose = box_pose_from_state(state.traffic.pos, state.traffic.yaw,
                                       state.traffic.extent, VEHICLE_HEIGHT)
        wlk_pose = box_pose_from_state(state.walkers.pos, state.walkers.yaw,
                                       state.walkers.extent, WALKER_HEIGHT)
        points, mask = render_lidar(cfg, town, state.ego.pos, state.ego.yaw,
                                    veh_pose, state.traffic.active, wlk_pose,
                                    state.walkers.active)
        if draws is None:
            draws = sample_lidar_draws(cfg, points.shape[0], points.device, generator)
        rain = state.weather[:, W_RAIN, None] / 100.0
        wet = state.weather[:, W_WETNESS, None, None] / 100.0
        mask = mask & (draws.keep_uniform > 0.25 * rain)
        jitter = 0.03 * wet * draws.jitter_normal
        xyz = points[..., :3] + torch.where(mask[..., None], jitter, torch.zeros_like(jitter))
        points = torch.cat([xyz, points[..., 3:]], dim=-1)
        return torch.where(mask[..., None], points, torch.zeros_like(points)), mask


def merge_sweeps(points_now, mask_now, points_prev, mask_prev, ego_now, ego_prev):
    """Two-sweep merge with ego-motion compensation and a timestamp channel:
    the previous sweep's points (B, P, 4) are re-expressed in the current ego
    frame and tagged dt = 1 in a 5th feature. ego_now, ego_prev are
    (pos (B, 2), yaw (B,)). -> (points (B, 2P, 5), mask (B, 2P))."""
    pos_now, yaw_now = ego_now
    pos_prev, yaw_prev = ego_prev
    cp, sp = torch.cos(yaw_prev)[:, None], torch.sin(yaw_prev)[:, None]
    cn, sn = torch.cos(-yaw_now)[:, None], torch.sin(-yaw_now)[:, None]
    px, py = points_prev[..., 0], points_prev[..., 1]
    # previous ego -> world -> current ego
    xw = px * cp - py * sp + pos_prev[:, 0, None]
    yw = px * sp + py * cp + pos_prev[:, 1, None]
    dx, dy = xw - pos_now[:, 0, None], yw - pos_now[:, 1, None]
    xn = dx * cn - dy * sn
    yn = dx * sn + dy * cn
    prev5 = torch.stack([xn, yn, points_prev[..., 2], points_prev[..., 3],
                         torch.ones_like(xn)], dim=-1)
    now5 = torch.cat([points_now, torch.zeros_like(points_now[..., :1])], dim=-1)
    points = torch.cat([now5, prev5], dim=1)
    mask = torch.cat([mask_now, mask_prev], dim=1)
    return torch.where(mask[..., None], points, torch.zeros_like(points)), mask
