"""Dataset collection in the loop (counterpart of
`thinktwice_tpu/train/collect.py`): the Roach expert drives B worlds, the
cameras and the lidar render every saved frame (K1 in the expert, K2 twice
a frame on the card), and `frames_to_batch` turns each world's trajectory
into training examples with future-frame targets: waypoints in the current
ego frame, future Roach actions and feature grids, the history sweep of the
previous frame and its two-sweep lidar merge.

The random numbers are inputs (each tick's StepDraws and each frame's
SensorDraws), drawn from a generator when not given. Tensors keep an
explicit world axis: frames and sensors are (B, F, ...), a batch holds
B x (F - pred_len - (n_sweeps - 1)) examples, world-major.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from thinktwice_tpu_torch.agents.expert import (
    drive_frame,
    expert_control,
    make_frame,
    stack_frames,
)
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.geometry import sweep_to_key
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sensors.camera import cameras_from_state
from thinktwice_tpu_torch.sensors.lidar import lidar_from_state, merge_sweeps

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# command classes (RoadOption - 1)
CMD_LEFT, CMD_RIGHT, CMD_STRAIGHT = 0, 1, 2
CMD_LANEFOLLOW, CMD_CHANGELEFT, CMD_CHANGERIGHT = 3, 4, 5


def route_command(town: TownMap, route, route_idx, lookahead_pts: int = 35):
    """6-way command class of B worlds from the route geometry ahead: route
    (B, R, 3), route_idx (B,) -> (B,) int64.

    The heading change over the next lookahead_pts points classifies turns;
    a small heading change with a large lateral displacement classifies lane
    changes; a small change near a signalized junction is STRAIGHT, else
    LANEFOLLOW."""
    B, R, _ = route.shape
    b = torch.arange(B, device=route.device)
    j = torch.clamp(route_idx + lookahead_pts, 0, R - 1)
    mid = torch.clamp(route_idx + lookahead_pts // 2, 0, R - 1)
    hdg0 = route[b, route_idx, 2]
    hdg1 = route[b, j, 2]
    dh = torch.atan2(torch.sin(hdg1 - hdg0), torch.cos(hdg1 - hdg0))
    rel = route[b, j, :2] - route[b, route_idx, :2]
    lat = -torch.sin(hdg0) * rel[:, 0] + torch.cos(hdg0) * rel[:, 1]
    dist = torch.linalg.norm(town.tl_pos[None] - route[b, mid, :2][:, None], dim=-1)
    d_junction = torch.min(torch.where(town.tl_valid[None], dist,
                                       torch.full_like(dist, 1e9)), dim=1).values
    turning = torch.abs(dh) > 0.35
    changing = ~turning & (torch.abs(dh) < 0.15) & (torch.abs(lat) > 2.5)

    def pick(cond, a, c):
        return torch.where(cond, torch.as_tensor(a, device=route.device), c)

    lanefollow = torch.full((B,), CMD_LANEFOLLOW, dtype=torch.int64, device=route.device)
    cmd = pick(d_junction < 15.0, CMD_STRAIGHT, lanefollow)
    cmd = torch.where(changing, pick(lat < 0, CMD_CHANGELEFT,
                                     torch.full_like(cmd, CMD_CHANGERIGHT)), cmd)
    return torch.where(turning, pick(dh < 0, CMD_LEFT, torch.full_like(cmd, CMD_RIGHT)),
                       cmd)


def collect_batch(cfg: Config, policy, town: TownMap, state, n_frames: int,
                  ticks_per_frame: int = 10, policy_every: int = 2,
                  step_draws=None, sensor_draws=None,
                  generator: torch.Generator | None = None):
    """Roll the expert n_frames frames of ticks_per_frame ticks and render
    the sensors at each frame's start. step_draws (n_frames *
    ticks_per_frame StepDraws) and sensor_draws (n_frames SensorDraws) are
    optional; else they come from generator, which is then required. -> (final state, Frame of
    (B, F, ...), sensors dict of (B, F, ...): rgb, depth, semantic, lidar
    (x, y, z, intensity, dt = 0) and lidar_mask)."""
    from thinktwice_tpu_torch.agents.thinktwice_driver import sample_sensor_draws

    if generator is None and (step_draws is None or sensor_draws is None):
        raise ValueError("collect_batch needs its draws or a seeded torch.Generator")
    frames, sensors = [], []
    for f in range(n_frames):
        ctrl_now, sup = expert_control(cfg, policy, town, state)
        draws = (sensor_draws[f] if sensor_draws is not None else
                 sample_sensor_draws(cfg, state.n_worlds, state.tick.device, generator))
        cams = cameras_from_state(cfg.camera, town, state, rain_noise=draws.rain_noise)
        pts4, pts_mask = lidar_from_state(cfg.lidar, town, state, draws=draws.lidar)
        frames.append(make_frame(town, state, ctrl_now, sup))
        sensors.append({
            "rgb": cams["rgb"], "depth": cams["depth"], "semantic": cams["semantic"],
            "lidar": torch.cat([pts4, torch.zeros_like(pts4[..., :1])], dim=-1),
            "lidar_mask": pts_mask,
        })
        ticks = None if step_draws is None else step_draws[f * ticks_per_frame:]
        state, _ = drive_frame(cfg, policy, town, state, ctrl_now, ticks_per_frame,
                               policy_every, ticks, generator)
    return state, stack_frames(frames), stack_frames(sensors)


def _rotate_into(yaw, vec):
    """vec (..., 2) world offsets -> the frame of heading yaw (...)."""
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    return torch.stack([vec[..., 0] * c - vec[..., 1] * s,
                        vec[..., 0] * s + vec[..., 1] * c], dim=-1)


def command_onehot(target_point):
    """Fallback command from the ego-frame target point: 0 LEFT below -0.3
    rad, 1 RIGHT above 0.3, else 3 LANEFOLLOW; one-hot of 6 float32."""
    angle = torch.atan2(target_point[..., 1], target_point[..., 0])
    cmd = torch.where(angle < -0.3, CMD_LEFT,
                      torch.where(angle > 0.3, CMD_RIGHT, CMD_LANEFOLLOW))
    return F.one_hot(cmd.to(torch.int64), 6).to(torch.float32)


def frames_to_batch(cfg: Config, frames, sensors: dict, pred_len: int = 4,
                    n_sweeps: int = 1) -> dict:
    """Frames and sensors of B worlds, (B, F, ...) -> one training batch of
    B x n examples, n = F - pred_len - (n_sweeps - 1), world-major.

    Example i of a world uses frames i+1..i+pred_len for its waypoints (in
    frame i's ego frame) and future Roach actions and grids; with two
    sweeps the history camera sweep is the previous frame and the lidar the
    two-sweep merge. gt_depth and gt_seg are per camera, (B*n*N, ...)."""
    B, Fn = frames.pos.shape[:2]
    n = Fn - pred_len - (n_sweeps - 1)
    dev = frames.pos.device
    idx = torch.arange(n, device=dev) + (n_sweeps - 1)

    def at(x, i):
        """x (B, F, ...) at frame indices i (n,) -> (B*n, ...)."""
        return x[:, i].reshape(B * n, *x.shape[2:])

    pos, yaw = frames.pos, frames.yaw
    gt_wp = torch.stack([_rotate_into(at(yaw, idx), at(pos, idx + k) - at(pos, idx))
                         for k in range(1, pred_len + 1)], dim=1)   # (Bn, T, 2)

    sup = frames.supervision
    # only_ap_brake: the accel dimension's Beta becomes the braking prior
    # (0.8, 5.5); the steering dimension keeps Roach's
    oab = sup["only_ap_brake"]
    alpha = sup["alpha"].clone()
    beta = sup["beta"].clone()
    alpha[..., 0] = torch.where(oab, torch.full_like(alpha[..., 0], 0.8), alpha[..., 0])
    beta[..., 0] = torch.where(oab, torch.full_like(beta[..., 0], 5.5), beta[..., 0])
    fut_a = [at(alpha, idx + k) for k in range(1, pred_len)]
    fut_b = [at(beta, idx + k) for k in range(1, pred_len)]

    grids = tuple(g.movedim(2, -1) for g in sup["cnn_features"])  # NCHW -> NHWC
    future_cnn21 = torch.stack([at(grids[0], idx + k) for k in range(1, pred_len + 1)],
                               dim=1)                               # (Bn, T, 21, 21, 32)

    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    sweeps = [idx - (n_sweeps - 1 - t) for t in range(n_sweeps)]  # oldest first
    rgb = torch.stack([at(sensors["rgb"], i) for i in sweeps], dim=1)
    sweep2key = torch.stack([sweep_to_key(at(pos, i), at(yaw, i), at(pos, idx), at(yaw, idx))
                             for i in sweeps], dim=1)              # (Bn, T_sw, 4, 4)

    if n_sweeps >= 2:
        points, points_mask = merge_sweeps(
            at(sensors["lidar"], idx)[..., :4], at(sensors["lidar_mask"], idx),
            at(sensors["lidar"], idx - 1)[..., :4], at(sensors["lidar_mask"], idx - 1),
            (at(pos, idx), at(yaw, idx)), (at(pos, idx - 1), at(yaw, idx - 1)))
    else:
        points, points_mask = at(sensors["lidar"], idx), at(sensors["lidar_mask"], idx)

    a_now, b_now = at(alpha, idx), at(beta, idx)
    depth = at(sensors["depth"], idx)
    sem = at(sensors["semantic"], idx)[..., ::4, ::4]              # the seg head's scale
    return {
        "imgs": (rgb - mean) / std,
        "sweep2key": sweep2key,
        "points": points,
        "points_mask": points_mask,
        "speed": at(frames.speed, idx),
        "target_point": at(frames.target_point, idx),
        "command": F.one_hot(at(frames.command, idx), 6).to(torch.float32),
        "gt_waypoints": gt_wp,
        "action_alpha": a_now,
        "action_beta": b_now,
        "future_action_alpha": torch.stack(fut_a, dim=1),
        "future_action_beta": torch.stack(fut_b, dim=1),
        "gt_speed": at(frames.speed, idx),
        "gt_value": at(sup["value"], idx),
        "roach_features": at(sup["features"], idx),
        "roach_cnn": tuple(at(g, idx) for g in grids),
        "future_roach_cnn21": future_cnn21,
        "gt_depth": depth.reshape(-1, *depth.shape[2:]),
        "gt_seg": sem.reshape(-1, *sem.shape[2:]),
        "teacher_wp": gt_wp,
        # the current and the pred_len - 1 future actions, (alpha, beta)
        "teacher_ctrl_sp": torch.cat([torch.stack([a_now, *fut_a], dim=1),
                                      torch.stack([b_now, *fut_b], dim=1)], dim=-1),
    }
