"""Vehicle dynamics: the World-on-Rails kinematic bicycle model
(counterpart of `thinktwice_tpu/sim/dynamics.py`). Both functions broadcast
over leading axes: the same code integrates the egos of all worlds and
every traffic vehicle."""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.config import SimConfig
from thinktwice_tpu_torch.geometry import wrap_angle


def bicycle_step(cfg: SimConfig, pos, yaw, speed, steer, throttle, brake,
                 dt: float | None = None, drag: float = 0.0):
    """One bicycle-model integration step: pos (..., 2), yaw (...,),
    speed (...,) >= 0, steer [-1, 1], throttle [0, 1], brake > 0.5 brakes.
    Returns (pos', yaw', speed')."""
    if dt is None:
        dt = cfg.dt
    braking = brake > 0.5
    accel = torch.where(braking, torch.full_like(throttle, cfg.brake_accel),
                        cfg.throt_accel * throttle)
    accel = accel - drag * speed

    wheel = cfg.steer_gain * steer
    ratio = cfg.rear_wb / (cfg.front_wb + cfg.rear_wb)
    beta = torch.atan(ratio * torch.tan(wheel))

    heading = yaw + beta
    new_pos = pos + speed[..., None] * torch.stack(
        [torch.cos(heading), torch.sin(heading)], dim=-1
    ) * dt
    new_yaw = wrap_angle(yaw + speed / cfg.rear_wb * torch.sin(beta) * dt)
    new_speed = torch.clamp_min(speed + accel * dt, 0.0)
    return new_pos, new_yaw, new_speed


def point_mass_step(pos, yaw, speed, yaw_rate, accel, dt: float):
    """Unicycle integrator for walkers and scripted scenario actors."""
    new_yaw = wrap_angle(yaw + yaw_rate * dt)
    new_pos = pos + speed[..., None] * torch.stack(
        [torch.cos(new_yaw), torch.sin(new_yaw)], dim=-1
    ) * dt
    new_speed = torch.clamp_min(speed + accel * dt, 0.0)
    return new_pos, new_yaw, new_speed

