"""ThinkTwice closed-loop agent of B worlds: model outputs -> vehicle
control (counterpart of `thinktwice_tpu/agents/thinktwice.py`).

- `process_action`: the Beta mode of the final refine layer's (alpha, beta)
  -> (steer, throttle, brake);
- `control_pid`: waypoint desired speed and aim-point steering PID, with
  the target-point outlier rules;
- `fuse_controls`: brake if either path brakes, throttle clamped near the
  speed limit, a creep after a stuck window.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from port_bench.reference.ttref.agents.pid import PIDState, pid_init, pid_step
from port_bench.reference.ttref.agents.roach import beta_mode

# control constants
TURN_KP, TURN_KI, TURN_KD, TURN_N = 0.75, 0.75, 0.3, 40
SPEED_KP, SPEED_KI, SPEED_KD, SPEED_N = 5.0, 0.5, 1.0, 40
BRAKE_SPEED = 0.4
BRAKE_RATIO = 1.1
CLIP_DELTA = 0.25
AIM_DIST = 4.0
ANGLE_THRESH = 0.3
DIST_THRESH = 10.0

# fusion rules
MAX_THROTTLE = 0.75
MIN_ACT_SPEED_STRAIGHT = 3.5   # m/s, + 0.05 headroom when straight
MIN_ACT_SPEED_TURN = 1.5
CREEP_STUCK_TICKS = 20
CREEP_DURATION = 30
CREEP_THROTTLE = 0.4


@dataclasses.dataclass(frozen=True)
class AgentState:
    turn_pid: PIDState
    speed_pid: PIDState
    stuck_ticks: torch.Tensor   # (B,) i64
    creep_ticks: torch.Tensor   # (B,) i64


def agent_init(n_worlds: int, device) -> AgentState:
    return AgentState(
        turn_pid=pid_init(TURN_N, n_worlds, device),
        speed_pid=pid_init(SPEED_N, n_worlds, device),
        stuck_ticks=torch.zeros((n_worlds,), dtype=torch.int64, device=device),
        creep_ticks=torch.zeros((n_worlds,), dtype=torch.int64, device=device),
    )


def process_action(alpha, beta):
    """alpha, beta (B, 2) -> (steer, throttle, brake), each (B,)."""
    act = beta_mode(alpha, beta)
    acc, steer = act[:, 0], act[:, 1]
    return (torch.clamp(steer, -1.0, 1.0), torch.clamp(acc, 0.0, 1.0),
            torch.clamp(-acc, 0.0, 1.0))


def _angle_of(v):
    """atan2(right, forward) normalized to [-2, 2]."""
    return torch.atan2(v[..., 1], v[..., 0]) / (math.pi / 2)


def control_pid(agent: AgentState, waypoints, speed, target):
    """waypoints (B, T, 2) ego frame (x forward, y right); speed (B,);
    target (B, 2). -> (steer, throttle, brake (bool), desired_speed, new
    AgentState)."""
    seg = waypoints[:, 1:] - waypoints[:, :-1]
    desired_speed = torch.mean(torch.linalg.norm(seg, dim=-1), dim=1) * 2.0
    mids = 0.5 * (waypoints[:, 1:] + waypoints[:, :-1])
    best = torch.argmin(torch.abs(AIM_DIST - torch.linalg.norm(mids, dim=-1)), dim=1)
    aim = waypoints[torch.arange(waypoints.shape[0], device=waypoints.device), best]
    angle = _angle_of(aim)
    angle_last = _angle_of(waypoints[:, -1] - waypoints[:, -2])
    angle_target = _angle_of(target)
    use_target = (torch.abs(angle_target) < torch.abs(angle)) | (
        (torch.abs(angle_target - angle_last) > ANGLE_THRESH)
        & (target[:, 0] < DIST_THRESH))
    angle_final = torch.where(use_target, angle_target, angle)
    angle_final = torch.where(speed < 0.01, torch.zeros_like(angle_final), angle_final)

    steer, turn_pid = pid_step(agent.turn_pid, angle_final, TURN_KP, TURN_KI, TURN_KD)
    steer = torch.clamp(steer, -1.0, 1.0)
    brake = (desired_speed < BRAKE_SPEED) | (
        speed / torch.clamp_min(desired_speed, 1e-5) > BRAKE_RATIO)
    delta = torch.clamp(desired_speed - speed, 0.0, CLIP_DELTA)
    throttle, speed_pid = pid_step(agent.speed_pid, delta, SPEED_KP, SPEED_KI, SPEED_KD)
    throttle = torch.where(brake, torch.zeros_like(throttle),
                           torch.clamp(throttle, 0.0, 1.0))
    new_agent = dataclasses.replace(agent, turn_pid=turn_pid, speed_pid=speed_pid)
    return steer, throttle, brake, desired_speed, new_agent


def fuse_controls(agent: AgentState, steer_net, throttle_net, brake_net,
                  steer_pid, throttle_pid, brake_pid, speed, is_turning):
    """Rule fusion of the two control paths -> (control (B, 3), AgentState)."""
    steer = 0.5 * (steer_net + steer_pid)
    throttle = 0.5 * (throttle_net + throttle_pid)
    brake = (brake_net > 0.2) | brake_pid

    limit = torch.where(is_turning, torch.full_like(speed, MIN_ACT_SPEED_TURN),
                        torch.full_like(speed, MIN_ACT_SPEED_STRAIGHT))
    throttle = torch.where(speed > limit + 0.05, torch.zeros_like(throttle), throttle)
    throttle = torch.clamp(throttle, 0.0, MAX_THROTTLE)

    stuck = speed < 0.1
    stuck_ticks = torch.where(stuck, agent.stuck_ticks + 1,
                              torch.zeros_like(agent.stuck_ticks))
    creep_ticks = torch.where(stuck_ticks > CREEP_STUCK_TICKS,
                              torch.full_like(agent.creep_ticks, CREEP_DURATION),
                              torch.clamp_min(agent.creep_ticks - 1, 0))
    creeping = creep_ticks > 0
    throttle = torch.where(creeping, torch.clamp_min(throttle, CREEP_THROTTLE), throttle)
    brake = brake & ~creeping
    stuck_ticks = torch.where(creeping, torch.zeros_like(stuck_ticks), stuck_ticks)

    control = torch.stack([steer, throttle, brake.to(steer.dtype)], dim=-1)
    return control, dataclasses.replace(agent, stuck_ticks=stuck_ticks,
                                        creep_ticks=creep_ticks)
