"""Closed-loop Roach expert: the policy plus the rule brakes (counterpart
of `state_vector`, `hazard_brake` and `expert_control` in
`thinktwice_tpu/agents/expert.py`).

The observation is the privileged birdview (through K1) and the state
vector [throttle, steer, brake, gear, vel_x, vel_y]. The emergency brake
forecasts the ego's and every actor's box over ~2 s and adds the stopped-
vehicle cone; red lights, stop signs and crossing streams brake through
the autopilot's caps. A rule brake that overrides the policy sets the
`only_ap_brake` supervision flag.

`collect_rollout` drives the expert and records a dataset `Frame` (pose,
control, target point, command and the Roach supervision) every
ticks_per_frame ticks; train/collect.py adds the sensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from thinktwice_tpu_torch.agents.autopilot import junction_yield, red_sign_caps
from thinktwice_tpu_torch.agents.roach import RoachPolicy, acc_to_control, beta_mode
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.geometry import obb_overlap
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sensors.birdview import birdview_from_state
from thinktwice_tpu_torch.sim.state import WorldState
from thinktwice_tpu_torch.sim.step import StepDraws, step_world

FORECAST_TS = (0.0, 0.5, 1.0, 1.5, 2.0)


def _cos_deg(deg: float) -> float:
    """cos of an angle in degrees, in float32 like the JAX package."""
    return float(torch.cos(torch.deg2rad(torch.tensor(deg, dtype=torch.float32))))


COS_30, COS_60, COS_15 = _cos_deg(30.0), _cos_deg(60.0), _cos_deg(15.0)


def state_vector(state: WorldState):
    """(B, 6) [throttle, steer, brake, gear, vel_x, vel_y] in the ego frame;
    the bicycle model has no lateral slip, so vel = (speed, 0)."""
    ctrl = state.ego.control
    one = torch.ones_like(state.ego.speed)
    return torch.stack(
        [ctrl[:, 1], ctrl[:, 0], ctrl[:, 2], one, state.ego.speed,
         torch.zeros_like(one)],
        dim=-1,
    )


def hazard_brake(cfg: Config, state: WorldState, stopped_cone: bool = False):
    """(B,) emergency brake: the ego's and each moving actor's boxes,
    extrapolated along their velocities over ~2 s, overlap; with
    stopped_cone, also any vehicle within max(10, 3 v) m inside a +-30 deg
    cone that is co-heading (<= 60 deg) or dead ahead (< 15 deg)."""
    ego = state.ego
    dev = ego.pos.device
    fwd = torch.stack([torch.cos(ego.yaw), torch.sin(ego.yaw)], dim=-1)
    spd = torch.clamp_min(ego.speed, 2.0)
    ego_v = fwd * spd[:, None]
    ts = torch.tensor(FORECAST_TS, device=dev)
    ego_t = ego.pos[:, None, :] + ts[None, :, None] * ego_v[:, None, :]  # (B, T, 2)
    sweep_pad = 0.25 * spd
    ego_ext = ego.extent + torch.stack(
        [0.3 + sweep_pad, torch.full_like(sweep_pad, 0.3)], dim=-1
    )

    def forecast_hit(pos, yaw, speed, ext, active):
        vel = torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1) * speed[..., None]
        act_t = pos[:, None] + ts[None, :, None, None] * vel[:, None]   # (B, T, A, 2)
        pad = torch.stack([0.2 + 0.25 * speed, torch.full_like(speed, 0.2)], dim=-1)
        ov = obb_overlap(
            ego_t[:, :, None, :], ego.yaw[:, None, None], ego_ext[:, None, None, :],
            act_t, yaw[:, None, :], (ext + pad)[:, None, :, :],
        )
        return torch.any((ov & active[:, None, :]).flatten(1), dim=-1)

    tr, wk = state.traffic, state.walkers
    veh = forecast_hit(tr.pos, tr.yaw, tr.speed, tr.extent,
                       tr.active & (tr.speed > 0.3))
    wlk = forecast_hit(wk.pos, wk.yaw, wk.speed, wk.extent, wk.active)
    if not stopped_cone:
        return veh | wlk
    s1 = torch.clamp_min(3.0 * ego.speed, 10.0)
    rel = tr.pos - ego.pos[:, None, :]
    dist = torch.linalg.norm(rel, dim=-1)
    rel_hat = rel / (dist[..., None] + 1e-4)
    cos_bearing = rel_hat[..., 0] * fwd[:, None, 0] + rel_hat[..., 1] * fwd[:, None, 1]
    cos_heading = torch.cos(tr.yaw - ego.yaw[:, None])
    cone = (
        tr.active
        & (dist <= s1[:, None])
        & (cos_bearing >= COS_30)
        & ((cos_heading >= COS_60) | (cos_bearing > COS_15))
    )
    return veh | wlk | torch.any(cone, dim=-1)


@torch.no_grad()
def expert_control(cfg: Config, policy: RoachPolicy, town: TownMap,
                   state: WorldState) -> tuple[torch.Tensor, dict[str, Any]]:
    """One policy evaluation of every world -> (control (B, 3), supervision
    dict)."""
    obs = birdview_from_state(cfg.birdview, town, state)
    sv = state_vector(state)
    out = policy(obs, sv)
    action = beta_mode(out["alpha"], out["beta"])            # (B, 2)
    control = acc_to_control(action)                         # (B, 3)

    brake_now = hazard_brake(cfg, state, stopped_cone=True)
    # red-light / stop-sign / junction-yield rule brakes on the stop-line
    # geometry the criteria charge
    v_red, d_red, v_sign, d_sign = red_sign_caps(cfg, town, state)
    spd = state.ego.speed
    brake_red = ((d_red < 30.0) & (spd > v_red + 0.5)) | (d_red < 4.5)
    brake_sign = ((d_sign < 12.0) & (spd > v_sign + 0.5)) | (v_sign < 0.2)
    v_yield, d_conf, w_arc = junction_yield(cfg, town, state)
    brake_yield = (((d_conf < w_arc - 1.0) & (spd > v_yield + 0.5))
                   | (d_conf < 4.0))
    brake_now = brake_now | brake_red | brake_sign | brake_yield
    only_ap_brake = brake_now & (control[:, 2] < 0.5)
    braked = torch.stack(
        [control[:, 0], torch.zeros_like(spd), torch.ones_like(spd)], dim=-1
    )
    control = torch.where(brake_now[:, None], braked, control)

    supervision = {
        "action": action,
        "alpha": out["alpha"],
        "beta": out["beta"],
        "value": out["value"][:, 0],
        "features": out["features"],
        "cnn_features": tuple(out["cnn_features"][2:]),
        "only_ap_brake": only_ap_brake,
        "birdview": obs,
        "state_vec": sv,
    }
    return control, supervision


def make_expert_policy(cfg: Config, policy: RoachPolicy):
    """The Roach expert as an evaluator policy: policy_fn(cfg, town, state)
    -> (B, 3) control, one `expert_control` (one K1 launch on the card) a
    call."""

    def policy_fn(cfg_, town, state):
        control, _ = expert_control(cfg, policy, town, state)
        return control

    return policy_fn


@dataclasses.dataclass(frozen=True)
class Frame:
    """Saved dataset frames of B worlds: each field (B, ...) for one frame,
    (B, F, ...) once collect_rollout stacks them."""

    pos: torch.Tensor
    yaw: torch.Tensor
    speed: torch.Tensor
    control: torch.Tensor
    target_point: torch.Tensor      # the route point 50 m ahead, ego frame
    route_completion: torch.Tensor
    command: torch.Tensor           # int64 RoadOption - 1 (train/collect.py)
    supervision: dict[str, Any]


def _target_point(state: WorldState, lookahead_m: float = 50.0):
    """(B, 2) the route point lookahead_m ahead, in the ego frame."""
    B, R = state.route_cumlen.shape
    b = torch.arange(B, device=state.route.device)
    cum = state.route_cumlen
    ahead = cum[b, state.criteria.route_idx] + lookahead_m
    tidx = torch.clamp(torch.searchsorted(cum, ahead[:, None])[:, 0], 0, R - 1)
    rel = state.route[b, tidx, :2] - state.ego.pos
    c, s = torch.cos(-state.ego.yaw), torch.sin(-state.ego.yaw)
    return torch.stack([rel[:, 0] * c - rel[:, 1] * s, rel[:, 0] * s + rel[:, 1] * c],
                       dim=-1)


def make_frame(town: TownMap, state: WorldState, control, supervision) -> Frame:
    from thinktwice_tpu_torch.train.collect import route_command

    return Frame(
        pos=state.ego.pos, yaw=state.ego.yaw, speed=state.ego.speed, control=control,
        target_point=_target_point(state),
        route_completion=state.criteria.route_completion,
        command=route_command(town, state.route, state.criteria.route_idx),
        supervision=supervision,
    )


def stack_frames(frames: list):
    """Per-frame trees (tensors, tuples, dicts, Frames) of B worlds -> one
    tree with the frames stacked on axis 1."""
    f0 = frames[0]
    if torch.is_tensor(f0):
        return torch.stack(frames, dim=1)
    if isinstance(f0, tuple):
        return tuple(stack_frames(list(z)) for z in zip(*frames))
    if isinstance(f0, dict):
        return {k: stack_frames([f[k] for f in frames]) for k in f0}
    return Frame(**{f.name: stack_frames([getattr(x, f.name) for x in frames])
                    for f in dataclasses.fields(Frame)})


def drive_frame(cfg: Config, policy: RoachPolicy, town: TownMap, state: WorldState,
                control, ticks: int, policy_every: int,
                step_draws: list[StepDraws] | None = None,
                generator: torch.Generator | None = None):
    """The ticks between two saved frames: the expert every policy_every
    ticks (from the first), its control held in between. -> (state, last
    control)."""
    for k in range(ticks):
        if k % policy_every == 0:
            control, _ = expert_control(cfg, policy, town, state)
        state, _ = step_world(cfg, town, state, control,
                              draws=None if step_draws is None else step_draws[k],
                              generator=generator)
    return state, control


def collect_rollout(cfg: Config, policy: RoachPolicy, town: TownMap, state: WorldState,
                    n_frames: int, ticks_per_frame: int = 10, policy_every: int = 2,
                    step_draws: list[StepDraws] | None = None,
                    generator: torch.Generator | None = None):
    """Drive the expert and record a Frame every ticks_per_frame ticks (2 Hz
    at the 20 Hz tick), the supervision taken at the start of each frame.
    step_draws, when given, holds every tick's draws (n_frames *
    ticks_per_frame); else they come from generator, which is then
    required. -> (final state, Frame of (B, F, ...))."""
    if step_draws is None and generator is None:
        raise ValueError("collect_rollout needs its draws or a seeded torch.Generator")
    frames = []
    for f in range(n_frames):
        ctrl_now, sup = expert_control(cfg, policy, town, state)
        frames.append(make_frame(town, state, ctrl_now, sup))
        draws = None if step_draws is None else step_draws[f * ticks_per_frame:]
        state, _ = drive_frame(cfg, policy, town, state, ctrl_now, ticks_per_frame,
                               policy_every, draws, generator)
    return state, stack_frames(frames)
