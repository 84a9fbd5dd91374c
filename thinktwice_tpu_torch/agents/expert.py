"""Closed-loop Roach expert: the policy plus the rule brakes (counterpart
of `state_vector`, `hazard_brake` and `expert_control` in
`thinktwice_tpu/agents/expert.py`).

The observation is the privileged birdview (through K1) and the state
vector [throttle, steer, brake, gear, vel_x, vel_y]. The emergency brake
forecasts the ego's and every actor's box over ~2 s and adds the stopped-
vehicle cone; red lights, stop signs and crossing streams brake through
the autopilot's caps. A rule brake that overrides the policy sets the
`only_ap_brake` supervision flag.
"""

from __future__ import annotations

from typing import Any

import torch

from thinktwice_tpu_torch.agents.autopilot import junction_yield, red_sign_caps
from thinktwice_tpu_torch.agents.roach import RoachPolicy, acc_to_control, beta_mode
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.geometry import obb_overlap
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sensors.birdview import birdview_from_state
from thinktwice_tpu_torch.sim.state import WorldState

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
