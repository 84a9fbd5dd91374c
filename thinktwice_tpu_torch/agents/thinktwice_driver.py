"""ThinkTwice closed-loop driver of B worlds: cameras + lidar -> the student
model -> fused control (counterpart of
`thinktwice_tpu/agents/thinktwice_driver.py`).

Every policy call renders the 4 cameras (one K2 launch on the card) and the
lidar (another), runs the model on the key frame and, with two sweeps, on
the frame HIST_TICKS calls old, taken from ring buffers and moved into the
key frame (`geometry.sweep_to_key`); then the Beta-mode action and the
waypoint PID are fused by the agent's rules. Before the ring is full
(tick < ring length) the history sweep is the current frame. The rings
are updated in place (the driver state owns them). The sensors' random
draws are an optional input (`SensorDraws`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.agents import thinktwice as tw
from thinktwice_tpu_torch.agents.expert import _target_point
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.geometry import sweep_to_key
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.models import rig as rig_lib
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel
from thinktwice_tpu_torch.sensors.camera import cameras_from_state
from thinktwice_tpu_torch.sensors.lidar import (
    LidarDraws,
    lidar_from_state,
    merge_sweeps,
    sample_lidar_draws,
)
from thinktwice_tpu_torch.sim.state import WorldState, tree_map
from thinktwice_tpu_torch.sim.step import StepDraws, step_world
from thinktwice_tpu_torch.train.collect import IMAGENET_MEAN, IMAGENET_STD, route_command

HIST_TICKS = 10  # 0.5 s at 20 Hz: the history sweep's age


@dataclasses.dataclass(frozen=True)
class DriverState:
    agent: tw.AgentState
    tick: int                                 # policy calls so far, shared by the batch
    # ring buffers of raw frames and ego poses; slot tick % ring length
    # holds the oldest (None with one sweep)
    rgb_ring: torch.Tensor | None = None      # (B, HIST, N, H, W, 3) in [0, 1]
    pts_ring: torch.Tensor | None = None      # (B, HIST, P, 4)
    mask_ring: torch.Tensor | None = None     # (B, HIST, P)
    pos_ring: torch.Tensor | None = None      # (B, HIST, 2)
    yaw_ring: torch.Tensor | None = None      # (B, HIST)


@dataclasses.dataclass(frozen=True)
class SensorDraws:
    """The random numbers of one policy call: the cameras' rain noise
    (B, N, H, W, 3) standard normals and the lidar's draws."""

    rain_noise: torch.Tensor
    lidar: LidarDraws


def sample_sensor_draws(cfg: Config, n_worlds: int, device,
                        generator: torch.Generator | None = None) -> SensorDraws:
    cam = cfg.camera
    return SensorDraws(
        rain_noise=torch.randn((n_worlds, cam.n_cams, cam.height, cam.width, 3),
                               generator=generator, device=device),
        lidar=sample_lidar_draws(cfg.lidar, n_worlds, device, generator),
    )


def driver_init(cfg: Config, n_worlds: int, n_sweeps: int = 1,
                hist_len: int = HIST_TICKS, device="cuda") -> DriverState:
    """hist_len: ring slots between the key frame and the history sweep, in
    policy calls (10 at a policy every tick: 0.5 s)."""
    device = resolve_device(device)
    base = DriverState(agent=tw.agent_init(n_worlds, device), tick=0)
    if n_sweeps <= 1:
        return base
    cam, lid = cfg.camera, cfg.lidar
    P = lid.n_beams * lid.n_azimuth
    B = n_worlds

    def z(*shape, dtype=torch.float32):
        return torch.zeros((B, hist_len, *shape), dtype=dtype, device=device)

    return dataclasses.replace(
        base, rgb_ring=z(cam.n_cams, cam.height, cam.width, 3), pts_ring=z(P, 4),
        mask_ring=z(P, dtype=torch.bool), pos_ring=z(2), yaw_ring=z(),
    )


def _normalize(rgb):
    mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, device=rgb.device)
    return (rgb - mean) / std


def make_thinktwice_driver(cfg: Config, model: ThinkTwiceModel):
    """-> policy(town, state, driver, draws=None, generator=None) ->
    (control (B, 3), driver'). The model's device is the driver's."""
    dev = next(model.parameters()).device
    c2e = torch.as_tensor(rig_lib.cam_to_ego(cfg.camera), device=dev)
    K = torch.as_tensor(rig_lib.intrinsics(cfg.camera), device=dev)
    e2i = torch.as_tensor(rig_lib.ego_to_img(cfg.camera), device=dev)
    n_sweeps = model.n_sweeps

    @torch.no_grad()
    def policy(town: TownMap, state: WorldState, driver: DriverState,
               draws: SensorDraws | None = None,
               generator: torch.Generator | None = None):
        B = state.n_worlds
        if draws is None:
            draws = sample_sensor_draws(cfg, B, dev, generator)
        rgb_now = cameras_from_state(cfg.camera, town, state,
                                     rain_noise=draws.rain_noise)["rgb"]
        pts, pts_mask = lidar_from_state(cfg.lidar, town, state, draws=draws.lidar)
        pos, yaw = state.ego.pos, state.ego.yaw

        if n_sweeps >= 2:
            slot = driver.tick % driver.rgb_ring.shape[1]
            if driver.tick >= driver.rgb_ring.shape[1]:
                # the slot about to be overwritten holds the frame from
                # exactly ring-length calls ago
                h_rgb, h_pts = driver.rgb_ring[:, slot], driver.pts_ring[:, slot]
                h_mask = driver.mask_ring[:, slot]
                h_pos, h_yaw = driver.pos_ring[:, slot], driver.yaw_ring[:, slot]
            else:
                h_rgb, h_pts, h_mask, h_pos, h_yaw = rgb_now, pts, pts_mask, pos, yaw
            imgs = _normalize(torch.stack([h_rgb, rgb_now], dim=1))  # (B, T, N, H, W, 3)
            eye = torch.eye(4, device=dev).expand(B, 4, 4)
            s2k = torch.stack([sweep_to_key(h_pos, h_yaw, pos, yaw), eye], dim=1)
            pts5, pts_mask_m = merge_sweeps(pts, pts_mask, h_pts, h_mask,
                                            (pos, yaw), (h_pos, h_yaw))
            for ring, now in ((driver.rgb_ring, rgb_now), (driver.pts_ring, pts),
                              (driver.mask_ring, pts_mask), (driver.pos_ring, pos),
                              (driver.yaw_ring, yaw)):
                ring[:, slot] = now
        else:
            imgs = _normalize(rgb_now)[:, None]
            s2k = None
            pts5 = torch.cat([pts, torch.zeros_like(pts[..., :1])], dim=-1)
            pts_mask_m = pts_mask

        tp = _target_point(state)
        cmd = F.one_hot(route_command(town, state.route, state.criteria.route_idx),
                        6).to(torch.float32)
        outs = model(imgs, pts5, pts_mask_m, state.ego.speed, tp, cmd, c2e, K, e2i,
                     sweep2key=s2k)
        control, agent = controls_from_outputs(outs, driver.agent, state.ego.speed, tp)
        return control, dataclasses.replace(driver, agent=agent, tick=driver.tick + 1)

    return policy


def make_student_policy(cfg: Config, model: ThinkTwiceModel, policy_every: int = 1):
    """The student as a stateful evaluator policy -> (policy_fn, policy_init):
    policy_fn(cfg, town, state, driver, draws) -> (control (B, 3), driver')
    and policy_init(n_worlds) -> the batch's DriverState, whose history ring
    holds HIST_TICKS // policy_every calls so that the history sweep stays
    0.5 s old. A batch of worlds resets together, so the driver's one shared
    tick serves every world. policy_fn.sample_draws(n_worlds, generator)
    draws one call's SensorDraws on the generator's device; the evaluator's
    seeded provider calls it for every policy call."""
    drive = make_thinktwice_driver(cfg, model)
    dev = next(model.parameters()).device

    def policy_fn(cfg_, town, state, driver, draws):
        return drive(town, state, driver, draws=tree_map(lambda x: x.to(dev), draws))

    def policy_init(n_worlds: int) -> DriverState:
        return driver_init(cfg, n_worlds, model.n_sweeps,
                           hist_len=HIST_TICKS // policy_every, device=dev)

    policy_fn.sample_draws = lambda n_worlds, generator: sample_sensor_draws(
        cfg, n_worlds, generator.device, generator)
    return policy_fn, policy_init


def controls_from_outputs(outs, agent: tw.AgentState, speed, tp):
    """The final refine layer's action head and waypoints -> fused control
    (B, 3) and the new agent state."""
    steer_n, throt_n, brake_n = tw.process_action(outs["mu_branches"][:, -1],
                                                  outs["sigma_branches"][:, -1])
    steer_p, throt_p, brake_p, _, agent = tw.control_pid(
        agent, outs["pred_wp"][:, -1], speed, tp)
    is_turning = torch.abs(torch.atan2(tp[:, 1], tp[:, 0])) > 0.25
    return tw.fuse_controls(agent, steer_n, throt_n, brake_n, steer_p, throt_p,
                            brake_p, speed, is_turning)


def rollout_thinktwice(cfg: Config, town: TownMap, model: ThinkTwiceModel,
                       state: WorldState, n_steps: int,
                       sensor_draws: list[SensorDraws] | None = None,
                       step_draws: list[StepDraws] | None = None,
                       generator: torch.Generator | None = None,
                       hist_len: int = HIST_TICKS):
    """The closed loop with the policy every tick over B worlds. The lists of
    draws, when given, hold each tick's (for parity tests); else they come
    from generator. hist_len is the history ring's length in policy calls.
    -> (final state, driver state, list of controls)."""
    policy = make_thinktwice_driver(cfg, model)
    driver = driver_init(cfg, state.n_worlds, model.n_sweeps, hist_len=hist_len,
                         device=state.tick.device)
    controls = []
    for t in range(n_steps):
        ctrl, driver = policy(town, state, driver,
                              draws=None if sensor_draws is None else sensor_draws[t],
                              generator=generator)
        controls.append(ctrl)
        state, _ = step_world(cfg, town, state, ctrl,
                              draws=None if step_draws is None else step_draws[t],
                              generator=generator)
    return state, driver, controls
