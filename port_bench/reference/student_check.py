"""The comparison that decides `correct` in the student's closed loop.

The reference is the frozen plain copy (`ttref`): K2's plain version, the
same mixed precision as the configuration states (bfloat16 trunks, float32
with TF32 off elsewhere), its own model with the seed's weights, its own
town. It follows the program from the program's own state at the ticks
the run captured: the world state, the driver's agent state and the history
sweep the call read from the program's ring (the frames the program's
cameras and lidar made at an earlier call, which the checks of other
calls cover). The start is checked by itself: the reference's reset
worlds against the program's.

Numbers, each against the traffic file's limit:
- `camera_gap`: the largest difference of any float the cameras return;
- `lidar_gap`: of the lidar's points where both keep a return;
- `sensor_flips`: differing integer and boolean sensor elements, and
  points kept on one side only;
- `model_gap`: of the model's float outputs;
- `fusion_gap`: of the fused control against the reference's fusion of
  the program's own model outputs (the fusion judged as a stage: its
  clamps and brake rules saturate, so a gap in the outputs often leaves the
  control unmoved, and the outputs are compared by model_gap);
- `world_gap`, `world_flips`: as in the Roach cells (reset and step).

The control (`control=True`) puts the reference, one precision lower, in
the program's place: its bfloat16 matrix work on float8 operands, and the
float32 sensors, fusion and world step held in bfloat16 (their floats
rounded).
"""

from __future__ import annotations

import torch

from port_bench.reference.configs import make_config
from port_bench.reference.roach_check import CLASSES, convert, tf32, to_bf16, tree_gap
from port_bench.reference.seeded import seeded_params
from port_bench.reference.ttref import config as ref_config
from port_bench.reference.ttref.agents import pid as ref_pid
from port_bench.reference.ttref.agents import thinktwice as ref_tw
from port_bench.reference.ttref.agents import thinktwice_driver as ref_ttd
from port_bench.reference.ttref.agents.expert import _target_point
from port_bench.reference.ttref.models import rig as ref_rig
from port_bench.reference.ttref.models.encoder_decoder import ThinkTwiceModel
from port_bench.reference.ttref.models.layers import lower_precision
from port_bench.reference.ttref.rollout import grid_world
from port_bench.reference.ttref.sensors import lidar as ref_lidar
from port_bench.reference.ttref.sim import step as ref_step

CLASSES.update({c.__name__: c for c in (
    ref_tw.AgentState, ref_pid.PIDState, ref_ttd.SensorDraws, ref_lidar.LidarDraws)})


def reference_config(conf: dict, traffic: dict):
    return make_config(conf, traffic, ref_config)


def reference_model(conf: dict, cfg, seed: int, device) -> ThinkTwiceModel:
    with torch.device("meta"):
        model = ThinkTwiceModel(cfg.model, backbone_depth=conf["backbone_depth"],
                                n_sweeps=conf["n_sweeps"], n_cams=cfg.camera.n_cams)
    model = model.to_empty(device=device).eval()
    seeded_params(model, seed, device)
    return model


def reference_forward(conf: dict, cfg, B: int, device):
    """-> fn() running the reference model's forward once on zero inputs of
    the driver's shapes at B worlds (for counting its FLOPs)."""
    model = reference_model(conf, cfg, 0, device)
    cam, lid = cfg.camera, cfg.lidar
    T, P = conf["n_sweeps"], lid.n_beams * lid.n_azimuth
    z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    args = (z(B, T, cam.n_cams, cam.height, cam.width, 3), z(B, T * P, 5),
            z(B, T * P, dtype=torch.bool), z(B), z(B, 2), z(B, 6),
            torch.as_tensor(ref_rig.cam_to_ego(cam), device=device),
            torch.as_tensor(ref_rig.intrinsics(cam), device=device),
            torch.as_tensor(ref_rig.ego_to_img(cam), device=device))
    s2k = torch.eye(4, device=device).expand(B, T, 4, 4).contiguous() if T > 1 else None

    @torch.no_grad()
    def fn():
        model(*args, sweep2key=s2k)

    return fn


def _gap(judged: dict, ref: dict) -> tuple[float, int]:
    """(largest float difference, differing non-float elements) over the
    tensors two dicts share by key."""
    gap, flips = 0.0, 0
    for k, a in judged.items():
        b = ref[k]
        if not torch.is_tensor(a):
            continue
        if a.is_floating_point():
            d = (a.double() - b.double()).abs()
            gap = max(gap, float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0)
        else:
            flips += int((a != b).sum())
    return gap, flips


def _call(policy, model, town, s, agent, tick: int, hist: dict, sd):
    """The reference driver's call from the program's state -> (cameras,
    lidar, model outputs, control)."""
    seen = {}
    real_cam, real_lidar, real_fwd = (ref_ttd.cameras_from_state, ref_ttd.lidar_from_state,
                                      model.forward)

    def tap(name, fn):
        def wrapper(*a, **kw):
            seen[name] = fn(*a, **kw)
            return seen[name]
        return wrapper

    ref_ttd.cameras_from_state = tap("cameras", real_cam)
    ref_ttd.lidar_from_state = tap("lidar", real_lidar)
    model.forward = tap("model", real_fwd)
    try:
        driver = ref_ttd.DriverState(agent=agent, tick=tick,
                                     **{k: v.clone()[:, None] for k, v in hist.items()})
        ctrl, _ = policy(town, s, driver, draws=sd)
    finally:
        ref_ttd.cameras_from_state, ref_ttd.lidar_from_state = real_cam, real_lidar
        model.forward = real_fwd
    return seen["cameras"], seen["lidar"], seen["model"], ctrl


def _lidar_gap(judged, ref) -> tuple[float, int]:
    (p, m), (rp, rm) = judged, ref
    both = m & rm
    gap = float((p - rp).abs()[both].max()) if bool(both.any()) else 0.0
    return gap, int((m != rm).sum())


@torch.no_grad()
def check(conf: dict, traffic: dict, seed: int, device, state0, captures,
          control: bool = False) -> dict:
    """{number: (value, limit)} over the captured calls, each (state,
    agent, driver tick, history slot, sensor draws, cameras, lidar, model
    outputs, control, step draws, state after)."""
    device = torch.device(device)
    limits = traffic["limits"]
    with tf32(False):
        cfg = reference_config(conf, traffic)
        model = reference_model(conf, cfg, seed, device)
        g = torch.Generator(device=device).manual_seed(seed)
        if traffic["town"]["kind"] != "grid":
            raise ValueError(f"unknown town kind {traffic['town']['kind']!r}")
        town, ref0 = grid_world(cfg, traffic["worlds"], traffic["vehicles"], device=device,
                                generator=g)
        policy = ref_ttd.make_thinktwice_driver(cfg, model)
        world_gap, world_flips = tree_gap(state0, ref0)
        cam_gap = lidar_gap = model_gap = fusion_gap = 0.0
        flips = 0
        for (state, agent, tick, hist, sdraws, cams, lidar, outs, ctrl, draws,
             after) in captures:
            s, sd, ag = convert(state), convert(sdraws), convert(agent)
            r_cams, r_lidar, r_outs, _ = _call(policy, model, town, s, ag, tick, hist, sd)
            if control:
                lower_precision(True)
                try:
                    _, _, outs, ctrl = _call(policy, model, town, s, ag, tick, hist, sd)
                finally:
                    lower_precision(False)
                cams = {k: to_bf16(v) for k, v in r_cams.items()}
                lidar = (to_bf16(r_lidar[0]), r_lidar[1])
            gap, n = _gap(cams, r_cams)
            cam_gap, flips = max(cam_gap, gap), flips + n
            gap, n = _lidar_gap(lidar, r_lidar)
            lidar_gap, flips = max(lidar_gap, gap), flips + n
            gap, n = _gap(outs, r_outs)
            model_gap, flips = max(model_gap, gap), flips + n
            fused, _ = ref_ttd.controls_from_outputs(outs, ag, s.ego.speed, _target_point(s))
            if control:
                ctrl = to_bf16(fused)
            fusion_gap = max(fusion_gap, float((ctrl - fused).abs().max()))
            ref_after, _ = ref_step.step_world(cfg, town, s, ctrl, draws=convert(draws))
            gap, n = tree_gap(to_bf16(ref_after) if control else after, ref_after)
            world_gap, world_flips = max(world_gap, gap), world_flips + n
    numbers = {"camera_gap": cam_gap, "lidar_gap": lidar_gap, "sensor_flips": flips,
               "model_gap": model_gap, "fusion_gap": fusion_gap, "world_gap": world_gap,
               "world_flips": world_flips}
    return {k: (v, limits[k]) for k, v in numbers.items()}
