"""The comparison that decides `correct` in the Roach cells.

The reference is the frozen plain copy (`ttref`), float32 with TF32 off.
It builds its own town, its own worlds from the seed and its own policy
from the weights file, and follows the program from the program's own
world state at the ticks the run captured (a closed loop of thousands of
ticks cannot be replayed, and its trajectories part on the first rounding
difference). The start is checked by itself: the reference's reset worlds
against the program's.

Numbers, each against the traffic file's limit:
- `k1_pixels_off`: pixels of the captured ticks' birdviews (any of the 15
  channels) that differ from the reference's plain rasterizer;
- `action_gap`: the largest difference of the policy's Beta-mode action;
- `control_gap`: of `expert_control`'s rule-braked control;
- `world_gap`: of any float of the world state, after reset and after
  `step_world` (run by the reference on the program's control and draws);
- `world_flips`: integer and boolean elements of those states that differ.

The control (`control=True`) puts the reference, one precision lower, in
the program's place: the policy's convolutions and dense layers in TF32
(their operands rounded to TF32's 10-bit mantissa, emulated so that it
reads the same on any device, accumulating in float32), and the world
step's float32 state held in bfloat16 (every float it returns rounded).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import os

import torch

from port_bench.reference.ttref.agents import expert as ref_expert
from port_bench.reference.configs import make_config
from port_bench.reference.ttref import config as ref_config
from port_bench.reference.ttref.rollout import grid_world
from port_bench.reference.ttref.sim import state as ref_state
from port_bench.reference.ttref.sim import step as ref_step
from port_bench.reference.ttref.weights import load_roach_policy

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLASSES = {c.__name__: c for c in (
    ref_state.EgoState, ref_state.TrafficState, ref_state.WalkerState, ref_state.CriteriaState,
    ref_state.HistoryState, ref_state.ScenarioState, ref_state.WorldState, ref_step.StepDraws)}


def weights_path(conf: dict) -> str:
    """The configuration's weights file, refused unless its bytes are the
    ones the configuration names."""
    w = conf["weights"]
    path = os.path.join(ROOT, w["file"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != w["sha256"]:
        raise ValueError(f"{w['file']} is not the file the configuration names "
                         f"(sha256 {digest}, not {w['sha256']})")
    return path


def reference_config(conf: dict, traffic: dict):
    return make_config(conf, traffic, ref_config)


@contextlib.contextmanager
def tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_tf32(t):
    """float32 t rounded to nearest on TF32's 10-bit mantissa."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_policy(policy):
    """A copy of the policy whose convolutions and dense layers compute on
    TF32-rounded weights and inputs."""
    lower = copy.deepcopy(policy)
    for m in lower.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.weight.data = to_tf32(m.weight.data)
            m.register_forward_pre_hook(lambda mod, args: tuple(to_tf32(a) for a in args))
    return lower


def to_bf16(obj):
    """Every float leaf of a dataclass of tensors rounded to bfloat16 (and
    back to its dtype)."""
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: to_bf16(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if torch.is_tensor(obj) and obj.is_floating_point():
        return obj.to(torch.bfloat16).to(obj.dtype)
    return obj


def convert(obj):
    """A dataclass of tensors (the program's) -> the reference's dataclass
    of the same name, field by field."""
    if dataclasses.is_dataclass(obj):
        cls = CLASSES[type(obj).__name__]
        return cls(**{f.name: convert(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


def leaves(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{prefix}{f.name}.")
    else:
        yield prefix.rstrip("."), obj


def tree_gap(judged, ref) -> tuple[float, int]:
    """(largest float difference, count of differing integer and boolean
    elements) of two world states."""
    gap, flips = 0.0, 0
    for (name, a), (_, b) in zip(leaves(judged), leaves(ref)):
        if a.shape != b.shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)} against {tuple(b.shape)}")
        if a.is_floating_point():
            d = (a.double() - b.double()).abs()
            gap = max(gap, float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0)
        else:
            flips += int((a != b).sum())
    return gap, flips


@torch.no_grad()
def check(conf: dict, traffic: dict, seed: int, device, state0, captures,
          control: bool = False) -> dict:
    """{number: (value, limit)} over the run's captures, each (state before
    a policy tick, the tick's draws, the control, the action, the
    birdview, the state after)."""
    device = torch.device(device)
    limits = traffic["limits"]
    with tf32(False):
        cfg = reference_config(conf, traffic)
        policy = load_roach_policy(weights_path(conf), cfg, device=device)
        g = torch.Generator(device=device).manual_seed(seed)
        if traffic["town"]["kind"] != "grid":
            raise ValueError(f"unknown town kind {traffic['town']['kind']!r}")
        town, ref0 = grid_world(cfg, traffic["worlds"], traffic["vehicles"], device=device,
                                generator=g)
        world_gap, world_flips = tree_gap(state0, ref0)
        pixels = 0
        action_gap = control_gap = 0.0
        lower = tf32_policy(policy) if control else None
        for state, draws, ctrl, action, obs, after in captures:
            s = convert(state)
            ref_ctrl, sup = ref_expert.expert_control(cfg, policy, town, s)
            if control:
                ctrl, sup_c = ref_expert.expert_control(cfg, lower, town, s)
                action, obs = sup_c["action"], sup_c["birdview"]
            pixels += int((obs != sup["birdview"]).any(dim=1).sum())
            action_gap = max(action_gap, float((action - sup["action"]).abs().max()))
            control_gap = max(control_gap, float((ctrl - ref_ctrl).abs().max()))
            ref_after, _ = ref_step.step_world(cfg, town, s, ctrl, draws=convert(draws))
            judged = to_bf16(ref_after) if control else after
            gap, flips = tree_gap(judged, ref_after)
            world_gap, world_flips = max(world_gap, gap), world_flips + flips
    numbers = {"k1_pixels_off": pixels, "action_gap": action_gap, "control_gap": control_gap,
               "world_gap": world_gap, "world_flips": world_flips}
    return {k: (v, limits[k]) for k, v in numbers.items()}
