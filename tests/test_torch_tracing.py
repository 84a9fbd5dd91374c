"""The port's spans and sync counter (`thinktwice_tpu_torch.tracing`) on the
CPU: off they cost no `record_function` and record nothing; under the
profiler every span of the world step, the expert, the sensors and the
student's forward is in the trace inside its parent; the records add up;
outputs are bit-identical with spans on and off; a sync counts on the
innermost open span; and the benchmark's readers of the spans read them.
"""

import pytest
import torch

from port_bench import registry
from thinktwice_tpu_torch import tracing
from thinktwice_tpu_torch.agents.expert import expert_control
from thinktwice_tpu_torch.agents.roach import RoachPolicy
from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, ModelConfig, SimConfig
from thinktwice_tpu_torch.models import rig
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel
from thinktwice_tpu_torch.rollout import grid_world
from thinktwice_tpu_torch.sensors.camera import cameras_from_state
from thinktwice_tpu_torch.sensors.lidar import lidar_from_state, sample_lidar_draws
from thinktwice_tpu_torch.sim.step import sample_step_draws, step_world

torch.set_num_threads(1)

CFG = Config(sim=SimConfig(max_vehicles=16, max_walkers=8, max_lights=64,
                           max_stop_signs=8, max_route_len=256, max_scenarios=8))
CAMS = CameraConfig(height=32, width=64, n_cams=2, cam_yaws=(0.0, 180.0))
LIDAR = LidarConfig(n_beams=8, n_azimuth=64)
SMALL = ModelConfig(img_height=32, img_width=64, refine_num=2, pred_len=2, bev_channels=64,
                    n_depth_bins=16, lidar_pillar_grid=84, n_z_anchors=5, n_attn_heads=4)

PARENT = {
    "step_world.scenarios": "step_world", "step_world.traffic": "step_world",
    "step_world.criteria": "step_world", "step_world.commit": "step_world",
    "expert_control.birdview": "expert_control", "expert_control.policy": "expert_control",
    "expert_control.brakes": "expert_control",
    "student_forward.trunk": "student_forward", "student_forward.lidar": "student_forward",
    "student_forward.fusion": "student_forward", "student_forward.decoder": "student_forward",
    "student_forward.refine": "student_forward.decoder",
}
ROOTS = ("step_world", "expert_control", "cameras_from_state", "lidar_from_state",
         "student_forward")
SPANS = set(PARENT) | set(ROOTS)
READERS = ("syncs_per_tick", "world_traffic_ms", "world_criteria_ms", "expert_policy_ms",
           "student_trunk_ms", "student_decoder_ms")


@pytest.fixture(scope="module")
def parts():
    g = torch.Generator().manual_seed(0)
    town, state = grid_world(CFG, 2, 4, device="cpu", generator=g)
    torch.manual_seed(0)
    policy = RoachPolicy.from_config(CFG).eval()
    model = ThinkTwiceModel(SMALL, backbone_depth=10, n_sweeps=1, n_cams=2).eval()
    B, P = 2, 256
    inputs = (torch.randn(B, 1, 2, 32, 64, 3, generator=g),
              torch.cat([torch.rand(B, P, 2, generator=g) * 40 - 10,
                         torch.rand(B, P, 3, generator=g)], -1),
              torch.rand(B, P, generator=g) > 0.2, torch.rand(B, generator=g) * 5,
              torch.rand(B, 2, generator=g) * 20, torch.eye(6)[[3, 1]],
              torch.as_tensor(rig.cam_to_ego(CAMS)), torch.as_tensor(rig.intrinsics(CAMS)),
              torch.as_tensor(rig.ego_to_img(CAMS)))
    return town, state, policy, model, inputs


def tick(parts):
    """A grid tick (the expert, the world step), the sensors and a student
    forward -> every output, in a list."""
    town, state, policy, model, inputs = parts
    ctrl, sup = expert_control(CFG, policy, town, state)
    draws = sample_step_draws(town, state, torch.Generator().manual_seed(1))
    new_state, events = step_world(CFG, town, state, ctrl, draws=draws)
    cams = cameras_from_state(CAMS, town, state)
    ldraws = sample_lidar_draws(LIDAR, 2, "cpu", torch.Generator().manual_seed(2))
    pts, mask = lidar_from_state(LIDAR, town, state, draws=ldraws)
    with torch.no_grad():
        outs = model(*inputs)
    leaves = [ctrl, *sup.values(), new_state, events, cams, pts, mask, outs]
    flat = []
    while leaves:
        x = leaves.pop()
        if torch.is_tensor(x):
            flat.append(x)
        elif isinstance(x, dict):
            leaves.extend(x.values())
        elif isinstance(x, (tuple, list)):
            leaves.extend(x)
        elif hasattr(x, "__dataclass_fields__"):
            leaves.extend(getattr(x, f) for f in x.__dataclass_fields__)
    return flat


@pytest.fixture(scope="module")
def profiled(parts):
    """(the profiler's events, the span records) of one tick under the
    profiler."""
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tick(parts)
    return prof.events(), tracing.records()


def test_off_spans_make_no_record_function(parts, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with the spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tracing.reset()
    town, state, policy, _, _ = parts
    ctrl, _ = expert_control(CFG, policy, town, state)
    step_world(CFG, town, state, ctrl, generator=torch.Generator().manual_seed(1))
    assert tracing.records() == {}
    assert tracing.span("step_world") is tracing.span("expert_control")


def test_every_span_sits_inside_its_parent_in_the_trace(profiled):
    events, _ = profiled
    spans: dict[str, list] = {}
    for e in events:
        if e.name in SPANS:
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert set(spans) == SPANS
    assert len(spans["student_forward.refine"]) == SMALL.refine_num
    for child, parent in PARENT.items():
        for a, b in spans[child]:
            assert any(p0 <= a and b <= p1 for p0, p1 in spans[parent]), child


def test_records_add_up(profiled):
    _, recs = profiled
    assert set(recs) == SPANS
    for name, r in recs.items():
        assert r["parent"] == PARENT.get(name), name
        assert r["calls"] == len(r["device_ms"]) >= 1, name
        assert 0 <= r["self_host_ms"] <= r["host_ms"], name
        assert r["syncs"] == 0, name     # no card: nothing synchronises
    assert recs["student_forward.refine"]["calls"] == SMALL.refine_num
    assert recs["student_forward.fusion"]["calls"] == 2   # before and after the decoder
    for parent in ("step_world", "expert_control", "student_forward",
                   "student_forward.decoder"):
        kids = sum(r["host_ms"] for n, r in recs.items() if r["parent"] == parent)
        r = recs[parent]
        assert r["self_host_ms"] == pytest.approx(r["host_ms"] - kids, rel=1e-6, abs=1e-6)
        assert kids >= 0.8 * r["host_ms"], parent


def test_outputs_are_bit_identical_with_spans_on_and_off(parts):
    off = tick(parts)
    with tracing.recording():
        on = tick(parts)
    assert len(on) == len(off) > 40
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_sync_counts_on_the_innermost_span():
    def sync():
        tracing._showwarning(UserWarning(tracing.SYNC_WARNING + " (Triggered internally.)"),
                             UserWarning, "x.py", 1)

    tracing.reset()
    with tracing.recording():
        with tracing.span("outer"):
            with tracing.span("inner"):
                sync()
                sync()
            sync()
        sync()
    sync()   # spans off: neither counted nor shown
    recs = tracing.records()
    assert (recs["inner"]["syncs"], recs["outer"]["syncs"]) == (2, 1)
    assert recs["inner"]["parent"] == "outer" and recs["outer"]["parent"] is None
    assert tracing.syncs_outside() == 1
    tracing.reset()
    assert tracing.records() == {} and tracing.syncs_outside() == 0


def test_the_benchmark_readers_read_the_spans(parts):
    tracing.reset()
    traced = {"trace": {"steps": 1}}
    assert all(registry.reader(name)(traced) is None for name in READERS)
    with tracing.recording():
        tick(parts)
    for name in READERS:
        read = registry.reader(name)
        value = read(traced)
        assert isinstance(value, float) and value >= 0.0, name
        assert read({"steps": 1}) is None, name
    assert registry.reader("syncs_per_tick")(traced) == 0.0
    tracing.reset()
