"""PyTorch port parity: geometry, dynamics and light phases of
thinktwice_tpu_torch against thinktwice_tpu, on the same numpy inputs,
to 1e-6 of the result's scale (masks exactly): float32 keeps ~7 digits,
so a coordinate of 50 m carries ~4e-6 m of rounding in either package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinktwice_tpu import geometry as jgeo
from thinktwice_tpu.config import SimConfig as JaxSimConfig
from thinktwice_tpu.maps.procedural import make_grid_town as jax_grid_town
from thinktwice_tpu.maps.town import traffic_light_states as jax_tl_states
from thinktwice_tpu.sim import dynamics as jdyn
from thinktwice_tpu_torch import geometry as tgeo
from thinktwice_tpu_torch.config import SimConfig
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.maps.town import traffic_light_states
from thinktwice_tpu_torch.sim import dynamics as tdyn

torch.set_num_threads(1)

TOL = 1e-6
N = 257


def _tol(ref):
    return TOL * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s, lo=-50.0, hi=50.0: r.uniform(lo, hi, s).astype(np.float32)  # noqa: E731
    return dict(
        a=f(N, lo=-12.0, hi=12.0), pos=f(N, 2), yaw=f(N, lo=-4.0, hi=4.0),
        pts=f(N, 5, 2), pos2=f(N, 2, lo=-3.0, hi=3.0), yaw2=f(N, lo=-4.0, hi=4.0),
        ext=f(N, 2, lo=0.3, hi=3.0), ext2=f(N, 2, lo=0.3, hi=3.0),
        p=f(N, 2, lo=-5, hi=5), q=f(N, 2, lo=-5, hi=5), s=f(N, 2, lo=-5, hi=5),
        t=f(N, 2, lo=-5, hi=5),
    )


CASES = {
    "wrap_angle": lambda m, x: m.wrap_angle(x["a"]),
    "rot2d": lambda m, x: m.rot2d(x["yaw"]),
    "world_from_local": lambda m, x: m.world_from_local(x["pos"], x["yaw"], x["pts"]),
    "local_from_world": lambda m, x: m.local_from_world(x["pos"], x["yaw"], x["pts"]),
    "sweep_to_key": lambda m, x: m.sweep_to_key(x["pos"], x["yaw"], x["pos2"], x["yaw2"]),
    "box_corners": lambda m, x: m.box_corners(x["pos"], x["yaw"], x["ext"]),
    "obb_overlap": lambda m, x: m.obb_overlap(x["pos2"], x["yaw"], x["ext"],
                                              x["p"], x["yaw2"], x["ext2"]),
    "point_in_obb": lambda m, x: m.point_in_obb(x["pts"] * 0.05, x["pos2"], x["yaw"], x["ext"]),
    "segment_distance": lambda m, x: m.segment_distance(x["p"], x["q"], x["s"]),
    "segments_intersect": lambda m, x: m.segments_intersect(x["p"], x["q"], x["s"], x["t"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_matches(name):
    x = _inputs()
    ref = np.asarray(CASES[name](jgeo, {k: jnp.asarray(v) for k, v in x.items()}))
    out = CASES[name](tgeo, {k: torch.from_numpy(v) for k, v in x.items()}).numpy()
    assert out.shape == ref.shape
    if ref.dtype == bool:
        np.testing.assert_array_equal(out, ref)
        assert 0 < ref.mean() < 1          # both outcomes occur
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=_tol(ref))


@pytest.mark.parametrize("drag", [0.0, 0.02])
def test_bicycle_step_matches(drag):
    x = _inputs(1)
    r = np.random.default_rng(2)
    speed = r.uniform(0, 15, N).astype(np.float32)
    steer = r.uniform(-1, 1, N).astype(np.float32)
    thr = r.uniform(0, 1, N).astype(np.float32)
    brake = (r.uniform(0, 1, N) > 0.7).astype(np.float32)
    ref = jdyn.bicycle_step(JaxSimConfig(), *(jnp.asarray(v) for v in (
        x["pos"], x["yaw"], speed, steer, thr, brake)), drag=drag)
    out = tdyn.bicycle_step(SimConfig(), *(torch.from_numpy(v) for v in (
        x["pos"], x["yaw"], speed, steer, thr, brake)), drag=drag)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=_tol(b))


def test_point_mass_step_matches():
    x = _inputs(3)
    r = np.random.default_rng(4)
    speed, rate, acc = (r.uniform(lo, hi, N).astype(np.float32)
                        for lo, hi in ((0, 10), (-1.2, 1.2), (-6, 3)))
    ref = jdyn.point_mass_step(*(jnp.asarray(v) for v in (x["pos"], x["yaw"], speed, rate, acc)), 0.05)
    out = tdyn.point_mass_step(*(torch.from_numpy(v) for v in (x["pos"], x["yaw"], speed, rate, acc)), 0.05)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=_tol(b))


def test_traffic_light_states_match_every_tick():
    """Every tick of 20 minutes, as the world step computes the time."""
    jtown, ttown = jax_grid_town(2, 100.0), make_grid_town(2, 100.0, device="cpu")
    ticks = np.arange(0, 24000, dtype=np.int32)
    t = ticks.astype(np.float32) * np.float32(0.05)
    ref = np.stack([np.asarray(jax_tl_states(jtown, jnp.asarray(v))) for v in t[::97]])
    out = traffic_light_states(ttown, torch.from_numpy(ticks).to(torch.float32) * 0.05)
    np.testing.assert_array_equal(out.numpy()[::97], ref)
    assert set(np.unique(ref[:, :16])) == {0, 1, 2}
