"""PyTorch port parity: the student's sensors (cameras with the light
fixtures and the weather, lidar with its rain drops and jitter, the
two-sweep merge) of thinktwice_tpu_torch against thinktwice_tpu on the CPU.

Both packages see the same worlds (the JAX package's, converted) and the
same random numbers: the JAX package's draws from each world's key are
handed to the port. Ray directions are built with other float operations in
the two packages (a matmul against XLA's einsum), so a ray that grazes a box
edge may land on the other side: at most 1e-3 of the camera pixels and 1e-3
of the lidar beams may differ in class or hit; elsewhere depth, range and
points agree to 1e-4 relative and colours to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sim import configs, jax_batch_step, jax_reset_batch, towns, two_routes
from thinktwice_tpu.config import CameraConfig as JaxCameraConfig
from thinktwice_tpu.config import LidarConfig as JaxLidarConfig
from thinktwice_tpu.sensors import camera as jcam
from thinktwice_tpu.sensors import lidar as jlid
from thinktwice_tpu.sim.weather import make_weather
from thinktwice_tpu_torch.config import CameraConfig, LidarConfig
from thinktwice_tpu_torch.sensors import camera as cam
from thinktwice_tpu_torch.sensors import lidar as lid
from thinktwice_tpu_torch.sensors.lidar import LidarDraws
from thinktwice_tpu_torch.sim.state import state_from_arrays

torch.set_num_threads(1)

CAM = dict(height=48, width=96)
LIDAR = dict(n_beams=16, n_azimuth=256)
EDGE_SHARE = 1e-3   # share of pixels / beams that may differ at box edges
REL = 1e-4
RGB_ATOL = 1e-5


@pytest.fixture(scope="module")
def worlds():
    """Two worlds after 30 ticks of driving, in rain, fog and cloud."""
    jcfg, _ = configs()
    jtown, ttown = towns()
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=3, n_vehicles=12)
    weather = np.stack([make_weather(cloudiness=60.0, precipitation=80.0, wetness=70.0,
                                     fog_density=30.0, sun_altitude_angle=20.0),
                        make_weather(precipitation=30.0, sun_altitude_angle=-10.0)])
    jstate = dataclasses.replace(jstate, weather=jnp.asarray(weather))
    step = jax_batch_step(jcfg, jtown)
    ctrl = jnp.asarray([[0.0, 0.5, 0.0]] * 2)
    for _ in range(30):
        jstate, _ = step(jstate, ctrl)
    return jtown, ttown, jstate, state_from_arrays(jstate, device="cpu")


def _share(a, b):
    return float(np.mean(a != b))


def test_cameras_match_jax(worlds):
    jtown, ttown, jstate, tstate = worlds
    jc, tc = JaxCameraConfig(**CAM), CameraConfig(**CAM)
    # jitted, as the JAX package runs its sensors: one compile, not one a primitive
    ref = jax.jit(jax.vmap(lambda s: jcam.cameras_from_state(jc, jtown, s)))(jstate)
    shape = (tc.n_cams, tc.height, tc.width, 3)
    noise = jax.jit(jax.vmap(
        lambda s: jax.random.normal(jax.random.fold_in(s.rng, s.tick), shape)))(jstate)
    out = cam.cameras_from_state(tc, ttown, tstate, rain_noise=torch.as_tensor(np.asarray(noise)))
    sem, rsem = out["semantic"].numpy(), np.asarray(ref["semantic"])
    assert sem.shape == rsem.shape
    assert _share(sem, rsem) <= EDGE_SHARE, _share(sem, rsem)
    same = sem == rsem
    np.testing.assert_allclose(out["depth"].numpy()[same], np.asarray(ref["depth"])[same],
                               rtol=REL, atol=1e-5)
    np.testing.assert_allclose(out["rgb"].numpy()[same], np.asarray(ref["rgb"])[same],
                               rtol=0, atol=RGB_ATOL)
    # the scene holds road, sky and at least one vehicle and light fixture
    for cls in (1, 0, 4):
        assert (sem == cls).any(), cls
    assert (sem >= 7).any()


def test_camera_rays_match_jax():
    c = CameraConfig(**CAM)
    ref = np.asarray(jcam._pixel_rays(JaxCameraConfig(**CAM)))
    np.testing.assert_allclose(cam._pixel_rays(c, "cpu").numpy(), ref, rtol=0, atol=1e-6)


def test_lidar_matches_jax(worlds):
    jtown, ttown, jstate, tstate = worlds
    jl, tl = JaxLidarConfig(**LIDAR), LidarConfig(**LIDAR)
    P = tl.n_beams * tl.n_azimuth
    pts_ref, mask_ref = jax.jit(jax.vmap(lambda s: jlid.lidar_from_state(jl, jtown, s)))(jstate)

    def draws(s):
        k1, k2 = jax.random.split(jax.random.fold_in(s.rng, s.tick + 7919))
        return jax.random.uniform(k1, (P,)), jax.random.normal(k2, (P, 3))

    keep, jitter = (torch.as_tensor(np.asarray(a)) for a in jax.jit(jax.vmap(draws))(jstate))
    pts, mask = lid.lidar_from_state(tl, ttown, tstate, draws=LidarDraws(keep, jitter))
    mask, mask_ref = mask.numpy(), np.asarray(mask_ref)
    assert _share(mask, mask_ref) <= EDGE_SHARE, _share(mask, mask_ref)
    both = mask & mask_ref
    assert both.sum() > 0.2 * P
    np.testing.assert_allclose(pts.numpy()[both], np.asarray(pts_ref)[both], rtol=REL,
                               atol=1e-4)
    assert not (pts.numpy()[~mask] != 0).any()


def test_beam_dirs_match_jax():
    ref = np.asarray(jlid._beam_dirs(JaxLidarConfig(**LIDAR)))
    np.testing.assert_allclose(lid._beam_dirs(LidarConfig(**LIDAR), "cpu").numpy(), ref,
                               rtol=0, atol=1e-6)


def test_apply_weather_matches_jax():
    rng = np.random.default_rng(0)
    B, N, H, W = 2, 2, 6, 8
    rgb = rng.uniform(size=(B, N, H, W, 3)).astype(np.float32)
    depth = np.where(rng.uniform(size=(B, N, H, W)) > 0.3,
                     rng.uniform(0, 60, (B, N, H, W)), 0.0).astype(np.float32)
    sem = rng.integers(0, 11, (B, N, H, W))
    weather = np.stack([make_weather(cloudiness=40.0, precipitation=50.0, fog_density=60.0,
                                     fog_falloff=0.05, sun_altitude_angle=35.0),
                        make_weather(sun_altitude_angle=-20.0)])
    key = jax.random.key(1)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, b), rgb.shape[1:]))
                      for b in range(B)])
    out = cam.apply_weather(torch.as_tensor(rgb), torch.as_tensor(depth),
                            torch.as_tensor(sem), torch.as_tensor(weather),
                            torch.as_tensor(noise))
    for b in range(B):
        ref = jcam.apply_weather(jnp.asarray(rgb[b]), jnp.asarray(depth[b]),
                                 jnp.asarray(sem[b]), jnp.asarray(weather[b]),
                                 jax.random.fold_in(key, b))
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_merge_sweeps_matches_jax():
    rng = np.random.default_rng(2)
    B, P = 2, 50
    now = rng.normal(size=(B, P, 4)).astype(np.float32) * 10
    prev = rng.normal(size=(B, P, 4)).astype(np.float32) * 10
    m_now, m_prev = rng.uniform(size=(B, P)) > 0.3, rng.uniform(size=(B, P)) > 0.3
    pos_now = rng.uniform(0, 100, (B, 2)).astype(np.float32)
    pos_prev = (pos_now + rng.normal(size=(B, 2))).astype(np.float32)
    yaw_now, yaw_prev = (rng.uniform(-3, 3, B).astype(np.float32) for _ in range(2))
    pts, mask = lid.merge_sweeps(
        torch.as_tensor(now), torch.as_tensor(m_now), torch.as_tensor(prev),
        torch.as_tensor(m_prev), (torch.as_tensor(pos_now), torch.as_tensor(yaw_now)),
        (torch.as_tensor(pos_prev), torch.as_tensor(yaw_prev)))
    for b in range(B):
        rp, rm = jlid.merge_sweeps(
            jnp.asarray(now[b]), jnp.asarray(m_now[b]), jnp.asarray(prev[b]),
            jnp.asarray(m_prev[b]), (jnp.asarray(pos_now[b]), jnp.asarray(yaw_now[b])),
            (jnp.asarray(pos_prev[b]), jnp.asarray(yaw_prev[b])))
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(rm))
        np.testing.assert_allclose(pts[b].numpy(), np.asarray(rp), rtol=1e-5, atol=1e-4)
