"""PyTorch port parity: in-loop data collection of thinktwice_tpu_torch
against thinktwice_tpu's on the CPU.

- `collect_batch`: two worlds of the grid town at the JAX suite's TINY
  sensor sizes (tests/test_pipeline.py), the roach_rl6 expert in both
  packages (the port's converter), 6 frames of 10 ticks. The port gets the
  draws of the JAX package's key chain: each tick's step draws and each
  frame's camera and lidar draws, from each world's key as the JAX world
  step advances it. Poses agree to 1e-4 m; the command, only_ap_brake and
  the lidar mask are equal; the Beta parameters, value and features agree
  to 1e-4 of their scale (the Roach feature grids, where a birdview pixel
  at a primitive's edge differs, off by more than that on at most 1% of
  their values and within 1e-2 of scale); the sensors within the tolerances of
  tests/test_torch_sensors.py (at most 1e-3 of the pixels differ at box
  edges, depth 1e-4 relative, colours 1e-5).
- `frames_to_batch` on the same numpy frames, with one sweep and with two:
  every key within 1e-6.
- `collect_rollout` (the frames without the sensors) gives collect_batch's
  frames on the same draws.
- `command_onehot` and `_target_point`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_sim import two_routes
from thinktwice_tpu.agents.expert import _target_point as jax_target_point
from thinktwice_tpu.config import CameraConfig as JCam
from thinktwice_tpu.config import Config as JConfig
from thinktwice_tpu.config import LidarConfig as JLidar
from thinktwice_tpu.config import ModelConfig as JModel
from thinktwice_tpu.config import SimConfig as JSim
from thinktwice_tpu.maps.procedural import make_grid_town as jax_grid_town
from thinktwice_tpu.sim.reset import reset_world as jax_reset_world
from thinktwice_tpu.train import collect as jcollect
from thinktwice_tpu_torch.agents.expert import Frame, _target_point, collect_rollout
from thinktwice_tpu_torch.agents.thinktwice_driver import SensorDraws
from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, ModelConfig, SimConfig
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.sensors.lidar import LidarDraws
from thinktwice_tpu_torch.sim.state import state_from_arrays
from thinktwice_tpu_torch.sim.step import StepDraws
from thinktwice_tpu_torch.train import collect
from thinktwice_tpu_torch.weights import load_roach_policy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RL6 = os.path.join(REPO, "runs", "roach_rl6", "params.msgpack")
SIM = dict(max_vehicles=8, max_walkers=4, max_route_len=256, max_scenarios=4)
CAM = dict(height=32, width=64)
LIDAR = dict(n_beams=4, n_azimuth=64)
MODEL = dict(img_height=32, img_width=64, refine_num=1, bev_channels=64, n_depth_bins=16,
             lidar_pillar_grid=84)
N_FRAMES, TICKS = 6, 10
POSE_TOL = 1e-4
EDGE_SHARE = 1e-3
BIRDVIEW_SHARE = 1e-4  # birdview values that may differ at a primitive's edge
GRID_SHARE = 1e-2      # Roach grid values beyond 1e-4 of scale near such a pixel


def _step_draws(keys, V, n_spawn) -> StepDraws:
    """The draws step_world makes from each world's key."""
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    normal = jax.vmap(lambda k: jax.random.normal(k, ()))(sub[:, 1])
    cand = jax.vmap(lambda k: jax.random.randint(k, (V,), 0, n_spawn))(sub[:, 2])
    return StepDraws(steer_normal=torch.tensor(np.asarray(normal)),
                     recycle_cand=torch.as_tensor(np.asarray(cand).astype(np.int64)))


def _sensor_draws(keys, ticks, jcfg) -> SensorDraws:
    """The draws the cameras and the lidar make from each world's key and
    tick."""
    cam, lid = jcfg.camera, jcfg.lidar
    P = lid.n_beams * lid.n_azimuth

    def one(k, t):
        noise = jax.random.normal(jax.random.fold_in(k, t),
                                  (cam.n_cams, cam.height, cam.width, 3))
        k1, k2 = jax.random.split(jax.random.fold_in(k, t + 7919))
        return noise, jax.random.uniform(k1, (P,)), jax.random.normal(k2, (P, 3))

    noise, keep, jitter = (torch.as_tensor(np.asarray(a)) for a in jax.vmap(one)(keys, ticks))
    return SensorDraws(rain_noise=noise, lidar=LidarDraws(keep, jitter))


@pytest.fixture(scope="module")
def collected():
    jcfg = JConfig(sim=JSim(**SIM), camera=JCam(**CAM), lidar=JLidar(**LIDAR),
                   model=JModel(**MODEL))
    cfg = Config(sim=SimConfig(**SIM), camera=CameraConfig(**CAM),
                 lidar=LidarConfig(**LIDAR), model=ModelConfig(**MODEL))
    jtown = jax_grid_town(n_blocks=2, block=100.0)
    ttown = make_grid_town(n_blocks=2, block=100.0, device="cpu")
    with open(RL6, "rb") as f:
        jparams = serialization.msgpack_restore(f.read())
    keys = jax.random.split(jax.random.key(5), 2)
    jstate = jax.vmap(lambda r, k: jax_reset_world(jcfg, jtown, r, k, n_vehicles=4))(
        jnp.asarray(two_routes()), keys)
    start = state_from_arrays(jstate, device="cpu")
    collect_v = jax.jit(jax.vmap(jcollect.collect_batch, in_axes=(None, None, None, 0, None)),
                        static_argnums=(0, 4))
    jfinal, jframes, jsensors = collect_v(jcfg, jparams, jtown, jstate, N_FRAMES)

    # the key chain of the JAX world step, and the draws from it
    V, n_spawn = jstate.traffic.active.shape[1], jtown.spawn.shape[0]
    k, step_draws, sensor_draws = jstate.rng, [], []
    for t in range(N_FRAMES * TICKS):
        if t % TICKS == 0:
            sensor_draws.append(_sensor_draws(k, jstate.tick + t, jcfg))
        step_draws.append(_step_draws(k, V, n_spawn))
        k = jax.vmap(lambda x: jax.random.split(x, 3)[0])(k)
    assert np.array_equal(jax.random.key_data(k), jax.random.key_data(jfinal.rng))

    policy = load_roach_policy(RL6, cfg, device="cpu")
    final, frames, sensors = collect.collect_batch(cfg, policy, ttown, start, N_FRAMES,
                                                   step_draws=step_draws,
                                                   sensor_draws=sensor_draws)
    return dict(cfg=cfg, jcfg=jcfg, jfinal=jfinal, jframes=jframes, jsensors=jsensors,
                final=final, frames=frames, sensors=sensors, jstate=jstate, policy=policy,
                ttown=ttown, start=start, step_draws=step_draws)


def _scale_close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-6)


def test_collect_batch_matches_jax(collected):
    c = collected
    fr, jf = c["frames"], c["jframes"]
    assert fr.pos.shape == (2, N_FRAMES, 2)
    np.testing.assert_allclose(fr.pos.numpy(), np.asarray(jf.pos), rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(c["final"].ego.pos.numpy(), np.asarray(c["jfinal"].ego.pos),
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(fr.speed.numpy(), np.asarray(jf.speed), rtol=0, atol=POSE_TOL)
    assert np.array_equal(fr.command.numpy(), np.asarray(jf.command))
    sup, jsup = fr.supervision, jf.supervision
    assert np.array_equal(sup["only_ap_brake"].numpy(), np.asarray(jsup["only_ap_brake"]))
    for key in ("alpha", "beta", "value", "features"):
        _scale_close(sup[key], jsup[key], 1e-4)
    # the birdviews may differ on a pixel at a primitive's edge (K1's plain
    # version against the JAX rasterizer), which moves the Roach grids there
    bv, jbv = sup["birdview"].numpy(), np.asarray(jsup["birdview"])
    assert float(np.mean(bv != jbv)) <= BIRDVIEW_SHARE
    for a, b in zip(sup["cnn_features"], jsup["cnn_features"]):
        a, b = a.numpy(), np.asarray(b)
        off = np.abs(a - b) > 1e-4 * np.abs(b).max()
        assert float(np.mean(off)) <= GRID_SHARE and np.abs(a - b).max() <= 1e-2 * np.abs(b).max()
    np.testing.assert_allclose(fr.target_point.numpy(), np.asarray(jf.target_point), rtol=0,
                               atol=1e-3)
    # the egos moved, and the sensors saw the world
    assert float(np.abs(np.diff(np.asarray(jf.pos), axis=1)).sum()) > 1.0

    s, js = c["sensors"], c["jsensors"]
    sem, jsem = s["semantic"].numpy(), np.asarray(js["semantic"])
    assert float(np.mean(sem != jsem)) <= EDGE_SHARE
    same = sem == jsem
    np.testing.assert_allclose(s["depth"].numpy()[same], np.asarray(js["depth"])[same],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s["rgb"].numpy()[same], np.asarray(js["rgb"])[same], rtol=0,
                               atol=1e-5)
    mask, jmask = s["lidar_mask"].numpy(), np.asarray(js["lidar_mask"])
    assert np.array_equal(mask, jmask)
    assert mask.sum() > 0
    np.testing.assert_allclose(s["lidar"].numpy()[mask], np.asarray(js["lidar"])[mask],
                               rtol=1e-4, atol=1e-4)


def _frames_from_jax(jf) -> Frame:
    def t(x):
        a = np.asarray(x)
        return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)

    sup = {k: (tuple(t(g) for g in v) if isinstance(v, tuple) else t(v))
           for k, v in jf.supervision.items()}
    return Frame(**{f.name: t(getattr(jf, f.name)) for f in dataclasses.fields(Frame)
                    if f.name != "supervision"}, supervision=sup)


@pytest.mark.parametrize("n_sweeps", [1, 2])
def test_frames_to_batch_matches_jax(collected, n_sweeps):
    c = collected
    jf, js = c["jframes"], c["jsensors"]
    ref = jax.vmap(lambda f, s: jcollect.frames_to_batch(c["jcfg"], f, s, 4, n_sweeps=n_sweeps))(
        jf, js)
    ref = jax.tree.map(lambda x: np.asarray(x).reshape((-1,) + x.shape[2:]), ref)
    got = collect.frames_to_batch(c["cfg"], _frames_from_jax(jf),
                                  {k: torch.as_tensor(np.asarray(v)) for k, v in js.items()},
                                  4, n_sweeps=n_sweeps)
    assert set(got) == set(ref)
    n = 2 * (N_FRAMES - 4 - (n_sweeps - 1))
    assert got["imgs"].shape[:2] == (n, n_sweeps)
    for key, want in ref.items():
        have = got[key]
        pairs = zip(have, want) if isinstance(want, tuple) else [(have, want)]
        for a, b in pairs:
            a = a.numpy()
            assert a.shape == b.shape, (key, a.shape, b.shape)
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=0,
                                       atol=1e-6 * max(1.0, float(np.abs(b).max())),
                                       err_msg=key)


def test_collect_rollout_gives_collect_batchs_frames(collected):
    c = collected
    final, frames = collect_rollout(c["cfg"], c["policy"], c["ttown"], c["start"], N_FRAMES,
                                    step_draws=c["step_draws"])
    assert torch.equal(final.ego.pos, c["final"].ego.pos)
    for f in dataclasses.fields(Frame):
        a, b = getattr(frames, f.name), getattr(c["frames"], f.name)
        if isinstance(a, dict):
            for k in a:
                pairs = zip(a[k], b[k]) if isinstance(a[k], tuple) else [(a[k], b[k])]
                assert all(torch.equal(x, y) for x, y in pairs), k
        else:
            assert torch.equal(a, b), f.name
    with pytest.raises(ValueError, match="Generator"):
        collect_rollout(c["cfg"], c["policy"], c["ttown"], c["start"], 1)


def test_command_onehot_and_target_point_match_jax(collected):
    rng = np.random.default_rng(0)
    tp = rng.uniform(-20, 20, (64, 2)).astype(np.float32)
    np.testing.assert_array_equal(collect.command_onehot(torch.as_tensor(tp)).numpy(),
                                  np.asarray(jcollect.command_onehot(jnp.asarray(tp))))
    for jstate in (collected["jstate"], collected["jfinal"]):
        np.testing.assert_allclose(
            _target_point(state_from_arrays(jstate, device="cpu")).numpy(),
            np.asarray(jax.vmap(jax_target_point)(jstate)), rtol=0, atol=1e-4)
