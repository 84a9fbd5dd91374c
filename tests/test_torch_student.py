"""PyTorch port parity: the ThinkTwice student's closed loop (sensors, the
two-sweep model, the PID and the fusion rules, the world step) of
thinktwice_tpu_torch against thinktwice_tpu's driver on the CPU.

Two worlds at the JAX suite's TINY config (tests/test_pipeline.py) with a
two-sweep ResNet-10 student whose flax init is converted by the port's
converter, for 5 policy calls with a 2-slot history ring (warm for the
last 3). Both packages get the same random draws (the JAX package's, from
each world's key).

- The agent (process_action, control_pid with its PID carry,
  fuse_controls), the target point and the route command on the same
  numbers: equal to 1e-5, flags and counters exactly.
- Per policy call on the same state, and in a free run of
  rollout_thinktwice from the same start: the model runs in bfloat16,
  rounded in another order (tests/test_torch_model_full.py), and the speed
  PID multiplies a waypoint's drift by its gain of 5, so the controls agree
  to 5e-2 and the brake flags exactly; the poses agree
  to 1e-2 m after 5 ticks, the rings hold the same poses and the world's
  counters are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_sim import jax_step_draws, two_routes
from thinktwice_tpu.agents.thinktwice_driver import driver_init as jax_driver_init
from thinktwice_tpu.agents.thinktwice_driver import make_thinktwice_driver as jax_make_driver
from thinktwice_tpu.config import CameraConfig as JCam
from thinktwice_tpu.config import Config as JConfig
from thinktwice_tpu.config import LidarConfig as JLidar
from thinktwice_tpu.config import ModelConfig as JModel
from thinktwice_tpu.config import SimConfig as JSim
from thinktwice_tpu.maps.procedural import make_grid_town as jax_grid_town
from thinktwice_tpu.sim.reset import reset_world as jax_reset_world
from thinktwice_tpu.sim.step import step_world as jax_step_world
from thinktwice_tpu.models import rig as jrig
from thinktwice_tpu.train.loop import make_model
from thinktwice_tpu_torch.agents.thinktwice_driver import (
    SensorDraws,
    driver_init,
    make_thinktwice_driver,
    rollout_thinktwice,
)
from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, ModelConfig, SimConfig
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel
from thinktwice_tpu_torch.sensors.lidar import LidarDraws
from thinktwice_tpu_torch.sim.state import state_from_arrays
from thinktwice_tpu_torch.weights import student_state_dict_from_flax

torch.set_num_threads(1)

SIM = dict(max_vehicles=8, max_walkers=4, max_route_len=256, max_scenarios=4)
CAM = dict(height=32, width=64)
LIDAR = dict(n_beams=4, n_azimuth=64)
MODEL = dict(img_height=32, img_width=64, refine_num=1, bev_channels=64, n_depth_bins=16,
             lidar_pillar_grid=84)
HIST = 2
N_TICKS = HIST + 3
CTRL_TOL = 5e-2       # controls of the bfloat16 model's driver
AGENT_TOL = 1e-5      # the agent's arithmetic on the same model outputs
POSE_TOL = 1e-2       # m after N_TICKS ticks


def _jax_sensor_draws(jcfg, jstate) -> SensorDraws:
    """The draws the JAX package's cameras and lidar make from each world's
    key and tick."""
    cam, lid = jcfg.camera, jcfg.lidar
    P = lid.n_beams * lid.n_azimuth

    def one(s):
        noise = jax.random.normal(jax.random.fold_in(s.rng, s.tick),
                                  (cam.n_cams, cam.height, cam.width, 3))
        k1, k2 = jax.random.split(jax.random.fold_in(s.rng, s.tick + 7919))
        return noise, jax.random.uniform(k1, (P,)), jax.random.normal(k2, (P, 3))

    noise, keep, jitter = (torch.as_tensor(np.asarray(a)) for a in jax.vmap(one)(jstate))
    return SensorDraws(rain_noise=noise, lidar=LidarDraws(keep, jitter))


def test_student_loop_matches_jax():
    jcfg = JConfig(sim=JSim(**SIM), camera=JCam(**CAM), lidar=JLidar(**LIDAR),
                   model=JModel(**MODEL))
    cfg = Config(sim=SimConfig(**SIM), camera=CameraConfig(**CAM),
                 lidar=LidarConfig(**LIDAR), model=ModelConfig(**MODEL))
    jtown = jax_grid_town(n_blocks=2, block=100.0)
    ttown = make_grid_town(n_blocks=2, block=100.0, device="cpu")

    jmodel = make_model(jcfg, backbone_depth=10, n_sweeps=2)
    n_rays = jcfg.lidar.n_beams * jcfg.lidar.n_azimuth
    m, N = jcfg.model, jcfg.camera.n_cams
    params = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1, 2, N, m.img_height, m.img_width, 3)),
        jnp.zeros((1, 2 * n_rays, 5)), jnp.ones((1, 2 * n_rays), bool), jnp.zeros((1,)),
        jnp.zeros((1, 2)), jnp.zeros((1, 6)), jnp.asarray(jrig.cam_to_ego(jcfg.camera)),
        jnp.asarray(jrig.intrinsics(jcfg.camera)), jnp.asarray(jrig.ego_to_img(jcfg.camera)))
    model = ThinkTwiceModel(cfg.model, backbone_depth=10, n_sweeps=2)
    model.load_state_dict(student_state_dict_from_flax(jax.tree.map(np.asarray, params),
                                                       model), strict=True)
    model.eval()

    keys = jax.random.split(jax.random.key(5), 2)
    jstate = jax.vmap(lambda r, k: jax_reset_world(jcfg, jtown, r, k, n_vehicles=4))(
        jnp.asarray(two_routes()), keys)
    jstate = dataclasses.replace(jstate, ego=dataclasses.replace(
        jstate.ego, speed=jnp.full((2,), 4.0)))
    start = state_from_arrays(jstate, device="cpu")
    jdrv = jax.tree.map(lambda x: jnp.stack([x, x]),
                        jax_driver_init(jcfg, n_sweeps=2, hist_len=HIST))
    jpolicy = jax_make_driver(jcfg, jmodel, params)
    policy_step = jax.jit(jax.vmap(lambda s, d: jpolicy(jcfg, jtown, s, d)))
    world_step = jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))

    policy = make_thinktwice_driver(cfg, model)
    drv = driver_init(cfg, 2, n_sweeps=2, hist_len=HIST, device="cpu")
    sensor_draws, step_draws, jctrls = [], [], []
    for _ in range(N_TICKS):
        sensor_draws.append(_jax_sensor_draws(jcfg, jstate))
        step_draws.append(jax_step_draws(jstate, jtown.spawn.shape[0]))
        jctrl, jdrv = policy_step(jstate, jdrv)
        # the port's policy on the same state, its driver in lockstep
        ctrl, drv = policy(ttown, state_from_arrays(jstate, device="cpu"), drv,
                           draws=sensor_draws[-1])
        jctrl = np.asarray(jctrl)
        np.testing.assert_allclose(ctrl.numpy(), jctrl, rtol=0, atol=CTRL_TOL)
        np.testing.assert_array_equal(ctrl.numpy()[:, 2], jctrl[:, 2])
        jctrls.append(jctrl)
        jstate, _ = world_step(jstate, jnp.asarray(jctrl))

    assert drv.tick == N_TICKS
    np.testing.assert_array_equal(drv.agent.stuck_ticks.numpy(), np.asarray(jdrv.agent.stuck_ticks))
    np.testing.assert_allclose(drv.agent.turn_pid.window.numpy(),
                               np.asarray(jdrv.agent.turn_pid.window), rtol=0, atol=CTRL_TOL)
    np.testing.assert_allclose(drv.pos_ring.numpy(), np.asarray(jdrv.pos_ring[0]), rtol=0,
                               atol=1e-5)

    final, fdrv, ctrls = rollout_thinktwice(cfg, ttown, model, start, N_TICKS,
                                            sensor_draws=sensor_draws,
                                            step_draws=step_draws, hist_len=HIST)
    assert len(ctrls) == N_TICKS and fdrv.tick == N_TICKS
    for a, b in zip(ctrls, jctrls):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=CTRL_TOL)
        np.testing.assert_array_equal(a.numpy()[:, 2], b[:, 2])
    np.testing.assert_allclose(final.ego.pos.numpy(), np.asarray(jstate.ego.pos), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(final.ego.speed.numpy(), np.asarray(jstate.ego.speed),
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(final.tick.numpy(), np.asarray(jstate.tick))
    for name in ("n_collision_vehicle", "n_red_light", "route_idx", "ticks"):
        np.testing.assert_array_equal(getattr(final.criteria, name).numpy(),
                                      np.asarray(getattr(jstate.criteria, name)), err_msg=name)
    np.testing.assert_allclose(fdrv.pos_ring.numpy(), np.asarray(jdrv.pos_ring[0]),
                               rtol=0, atol=POSE_TOL)
    assert np.isfinite(np.stack([c.numpy() for c in ctrls])).all()


def test_agent_matches_jax():
    """The agent's arithmetic on the same model outputs, 30 calls with the
    PID carry, stuck and creep counters, a wide spread of waypoints."""
    from thinktwice_tpu.agents import thinktwice as jtw
    from thinktwice_tpu_torch.agents import thinktwice as tw

    rng = np.random.default_rng(0)
    B = 3
    jagent = jax.tree.map(lambda x: jnp.stack([x] * B), jtw.agent_init())
    agent = tw.agent_init(B, "cpu")

    def jstep(a, alpha, beta, wps, speed, tp):
        sn, tn, bn = jtw.process_action(alpha, beta)
        sp, tpid, bp, _, a = jtw.control_pid(a, wps, speed, tp)
        turning = jnp.abs(jnp.arctan2(tp[1], tp[0])) > 0.25
        return jtw.fuse_controls(a, sn, tn, bn, sp, tpid, bp, speed, turning)

    jstep = jax.jit(jax.vmap(jstep))
    from thinktwice_tpu_torch.agents.thinktwice_driver import controls_from_outputs

    for t in range(30):
        alpha = rng.uniform(0.5, 3.0, (B, 2)).astype(np.float32)
        beta = rng.uniform(0.5, 3.0, (B, 2)).astype(np.float32)
        wps = np.cumsum(rng.uniform(-0.5, 2.0, (B, 4, 2)), axis=1).astype(np.float32)
        speed = (rng.uniform(0, 6, B) * (t % 7 > 0)).astype(np.float32)
        tp = rng.uniform(-20, 40, (B, 2)).astype(np.float32)
        jctrl, jagent = jstep(jagent, *(jnp.asarray(a) for a in (alpha, beta, wps, speed, tp)))
        outs = {"mu_branches": torch.as_tensor(alpha)[:, None],
                "sigma_branches": torch.as_tensor(beta)[:, None],
                "pred_wp": torch.as_tensor(wps)[:, None]}
        ctrl, agent = controls_from_outputs(outs, agent, torch.as_tensor(speed),
                                            torch.as_tensor(tp))
        np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl), rtol=0, atol=AGENT_TOL)
    for name in ("stuck_ticks", "creep_ticks"):
        np.testing.assert_array_equal(getattr(agent, name).numpy(),
                                      np.asarray(getattr(jagent, name)))
    for pid in ("turn_pid", "speed_pid"):
        np.testing.assert_allclose(getattr(agent, pid).window.numpy(),
                                   np.asarray(getattr(jagent, pid).window), atol=AGENT_TOL)


def test_target_point_and_route_command_match_jax():
    from thinktwice_tpu.agents.thinktwice_driver import _target_point as jax_target_point
    from thinktwice_tpu.train.collect import route_command as jax_route_command
    from thinktwice_tpu_torch.agents.thinktwice_driver import _target_point
    from thinktwice_tpu_torch.train.collect import route_command

    jcfg = JConfig(sim=JSim(**SIM))
    jtown = jax_grid_town(n_blocks=2, block=100.0)
    ttown = make_grid_town(n_blocks=2, block=100.0, device="cpu")
    # an L-shaped route through the junction at (100, 100), a straight one
    xs = np.linspace(60.0, 101.75, 128)
    ys = np.linspace(98.25, 160.0, 128)
    turn = np.concatenate([np.stack([xs, np.full_like(xs, 98.25), np.zeros_like(xs)], 1),
                           np.stack([np.full_like(ys, 101.75), ys,
                                     np.full_like(ys, np.pi / 2)], 1)])
    routes = np.stack([turn, two_routes()[1]]).astype(np.float32)
    keys = jax.random.split(jax.random.key(1), 2)
    jstate = jax.vmap(lambda r, k: jax_reset_world(jcfg, jtown, r, k))(jnp.asarray(routes), keys)
    tstate = state_from_arrays(jstate, device="cpu")
    np.testing.assert_allclose(_target_point(tstate).numpy(),
                               np.asarray(jax.vmap(jax_target_point)(jstate)), atol=1e-4)
    cmds = []
    for idx in range(0, 250, 10):
        ridx = np.array([idx, idx])
        ref = jax.vmap(lambda r, i: jax_route_command(jtown, r, i))(jnp.asarray(routes),
                                                                   jnp.asarray(ridx))
        port = route_command(ttown, torch.as_tensor(routes), torch.as_tensor(ridx))
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
        cmds += port.tolist()
    assert len(set(cmds)) >= 2
