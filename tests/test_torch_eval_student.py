"""PyTorch port parity: the route evaluator with the ThinkTwice student of
thinktwice_tpu_torch (the stateful adapter `make_student_policy`) against
thinktwice_tpu's evaluator with its driver on the CPU.

The JAX suite's TINY config (tests/test_pipeline.py) with a one-sweep
ResNet-10 student whose flax init is converted by the port's converter; two
routes in one batch of 2 worlds, 4 vehicles, the policy every 2 ticks,
8-tick segments, 16 ticks; the driver's PID state is the carry. (The
two-sweep driver's history ring is held against the JAX driver in
tests/test_torch_student.py; here, that the adapter sizes it 10 // k
calls for a policy every k ticks.) Both packages draw the world's and the sensors' random numbers
from the reference's key chain (JaxChainDraws). The model runs in bfloat16
in both, rounded in another order (tests/test_torch_student.py), so the
records must be equal in status and infraction counts and within 1e-2 in
the scores, route_length and duration_game.

Without a draws provider the evaluator's seeded generator also draws the
sensors' numbers: two evaluations with the same seed, under rain and with
the global torch RNG moved between them, give equal controls (exactly) and
equal documents but for the wall time.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_evaluator import JaxChainDraws, assert_documents_match
from test_torch_sim import two_routes
from test_torch_student import CAM, LIDAR, MODEL, SIM
from thinktwice_tpu.agents.thinktwice_driver import driver_init as jax_driver_init
from thinktwice_tpu.agents.thinktwice_driver import make_thinktwice_driver as jax_make_driver
from thinktwice_tpu.config import CameraConfig as JCam
from thinktwice_tpu.config import Config as JConfig
from thinktwice_tpu.config import LidarConfig as JLidar
from thinktwice_tpu.config import ModelConfig as JModel
from thinktwice_tpu.config import SimConfig as JSim
from thinktwice_tpu.harness import evaluator as j_eval
from thinktwice_tpu.maps.procedural import make_grid_town as jax_grid_town
from thinktwice_tpu.models import rig as jrig
from thinktwice_tpu.train.loop import make_model
from thinktwice_tpu_torch.agents.thinktwice_driver import make_student_policy
from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, ModelConfig, SimConfig
from thinktwice_tpu_torch.harness import evaluator as t_eval
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel
from thinktwice_tpu_torch.sim.weather import PRESETS
from thinktwice_tpu_torch.weights import student_state_dict_from_flax

torch.set_num_threads(1)

POLICY_EVERY = 2


def test_evaluate_routes_student_matches_jax(tmp_path):
    jcfg = JConfig(sim=JSim(**SIM), camera=JCam(**CAM), lidar=JLidar(**LIDAR),
                   model=JModel(**MODEL))
    cfg = Config(sim=SimConfig(**SIM), camera=CameraConfig(**CAM),
                 lidar=LidarConfig(**LIDAR), model=ModelConfig(**MODEL))
    jtown = jax_grid_town(n_blocks=2, block=100.0)
    ttown = make_grid_town(n_blocks=2, block=100.0, device="cpu")

    jmodel = make_model(jcfg, backbone_depth=10, n_sweeps=1)
    n_rays = jcfg.lidar.n_beams * jcfg.lidar.n_azimuth
    m, N = jcfg.model, jcfg.camera.n_cams
    params = jax.jit(jmodel.init)(
        jax.random.key(1), jnp.zeros((1, 1, N, m.img_height, m.img_width, 3)),
        jnp.zeros((1, n_rays, 5)), jnp.ones((1, n_rays), bool), jnp.zeros((1,)),
        jnp.zeros((1, 2)), jnp.zeros((1, 6)), jnp.asarray(jrig.cam_to_ego(jcfg.camera)),
        jnp.asarray(jrig.intrinsics(jcfg.camera)), jnp.asarray(jrig.ego_to_img(jcfg.camera)))
    model = ThinkTwiceModel(cfg.model, backbone_depth=10, n_sweeps=1)
    model.load_state_dict(student_state_dict_from_flax(jax.tree.map(np.asarray, params),
                                                       model), strict=True)
    model.eval()

    routes, ids = list(two_routes()), ["junction", "stop sign"]
    kw = dict(n_vehicles=4, max_steps=16, worlds_per_batch=2, seed=2, segment_steps=8,
              policy_every=POLICY_EVERY)
    paths = {p: str(tmp_path / f"{p}.json") for p in "tj"}
    j_eval.evaluate_routes(
        jcfg, jtown, routes, ids, jax_make_driver(jcfg, jmodel, params),
        policy_init=lambda: jax_driver_init(jcfg, n_sweeps=1),
        out_path=paths["j"], **kw)

    policy_fn, policy_init = make_student_policy(cfg, model, policy_every=POLICY_EVERY)
    carries = []

    def init(n_worlds):
        carries.append(policy_init(n_worlds))
        return carries[-1]

    t_eval.evaluate_routes(cfg, ttown, routes, ids, policy_fn, policy_init=init,
                           out_path=paths["t"], draws=JaxChainDraws(2, sensor_cfg=jcfg),
                           **kw)
    t_doc, j_doc = (json.load(open(paths[p])) for p in "tj")
    assert_documents_match(t_doc, j_doc)
    assert len(carries) == 1 and carries[0].tick == 0
    driven = [r["scores"]["score_route"] for r in t_doc["_checkpoint"]["records"]]
    assert np.isfinite(driven).all()


def test_student_policy_ring_holds_half_a_second():
    cfg = Config(sim=SimConfig(**SIM), camera=CameraConfig(**CAM),
                 lidar=LidarConfig(**LIDAR), model=ModelConfig(**MODEL))
    model = ThinkTwiceModel(cfg.model, backbone_depth=10, n_sweeps=2)
    for k in (1, 2, 5):
        _, init = make_student_policy(cfg, model, policy_every=k)
        drv = init(3)
        assert drv.rgb_ring.shape[:2] == (3, 10 // k) and drv.tick == 0
        assert drv.agent.stuck_ticks.shape == (3,)


def _without_wall_time(doc):
    if isinstance(doc, dict):
        return {k: _without_wall_time(v) for k, v in doc.items() if k != "duration_system"}
    if isinstance(doc, list):
        return [_without_wall_time(v) for v in doc]
    return doc


def test_default_student_evaluation_is_seeded(tmp_path):
    cfg = Config(sim=SimConfig(**SIM), camera=CameraConfig(**CAM),
                 lidar=LidarConfig(**LIDAR), model=ModelConfig(**MODEL))
    torch.manual_seed(0)
    model = ThinkTwiceModel(cfg.model, backbone_depth=10, n_sweeps=1).eval()
    ttown = make_grid_town(n_blocks=2, block=100.0, device="cpu")
    policy_fn, policy_init = make_student_policy(cfg, model, policy_every=POLICY_EVERY)
    routes, ids = list(two_routes()), ["junction", "stop sign"]
    # rain, so that the cameras' noise and the lidar's drop reach the model
    rain = [PRESETS["HardRainNoon"]] * len(routes)

    def run(name):
        controls = []

        def recorded(cfg_, town, state, driver, draws):
            ctrl, driver = policy_fn(cfg_, town, state, driver, draws)
            controls.append(ctrl)
            return ctrl, driver

        recorded.sample_draws = policy_fn.sample_draws
        path = str(tmp_path / f"{name}.json")
        t_eval.evaluate_routes(cfg, ttown, routes, ids, recorded, policy_init=policy_init,
                               n_vehicles=4, max_steps=4, worlds_per_batch=2, seed=4,
                               segment_steps=4, policy_every=POLICY_EVERY, weathers=rain,
                               out_path=path)
        return torch.stack(controls), json.load(open(path))

    a_ctrl, a_doc = run("a")
    torch.randn(1000)
    torch.rand(7)
    b_ctrl, b_doc = run("b")
    assert a_ctrl.shape == (2, 2, 3)
    assert torch.equal(a_ctrl, b_ctrl)
    assert _without_wall_time(a_doc) == _without_wall_time(b_doc)
