"""PyTorch port parity: the Roach expert (weights, policy, rule brakes,
expert_control) of thinktwice_tpu_torch against thinktwice_tpu on the CPU.

The port's msgpack decoder must give flax's tree bit for bit; the policy
with the roach_rl6 weights must give alpha, beta and value within 1e-4 on
the same raster (float32 convolutions summed in another order); the rule
brakes must agree exactly, and expert_control's controls within 1e-4 and
only_ap_brake exactly on states where both packages' rasters agree.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_birdview import jax_inputs, world
from test_torch_sim import configs, jax_reset_batch, towns, two_routes
from thinktwice_tpu.agents import autopilot as jax_autopilot
from thinktwice_tpu.agents import expert as jax_expert
from thinktwice_tpu.agents.roach import RoachPolicy as JaxRoachPolicy
from thinktwice_tpu.agents.roach import acc_to_control as jax_acc_to_control
from thinktwice_tpu.agents.roach import beta_mode as jax_beta_mode
from thinktwice_tpu.sensors.birdview import render_birdview
from thinktwice_tpu.sim.step import step_world as jax_step_world
from thinktwice_tpu_torch.agents import autopilot, expert
from thinktwice_tpu_torch.agents.roach import (
    RoachPolicy,
    acc_to_control,
    beta_mode,
    beta_sample,
)
from thinktwice_tpu_torch.sensors.birdview import birdview_from_state
from thinktwice_tpu_torch.sim.state import state_from_arrays
from thinktwice_tpu_torch.weights import (
    load_flax_msgpack,
    load_roach_policy,
    roach_state_dict_from_flax,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RL6 = os.path.join(REPO, "runs", "roach_rl6", "params.msgpack")
POLICY_TOL = 1e-4


def _assert_same_tree(a, b, path=""):
    assert isinstance(a, dict) and set(a) == set(b), path
    for k in a:
        if isinstance(b[k], dict):
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{path}/{k}"
            assert np.array_equal(a[k], b[k]), f"{path}/{k}"


@pytest.mark.parametrize("run", ["roach_bc5", "roach_rl5", "roach_rl6"])
def test_msgpack_decoder_matches_flax(run):
    path = os.path.join(REPO, "runs", run, "params.msgpack")
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    _assert_same_tree(load_flax_msgpack(path), ref)


def test_msgpack_decoder_scalars_and_containers():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": np.float32(1.5),
            "c": {"d": np.zeros((0,), np.float64), "e": np.array(True)},
            "f": 7, "g": -3, "h": 2.5, "i": "name", "j": None, "k": [1, 2]}
    from thinktwice_tpu_torch.weights import unpackb

    out = unpackb(serialization.msgpack_serialize(tree))
    assert out["a"].dtype == np.int32 and np.array_equal(out["a"], tree["a"])
    assert out["b"] == np.float32(1.5) and isinstance(out["b"], np.float32)
    assert out["c"]["d"].shape == (0,) and bool(out["c"]["e"])
    assert (out["f"], out["g"], out["h"], out["i"], out["j"], out["k"]) == (
        7, -3, 2.5, "name", None, [1, 2])


@pytest.fixture(scope="module")
def policies():
    jcfg, tcfg = configs()
    with open(RL6, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    return jcfg, tcfg, params, load_roach_policy(RL6, tcfg, device="cpu")


def test_state_dict_covers_every_parameter(policies):
    _, tcfg, params, _ = policies
    sd = roach_state_dict_from_flax(params)
    assert set(sd) == set(RoachPolicy.from_config(tcfg).state_dict())


def test_policy_matches_flax_on_same_raster(policies):
    jcfg, _, params, policy = policies
    rng = np.random.default_rng(0)
    # a raster of the 15-channel value set and a state vector
    bv = rng.choice([0.0, 80 / 255, 120 / 255, 1.0], size=(2, 15, 192, 192)).astype(np.float32)
    sv = np.array([[0.5, 0.1, 0.0, 1.0, 4.0, 0.0], [0.0, -0.2, 1.0, 1.0, 0.5, 0.0]], np.float32)
    ref = JaxRoachPolicy().apply(params, jnp.asarray(bv), jnp.asarray(sv))
    with torch.no_grad():
        out = policy(torch.from_numpy(bv), torch.from_numpy(sv))
    for key in ("alpha", "beta", "value", "features"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=POLICY_TOL, atol=POLICY_TOL, err_msg=key)
    for a, b in zip(out["cnn_features"], ref["cnn_features"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=POLICY_TOL, atol=POLICY_TOL)


def test_beta_mode_and_controls_match():
    rng = np.random.default_rng(1)
    alpha = rng.uniform(0.2, 4.0, (64, 2)).astype(np.float32)
    beta = rng.uniform(0.2, 4.0, (64, 2)).astype(np.float32)
    alpha[:4] = 1.0
    ref = np.asarray(jax_beta_mode(jnp.asarray(alpha), jnp.asarray(beta)))
    out = beta_mode(torch.from_numpy(alpha), torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        acc_to_control(torch.from_numpy(out)).numpy(),
        np.asarray(jax_acc_to_control(jnp.asarray(ref))), rtol=0, atol=1e-6)


def test_beta_sample_has_the_beta_mean():
    """torch's Gamma draws are not threefry's: compare the sample mean with
    the Beta mean mapped to [-1, 1], 2 a / (a + b) - 1, within 5 standard
    errors of 10k draws (a draw in [-1, 1] has a standard deviation <= 1)."""
    alpha = torch.tensor([[0.7, 2.0], [3.0, 1.5]]).repeat(10000, 1)
    beta = torch.tensor([[1.2, 2.0], [0.8, 4.0]]).repeat(10000, 1)
    x = beta_sample(alpha, beta, generator=torch.Generator().manual_seed(0))
    assert x.shape == alpha.shape and bool(((x >= -1) & (x <= 1)).all())
    mean = (2 * alpha / (alpha + beta) - 1)[:2]
    got = x.reshape(10000, 2, 2).mean(0)
    assert bool(((got - mean).abs() < 5 / 10000 ** 0.5).all()), (got, mean)


@pytest.fixture(scope="module")
def drive_states():
    """Two worlds near the junction and the stop sign, the egos at 6 m/s,
    after 0, 10 and 20 ticks of traffic, and a crafted state."""
    import dataclasses

    jcfg, tcfg = configs()
    jtown, ttown = towns()
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=2, n_vehicles=12)
    jstate = dataclasses.replace(
        jstate, ego=dataclasses.replace(jstate.ego, speed=jnp.full((2,), 6.0)))
    step = jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))
    states = []
    for t in range(21):
        if t % 10 == 0:
            states.append(jstate)
        jstate, _ = step(jstate, jnp.asarray([[0.0, 0.3, 0.0]] * 2))
    states.append(_crafted(states[0]))
    return jcfg, tcfg, jtown, ttown, states


def _crafted(jstate):
    """The lights of the east-west approaches red (t = 20 s), a stopped car
    8 m ahead of each ego and one crossing northbound 12 m ahead: every
    rule brake has something to brake for."""
    import dataclasses

    ego = jstate.ego.pos
    tr = jstate.traffic
    pos = tr.pos.at[:, 0].set(ego + jnp.asarray([8.0, 0.0]))
    pos = pos.at[:, 1].set(ego + jnp.asarray([12.0, -6.0]))
    tr = dataclasses.replace(
        tr, pos=pos,
        yaw=tr.yaw.at[:, 0].set(0.0).at[:, 1].set(jnp.pi / 2),
        speed=tr.speed.at[:, 0].set(0.0).at[:, 1].set(5.0),
        active=tr.active.at[:, :2].set(True),
    )
    return dataclasses.replace(jstate, traffic=tr, tick=jnp.full((2,), 400, jnp.int32))


def test_rule_brakes_match(drive_states):
    jcfg, tcfg, jtown, ttown, states = drive_states
    caps = jax.jit(jax.vmap(lambda s: jax_autopilot.red_sign_caps(jcfg, jtown, s)))
    yld = jax.jit(jax.vmap(lambda s: jax_autopilot.junction_yield(jcfg, jtown, s)))
    haz = jax.jit(jax.vmap(lambda s: jax_expert.hazard_brake(jcfg, s, stopped_cone=True)))
    vec = jax.jit(jax.vmap(jax_expert.state_vector))
    for jstate in states:
        tstate = state_from_arrays(jstate, device="cpu")
        for got, ref in ((autopilot.red_sign_caps(tcfg, ttown, tstate), caps(jstate)),
                         (autopilot.junction_yield(tcfg, ttown, tstate), yld(jstate))):
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(
            expert.hazard_brake(tcfg, tstate, stopped_cone=True).numpy(),
            np.asarray(haz(jstate)))
        np.testing.assert_array_equal(expert.state_vector(tstate).numpy(),
                                      np.asarray(vec(jstate)))


def test_expert_control_matches(drive_states, policies):
    jcfg, tcfg, jtown, ttown, states = drive_states
    _, _, params, policy = policies
    jax_ctrl = jax.jit(jax.vmap(
        lambda s: jax_expert.expert_control(jcfg, params, jtown, s)))
    render = jax.jit(render_birdview, static_argnums=0)
    compared = 0
    for jstate in states:
        tstate = state_from_arrays(jstate, device="cpu")
        ctrl, sup = expert.expert_control(tcfg, policy, ttown, tstate)
        ref_ctrl, ref_sup = jax_ctrl(jstate)
        obs = birdview_from_state(tcfg.birdview, ttown, tstate).numpy()
        for b in range(obs.shape[0]):
            args, kw = jax_inputs(jcfg.birdview, jtown, world(jstate, b))
            if not np.array_equal(obs[b], np.asarray(render(jcfg.birdview, jtown, *args, **kw))):
                continue            # a raster edge pixel differs: not comparable
            compared += 1
            np.testing.assert_allclose(ctrl[b].numpy(), np.asarray(ref_ctrl[b]),
                                       rtol=0, atol=POLICY_TOL)
            assert bool(sup["only_ap_brake"][b]) == bool(ref_sup["only_ap_brake"][b])
            np.testing.assert_allclose(sup["value"][b].numpy(), np.asarray(ref_sup["value"][b]),
                                       rtol=POLICY_TOL, atol=POLICY_TOL)
    assert compared >= 4, compared
