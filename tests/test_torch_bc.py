"""PyTorch port parity: the behavior-cloning trainer of thinktwice_tpu_torch
against thinktwice_tpu's `make_bc` on the CPU.

- `control_to_acc` inverts `acc_to_control` and equals the reference's.
- The discounted returns (gamma squared a frame) equal a numpy recursion.
- One `iterate_fn` with perturb_prob 0.5, dagger_mix 0.5 and a scenario
  bank, the port fed the JAX key chain (`JaxTrainChain`): the same
  trajectory (birdviews as uint8, dones and labels exactly where the
  teacher's inputs agree, rewards and state vectors within 1e-5 absolute or
  1e-4 relative), the same metrics within that, the same worlds afterwards,
  and the first minibatch's gradient within 1e-3 of its norm of the
  reference's `loss_fn` on the same batch and jitter key.
- `eval_fn`, the held-out probe, gives the reference's metrics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_evaluator import straight_route
from test_torch_ppo import (
    SIM,
    JaxTrainChain,
    assert_close,
    assert_grads_close,
    closure,
    port_policy,
    scenario_banks,
)
from test_torch_sim import assert_tree_matches, configs, towns
from thinktwice_tpu.agents.roach import acc_to_control as j_acc_to_control
from thinktwice_tpu.train import bc as j_bc
from thinktwice_tpu_torch.agents.roach import acc_to_control
from thinktwice_tpu_torch.train import bc

torch.set_num_threads(1)


def test_control_to_acc_inverts_acc_to_control():
    ctrl = np.asarray([[0.3, 0.7, 0.0], [-0.2, 0.0, 1.0], [0.9, 0.0, 0.4]], np.float32)
    acc = bc.control_to_acc(torch.tensor(ctrl))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_bc.control_to_acc(ctrl)))
    np.testing.assert_allclose(acc_to_control(acc)[:2].numpy(), ctrl[:2], atol=1e-6)
    np.testing.assert_array_equal(acc_to_control(acc).numpy(),
                                  np.asarray(j_acc_to_control(jnp.asarray(acc.numpy()))))


def _bank_routes():
    """Five grid routes of 100 m; with eval_envs 2 the last two are the
    probe's."""
    return np.stack([straight_route(10.0, -1.75, 100.0, 256),
                     straight_route(70.0, 98.25, 100.0, 256),
                     straight_route(20.0, 198.25, 100.0, 256),
                     straight_route(110.0, -1.75, 80.0, 256),
                     straight_route(5.0, 98.25, 90.0, 256)])


def _make(perturb=0.5):
    jcfg, tcfg = configs(**SIM)
    jtown, ttown = towns()
    routes = _bank_routes()
    jbank, tbank = scenario_banks(jcfg, tcfg, jtown, ttown, routes)
    kw = dict(n_envs=2, n_steps=8, minibatch=8, n_epochs=1, n_vehicles=4, perturb_prob=perturb,
              eval_envs=2, eval_steps=8)
    j = j_bc.make_bc(jcfg, j_bc.BCConfig(**kw), jtown, jnp.asarray(routes), scenarios=jbank)
    t = bc.make_bc(tcfg, bc.BCConfig(**kw), ttown, routes, scenarios=tbank)
    return j, t, tcfg, jtown.spawn.shape[0]


def test_discounted_returns_match_numpy():
    (_, it_j), (_, it_t), _, _ = _make()
    rng = np.random.default_rng(4)
    traj = {"reward": rng.normal(size=(7, 3)).astype(np.float32),
            "done": rng.random((7, 3)) < 0.3}
    got = it_t.discounted_returns({k: torch.tensor(v) for k, v in traj.items()}).numpy()
    want = np.zeros((7, 3))
    ret = np.zeros(3)
    for t in reversed(range(7)):
        ret = traj["reward"][t] + bc.GAMMA ** 2 * ret * (1.0 - traj["done"][t])
        want[t] = ret
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bc_iterate_and_probe_match_jax():
    (init_j, it_j), (init_t, it_t), tcfg, n_spawn = _make()
    # jitted: one compile of the reference's resets, not one a primitive
    params_j, opt_j, env_j = jax.jit(init_j)(jax.random.key(0))
    chain = JaxTrainChain("bc", 2, n_spawn)
    chain.start(jax.random.key(0))
    _, opt_t, env_t = init_t(chain)
    assert_tree_matches(env_t, env_j)
    # world 0's route done: it resets at the first macro step
    env_j = dataclasses.replace(env_j, criteria=dataclasses.replace(
        env_j.criteria, done=jnp.asarray([True, False])))
    env_t = dataclasses.replace(env_t, criteria=dataclasses.replace(
        env_t.criteria, done=torch.tensor([True, False])))
    policy = port_policy(tcfg, params_j)

    seen = {"minibatch": []}

    def probe(stage, value):
        if stage == "rollout":
            seen["rollout"] = value
        else:
            seen["minibatch"].append(value)

    key, mix = jax.random.key(1), 0.5
    chain.iteration(key, 1)
    policy, opt_t, env_t, m_t = it_t(policy, opt_t, env_t, chain, dagger_mix=mix, probe=probe)

    r1, r2 = jax.random.split(key)
    _, traj_j = it_j.rollout_fn(params_j, env_j, r1, jnp.float32(mix))
    _, _, env_j2, m_j = it_j(params_j, opt_j, env_j, key, dagger_mix=mix)

    traj = seen["rollout"]
    for k in ("bv_u8", "done"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(traj_j[k]), err_msg=k)
    assert traj["done"][0, 0] and int(traj["bv_u8"].max()) == 255
    for k in ("sv", "action", "reward"):
        assert_close(traj[k].numpy(), traj_j[k], k)
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert_close(float(m_t[k]), float(m_j[k]), k)
    assert_tree_matches(env_t, env_j2)

    # the first minibatch's gradient against the reference's loss_fn, with
    # the reference's jitter key of that minibatch
    batch, grads = seen["minibatch"][0]
    _, e2 = jax.random.split(jax.random.split(r2, 1)[0])
    loss_j = closure(it_j.update_fn, "loss_fn")
    g_j, _ = jax.grad(loss_j, has_aux=True)(
        params_j, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        jax.random.fold_in(e2, 0))
    assert_grads_close(grads, g_j["params"])

    # the probe on the held-out routes, from the same (initial) weights
    probe_key = jax.random.key(2)
    ev_j = it_j.eval_fn(params_j, probe_key)
    eval_chain = JaxTrainChain("bc", 2, n_spawn)
    eval_chain.probe(probe_key, 2)
    ev_t = it_t.eval_fn(port_policy(tcfg, params_j), eval_chain)
    assert set(ev_t) == set(ev_j)
    for k in ev_j:
        assert_close(float(ev_t[k]), float(ev_j[k]), k)
    assert 0.0 <= float(ev_t["cl_completion"]) <= 1.0
