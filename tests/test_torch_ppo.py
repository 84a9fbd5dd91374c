"""PyTorch port parity: the PPO trainer of thinktwice_tpu_torch against
thinktwice_tpu's `make_ppo` on the CPU.

- The Beta helpers (log-density, entropy, KL, the sample and its
  log-density from the same Gamma variates) agree to float32 rounding of
  lgamma and digamma (XLA's and torch's differ by ulps): 1e-5 relative.
- `compute_reward` with its components, a collision and a red light, and
  `hazard_desired_speed` over a light's phase cycle, equal the reference's.
- GAE equals a numpy recursion and the reference's.
- One `iterate_fn` with policy_every=2, an anchor and a scenario bank of one
  row per route, the port fed the JAX key chain (`JaxTrainChain`): the same
  trajectory (birdviews as uint8 and dones exactly, rewards, components,
  actions, log-densities and values within 1e-5 absolute or 1e-4
  relative), the same metrics within that, the same worlds afterwards, and
  the first minibatch's gradient within 1e-3 of its norm of the
  reference's `loss_fn` on the same batch.
- A huge anchor coefficient keeps the policy nearer its anchor than none.
The optimizer is held against optax in tests/test_torch_optim.py.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_evaluator import _split_tick, straight_route
from test_torch_sim import assert_tree_matches, configs, towns
from thinktwice_tpu.harness import evaluator as j_eval
from thinktwice_tpu.maps.town import TL_SLOT_S
from thinktwice_tpu.sim.reset import reset_world as jax_reset_world
from thinktwice_tpu.sim.reset import zero_scenarios as jax_zero_scenarios
from thinktwice_tpu.sim.state import Events as JEvents
from thinktwice_tpu.train import ppo as j_ppo
from thinktwice_tpu_torch.agents.roach import beta_log_prob
from thinktwice_tpu_torch.harness import evaluator as t_eval
from thinktwice_tpu_torch.sim.state import Events, state_from_arrays, tree_map, zero_scenarios
from thinktwice_tpu_torch.sim.step import StepDraws
from thinktwice_tpu_torch.train import ppo
from thinktwice_tpu_torch.weights import flax_tree_from_roach_state_dict, roach_state_dict_from_flax

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4      # rewards, trajectory floats and metrics
GRAD_TOL, GRAD_COS = 1e-3, 0.99
SIM = dict(max_vehicles=8, max_walkers=4, max_scenarios=4)


def closure(fn, name):
    """The function `name` that fn (or the jitted fn) closes over."""
    fn = getattr(fn, "__wrapped__", fn)
    return inspect.getclosurevars(fn).nonlocals[name]


class JaxTrainChain:
    """Draws provider of the reference trainers' key chain. `start(rng)`
    takes init_fn's key (split into the policy's and the W reset keys),
    `iteration(rng, n_epochs)` iterate_fn's (r1 the rollout's chain, r2
    split into the epochs' keys), `probe(rng, E)` eval_fn's. A macro step
    splits the chain into 3 (PPO: the action's key, the resets') or 5 (BC:
    the noise, the resets', DAgger's, the perturbation's); a reset of world
    i splits its key into (route key, world key), the route index is
    randint(fold_in(route key, i)), and the world key into (state key,
    spawn key); every tick splits each world's state key, which a done
    world keeps."""

    def __init__(self, kind: str, n_worlds: int, n_spawn: int):
        self.kind, self.W, self.n_spawn = kind, n_worlds, n_spawn
        self.keys = None

    def start(self, rng):
        _, re = jax.random.split(rng)
        self.reset_keys = jax.random.split(re, self.W)

    def iteration(self, rng, n_epochs):
        self.chain, r2 = jax.random.split(rng)
        self.epoch_keys = list(jax.random.split(r2, n_epochs))

    def probe(self, rng, n):
        pair = jax.vmap(jax.random.split)(jax.random.split(rng, n))
        self.keys = pair[:, 0]
        self.probe_spawn = _uniforms(pair[:, 1], self.n_spawn)

    def init(self):
        pass

    def macro(self):
        if self.kind == "ppo":
            self.chain, self.rk, rr = jax.random.split(self.chain, 3)
        else:
            self.chain, self.rn, rr, self.rd, self.rp = jax.random.split(self.chain, 5)
        self.reset_keys = jax.random.split(rr, self.W)

    def reset(self, done, n_routes):
        idx, state_keys, spawn = _reset_draws(self.reset_keys, n_routes, self.n_spawn)
        if self.keys is None:
            self.keys = state_keys
        else:
            d = np.asarray(done.cpu().numpy())[:, None]
            self.keys = jax.random.wrap_key_data(np.where(
                d, jax.random.key_data(state_keys), jax.random.key_data(self.keys)))
        return torch.as_tensor(np.asarray(idx).astype(np.int64)), torch.tensor(np.asarray(spawn))

    def probe_reset(self, n):
        return torch.tensor(np.asarray(self.probe_spawn))

    def step(self, state):
        V = state.traffic.active.shape[1]
        nxt, normal, cand = _split_tick(self.keys, V, self.n_spawn)
        done = state.criteria.done.cpu().numpy()[:, None]
        self.keys = jax.random.wrap_key_data(np.where(
            done, jax.random.key_data(self.keys), jax.random.key_data(nxt)))
        return StepDraws(steer_normal=torch.tensor(np.asarray(normal)),
                         recycle_cand=torch.as_tensor(np.asarray(cand).astype(np.int64)))

    def gamma(self, alpha, beta):
        k1, k2 = jax.random.split(self.rk)
        g1 = jax.random.gamma(k1, jnp.asarray(alpha.numpy()))
        g2 = jax.random.gamma(k2, jnp.asarray(beta.numpy()))
        return torch.tensor(np.asarray(g1)), torch.tensor(np.asarray(g2))

    def epoch(self):
        erng = self.epoch_keys.pop(0)
        if self.kind == "ppo":
            self.perm_key = erng
        else:
            self.perm_key, self.jitter_key = jax.random.split(erng)

    def permutation(self, n, device):
        perm = jax.random.permutation(self.perm_key, n)
        return torch.as_tensor(np.asarray(perm).astype(np.int64))

    def perturb(self, n, prob, device):
        rp = self.rp
        do_p = jax.random.bernoulli(rp, prob, (n,))
        lat = jax.random.uniform(jax.random.fold_in(rp, 1), (n,), minval=-1.0, maxval=1.0)
        dyaw = jax.random.uniform(jax.random.fold_in(rp, 2), (n,), minval=-1.0, maxval=1.0)
        return tuple(torch.tensor(np.asarray(x)) for x in (do_p, lat, dyaw))

    def steer_noise(self, n, device):
        return torch.tensor(np.asarray(jax.random.normal(self.rn, (n,))))

    def dagger(self, n, mix, device):
        return torch.tensor(np.asarray(jax.random.bernoulli(self.rd, jnp.float32(mix), (n,))))

    def label_jitter(self, i, shape, device):
        return torch.tensor(np.asarray(
            jax.random.normal(jax.random.fold_in(self.jitter_key, i), tuple(shape))))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _reset_draws(keys, n_routes, n_spawn):
    """(route index, state key, spawn uniforms) of every world's reset key."""

    def one(i, k):
        rk, rr = jax.random.split(k)
        idx = jax.random.randint(jax.random.fold_in(rk, i), (), 0, n_routes)
        st, sp = jax.random.split(rr)
        return idx, st, jax.random.uniform(sp, (n_spawn,))

    return jax.vmap(one)(jnp.arange(keys.shape[0]), keys)


@functools.partial(jax.jit, static_argnums=1)
def _uniforms(keys, n):
    return jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)


def port_policy(cfg, params):
    policy = ppo.make_policy(cfg, "cpu")
    policy.load_state_dict(roach_state_dict_from_flax(params))
    return policy


def scenario_banks(jcfg, tcfg, jtown, ttown, routes):
    """One scenario row per route from the map's triggers, in both packages."""
    jrows, trows = [], []
    for r in routes:
        j = j_eval.build_route_scenarios(jcfg, r, j_eval.derive_map_triggers(jtown, r))
        t = t_eval.build_route_scenarios(tcfg, r, t_eval.derive_map_triggers(ttown, r),
                                         device="cpu")
        jrows.append(jax_zero_scenarios(jcfg) if j is None else j)
        trows.append(zero_scenarios(tcfg, 1, "cpu") if t is None else t)
    return (jax.tree.map(lambda *xs: jnp.stack(xs), *jrows),
            tree_map(lambda *xs: torch.cat(xs), *trows))


def assert_close(port, ref, name):
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(ref, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def flax_grads(grads: dict) -> dict:
    return flax_tree_from_roach_state_dict(grads)["params"]


def assert_grads_close(port: dict, ref, tol=GRAD_TOL, cos=GRAD_COS):
    """The port's gradients (by state_dict name) against the reference's
    flax tree: within tol of the whole gradient's norm, and every leaf at
    a cosine of at least cos."""
    a = jax.tree.leaves(flax_grads(port))
    b = [np.asarray(x, np.float64) for x in jax.tree.leaves(ref)]
    assert len(a) == len(b)
    diff = np.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
    norm = np.sqrt(sum((y ** 2).sum() for y in b))
    assert norm > 0 and diff <= tol * norm, (diff, norm)
    for x, y in zip(a, b):
        nx, ny = np.linalg.norm(x), np.linalg.norm(y)
        if nx == 0 or ny == 0:
            assert nx == ny
        else:
            assert float((x * y).sum()) / (nx * ny) >= cos


# --------------------------------------------------------------------------
# the Beta helpers


def _beta_inputs():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.3, 12.0, (64, 2)).astype(np.float32)
    b = rng.uniform(0.3, 12.0, (64, 2)).astype(np.float32)
    act = rng.uniform(-1.0, 1.0, (64, 2)).astype(np.float32)
    return a, b, act


def test_beta_helpers_match():
    a, b, act = _beta_inputs()
    ta, tb = torch.tensor(a), torch.tensor(b)
    from thinktwice_tpu.agents.roach import beta_log_prob as j_log_prob

    np.testing.assert_allclose(beta_log_prob(torch.tensor(act), ta, tb).numpy(),
                               np.asarray(j_log_prob(act, a, b)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ppo._beta_entropy(ta, tb).numpy(),
                               np.asarray(j_ppo._beta_entropy(a, b)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ppo._beta_kl(ta, tb, tb, ta).numpy(),
                               np.asarray(j_ppo._beta_kl(a, b, b, a)), rtol=1e-5, atol=1e-5)
    # Beta(1, 1) is uniform: entropy 0; KL of a distribution to itself is 0
    assert float(ppo._beta_entropy(torch.ones(1, 2), torch.ones(1, 2)).abs()) < 1e-5
    assert float(ppo._beta_kl(ta, tb, ta, tb).abs().max()) < 1e-5


def test_beta_sample_and_logp_with_jax_gammas():
    a, b, _ = _beta_inputs()
    key = jax.random.key(3)
    act_j, logp_j = j_ppo._beta_sample_and_logp(key, a, b)
    chain = JaxTrainChain("ppo", 64, 1)
    chain.rk = key
    act, logp = ppo._beta_sample_and_logp(chain, torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(act.numpy(), np.asarray(act_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j), rtol=1e-5, atol=1e-5)
    assert float(act.abs().max()) < 1.0


# --------------------------------------------------------------------------
# the reward


def _reset_pair(jcfg, jtown, routes, n_vehicles=2):
    keys = jax.random.split(jax.random.key(0), len(routes))
    js = jax.vmap(lambda r, k: jax_reset_world(jcfg, jtown, r, k, n_vehicles=n_vehicles))(
        jnp.asarray(routes), keys)
    return js, state_from_arrays(js, device="cpu")


def test_compute_reward_matches():
    """Two worlds 20 ticks apart (progress, speed, lane and heading terms;
    one world just blocked and timed out), world 1 with a collision and a
    red light; the desired speed 6 and 0."""
    jcfg, tcfg = configs(**SIM)
    jtown, _ = towns()
    routes = np.stack([straight_route(10.0, -1.75, 150.0, 256),
                       straight_route(20.0, 98.25, 150.0, 256)])
    js, ts = _reset_pair(jcfg, jtown, routes)
    rng = np.random.default_rng(1)
    new = {"ego": {"pos": np.asarray(js.ego.pos) + rng.normal(0, 0.6, (2, 2)),
                   "yaw": np.asarray(js.ego.yaw) + np.array([0.3, -2.0]),
                   "speed": np.array([4.0, 7.5])},
           "criteria": {"route_completion": np.array([0.05, 0.12]),
                        "route_idx": np.array([12, 30]),
                        "dist_offlane": np.array([0.0, 1.3]),
                        "blocked": np.array([False, True]),
                        "timeout": np.array([False, True])}}

    def put(state, new):
        for part, fields in new.items():
            sub = getattr(state, part)
            vals = {}
            for k, v in fields.items():
                old = getattr(sub, k)
                vals[k] = (jnp.asarray(v, old.dtype) if isinstance(old, jax.Array)
                           else torch.tensor(np.asarray(v), dtype=old.dtype))
            state = dataclasses.replace(state, **{part: dataclasses.replace(sub, **vals)})
        return state

    jn, tn = put(js, new), put(ts, new)
    hit = dict(collision_vehicle=[False, True], collision_walker=[False, False],
               collision_static=[False, True], red_light=[False, True],
               stop_sign=[False, False], route_complete=[False, False])
    jev = JEvents(**{k: jnp.asarray(v) for k, v in hit.items()})
    tev = Events(**{k: torch.tensor(v) for k, v in hit.items()})
    for desired in (6.0, 0.0):
        for scale in (1.0, 2.5):
            rj, cj = jax.vmap(lambda p, n, e: j_ppo.compute_reward(
                p, n, e, desired, red_light_scale=scale))(js, jn, jev)
            rt, ct = ppo.compute_reward(ts, tn, tev, torch.full((2,), desired),
                                        red_light_scale=scale)
            assert set(ct) == set(cj)
            for k in cj:
                assert_close(ct[k].numpy(), cj[k], k)
            assert_close(rt.numpy(), rj, "reward")
            assert abs(float(ct["p_collision"][1]) + 2 * ppo.P_COLLISION) < 1e-6
            assert abs(float(ct["p_red_light"][1]) + scale * ppo.P_RED_LIGHT) < 1e-6
            assert float(rt[1]) < float(rt[0]) - ppo.P_COLLISION


def test_hazard_desired_speed_over_a_phase_cycle():
    """The ego 8 m before a lit stop line on its approach: desired 0 while
    the light is red or yellow, DESIRED_SPEED while green; past the line,
    DESIRED_SPEED whatever the phase (tests/test_ppo.py's cases, batched)."""
    jcfg, tcfg = configs(**SIM)
    jtown, ttown = towns()
    routes = np.stack([straight_route(10.0, -1.75, 150.0, 256)] * 2)
    js, ts = _reset_pair(jcfg, jtown, routes, n_vehicles=0)
    k = int(np.nonzero(np.asarray(jtown.tl_valid))[0][0])
    yaw = float(np.asarray(jtown.tl_yaw)[k])
    fwd = np.asarray([np.cos(yaw), np.sin(yaw)])
    tl = np.asarray(jtown.tl_pos)[k]
    pos = np.stack([tl - 8.0 * fwd, tl + 3.0 * fwd]).astype(np.float32)
    seen = set()
    reference = jax.jit(jax.vmap(lambda s: j_ppo.hazard_desired_speed(jcfg, jtown, s)))
    for t in np.linspace(0.0, float(2 * TL_SLOT_S), 16):
        tick = np.full((2,), round(t / 0.05))
        jst = dataclasses.replace(
            js, tick=jnp.asarray(tick, jnp.int32),
            ego=dataclasses.replace(js.ego, pos=jnp.asarray(pos), yaw=jnp.full((2,), yaw)))
        tst = dataclasses.replace(
            ts, tick=torch.tensor(tick, dtype=torch.int64),
            ego=dataclasses.replace(ts.ego, pos=torch.tensor(pos), yaw=torch.full((2,), yaw)))
        want = np.asarray(reference(jst))
        got = ppo.hazard_desired_speed(tcfg, ttown, tst).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[1] == ppo.DESIRED_SPEED
        seen.add(float(got[0]))
    assert seen == {0.0, ppo.DESIRED_SPEED}


# --------------------------------------------------------------------------
# GAE


def test_gae_matches_numpy_and_the_reference():
    rng = np.random.default_rng(2)
    T, W = 9, 3
    traj = {"reward": rng.normal(size=(T, W)).astype(np.float32),
            "value": rng.normal(size=(T, W)).astype(np.float32),
            "done": rng.random((T, W)) < 0.2}
    last = rng.normal(size=(W,)).astype(np.float32)
    jcfg, tcfg = configs(**SIM)
    jtown, ttown = towns()
    routes = np.stack([straight_route(10.0, -1.75, 150.0, 256)])
    pcfg = dict(n_envs=1, n_steps=2, policy_every=2)
    _, it_t = ppo.make_ppo(tcfg, ppo.PPOConfig(**pcfg), ttown, routes)
    _, it_j = j_ppo.make_ppo(jcfg, j_ppo.PPOConfig(**pcfg), jtown, jnp.asarray(routes))
    adv, ret = it_t.gae({k: torch.tensor(v) for k, v in traj.items()}, torch.tensor(last))
    adv_j, ret_j = closure(it_j, "gae")({k: jnp.asarray(v) for k, v in traj.items()},
                                        jnp.asarray(last))
    g = ppo.GAMMA ** 2
    want = np.zeros((T, W))
    nxt_a, nxt_v = np.zeros(W), last.astype(np.float64)
    for t in reversed(range(T)):
        nonterm = 1.0 - traj["done"][t]
        delta = traj["reward"][t] + g * nxt_v * nonterm - traj["value"][t]
        nxt_a = delta + g * ppo.GAE_LAMBDA * nonterm * nxt_a
        want[t], nxt_v = nxt_a, traj["value"][t]
    np.testing.assert_allclose(adv.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), want + traj["value"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# one iterate against the reference


def test_ppo_iterate_matches_jax():
    W = 2
    jcfg, tcfg = configs(**SIM)
    jtown, ttown = towns()
    n_spawn = jtown.spawn.shape[0]
    # 100 m of 256 points: the reference's XLA birdview keeps at most 48
    # route segments per 48 px tile, which a denser route overflows
    routes = np.stack([straight_route(10.0, -1.75, 100.0, 256),
                       straight_route(70.0, 98.25, 100.0, 256),
                       straight_route(20.0, 198.25, 100.0, 256)])
    jbank, tbank = scenario_banks(jcfg, tcfg, jtown, ttown, routes)
    assert int((tbank.kind > 0).sum()) > 0
    kw = dict(n_envs=W, n_steps=8, n_epochs=1, minibatch=8, n_vehicles=4, policy_every=2,
              anchor_coef=0.05)
    pcfg_j, pcfg_t = j_ppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    # the reference's inits jitted: one compile each, not one a primitive
    anchor_j, _, _ = jax.jit(j_ppo.make_ppo(jcfg, pcfg_j, jtown, jnp.asarray(routes))[0])(
        jax.random.key(5))
    init_j, it_j = j_ppo.make_ppo(jcfg, pcfg_j, jtown, jnp.asarray(routes), scenarios=jbank,
                                  anchor_params=anchor_j)
    params_j, opt_j, env_j = jax.jit(init_j)(jax.random.key(0))

    init_t, it_t = ppo.make_ppo(tcfg, pcfg_t, ttown, routes, scenarios=tbank,
                                anchor=port_policy(tcfg, anchor_j))
    chain = JaxTrainChain("ppo", W, n_spawn)
    chain.start(jax.random.key(0))
    _, opt_t, env_t = init_t(chain)
    assert_tree_matches(env_t, env_j)
    # world 0's route done, world 1 standing for 31 s: both end at the first
    # macro step (the done and the stuck terminal) and reset onto drawn routes
    crit = dict(done=[True, False], blocked_s=[0.0, 31.0])
    env_j = dataclasses.replace(env_j, criteria=dataclasses.replace(
        env_j.criteria, **{k: jnp.asarray(v) for k, v in crit.items()}))
    env_t = dataclasses.replace(env_t, criteria=dataclasses.replace(
        env_t.criteria, **{k: torch.tensor(v) for k, v in crit.items()}))
    policy = port_policy(tcfg, params_j)

    seen = {"minibatch": []}

    def probe(stage, value):
        if stage == "rollout":
            seen["rollout"] = value
        else:
            seen["minibatch"].append(value)

    key = jax.random.key(1)
    chain.iteration(key, pcfg_t.n_epochs)
    policy, opt_t, env_t, m_t = it_t(policy, opt_t, env_t, chain, probe=probe)

    # the reference's rollout on the same key, then its whole iterate
    r1, _ = jax.random.split(key)
    _, traj_j, _ = closure(it_j, "rollout_fn")(params_j, env_j, r1)
    _, _, env_j2, m_j = it_j(params_j, opt_j, env_j, key)

    traj = seen["rollout"]
    for k in ("bv_u8", "done"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(traj_j[k]), err_msg=k)
    assert int(traj["bv_u8"].max()) == 255
    assert traj["done"][0].all() and float(traj["rcomps"]["p_blocked"][0, 1]) < 0
    for k in ("sv", "action", "logp", "value", "reward", "anchor_alpha", "anchor_beta"):
        assert_close(traj[k].numpy(), traj_j[k], k)
    assert set(traj["rcomps"]) == set(traj_j["rcomps"])
    for k, v in traj["rcomps"].items():
        assert_close(v.numpy(), traj_j["rcomps"][k], k)
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert_close(float(m_t[k]), float(m_j[k]), k)
    assert_tree_matches(env_t, env_j2)
    assert int(pcfg_t.n_steps * W // pcfg_t.minibatch) == len(seen["minibatch"])

    # the first minibatch's gradient against the reference's loss_fn
    batch, grads = seen["minibatch"][0]
    loss_j = closure(closure(it_j, "update_fn"), "loss_fn")
    g_j, _ = jax.grad(loss_j, has_aux=True)(
        params_j, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert_grads_close(grads, g_j["params"])


def test_anchor_pins_the_policy():
    """policy_every 2 from the anchor's own weights: two iterates with a
    huge anchor coefficient move the parameters less than two without the
    anchor term (tests/test_ppo.py's forgetting guard, on the port)."""
    from thinktwice_tpu_torch.train.draws import GeneratorTrainDraws

    _, tcfg = configs(**SIM)
    _, ttown = towns()
    routes = np.stack([straight_route(10.0, -1.75, 100.0, 256)] * 2)
    anchor = ppo.make_policy(tcfg, "cpu", torch.Generator().manual_seed(5))

    def drift(coef):
        pcfg = ppo.PPOConfig(n_envs=2, n_steps=8, n_epochs=1, minibatch=8, policy_every=2,
                             anchor_coef=coef)
        init_fn, it = ppo.make_ppo(tcfg, pcfg, ttown, routes, anchor=anchor)
        draws = GeneratorTrainDraws(ttown, 5)
        policy, opt, env = init_fn(draws)
        policy.load_state_dict(anchor.state_dict())
        for _ in range(2):
            policy, opt, env, m = it(policy, opt, env, draws)
        assert np.isfinite(float(m["pg_loss"])) and ("anchor_kl" in m) == (coef > 0)
        return sum(float((p - q).abs().sum()) for p, q in
                   zip(policy.state_dict().values(), anchor.state_dict().values()))

    assert drift(1000.0) < drift(0.0)
