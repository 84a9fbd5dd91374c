"""PyTorch port parity: the expert noiser and the baseline agents of
thinktwice_tpu_torch against thinktwice_tpu on the CPU.

- The noiser's perturbation, fed each episode's draws from the reference's
  fold_in chain (`JaxEpisodeDraws`), equals the reference's over seven
  episodes of three worlds, for the steer and the throttle, and so does
  `apply_noise`'s control, within 2e-5 (the episode's phase subtracts
  times of up to 175 s in float32, whose ulp is 1.5e-5 s, and the two
  compilers round that difference in other orders); the default `NoiserDraws` gives an episode the
  same numbers whenever it is asked.
- `npc_control` and `dummy_control` drive `evaluate_routes` to the
  reference's route records (the evaluator fed the reference's key chain,
  `JaxChainDraws`): status and infraction counts equal, scores, length
  and game time within 1e-2; the NPC agent completes an empty route.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_evaluator import JaxChainDraws, assert_records_match
from test_torch_sim import configs, towns
from thinktwice_tpu.agents import baseline as j_baseline
from thinktwice_tpu.agents import noiser as j_noiser
from thinktwice_tpu.harness import evaluator as j_eval
from thinktwice_tpu_torch.agents import baseline, noiser
from thinktwice_tpu_torch.harness import evaluator as t_eval

torch.set_num_threads(1)

NOISE_TOL = 2e-5


class JaxEpisodeDraws:
    """Each world's episode draws of the reference: the episode key
    fold_in(world key, episode), its start, sign and magnitude."""

    def __init__(self, keys):
        self.keys = keys

    def episode(self, ep_idx):
        start, sign, mag = _episode(self.keys, jnp.asarray(ep_idx.numpy().astype(np.int32)))
        return tuple(torch.tensor(np.asarray(x)) for x in (start, sign, mag))


@jax.jit
def _episode(keys, ep_idx):
    def one(k, e):
        ep_key = jax.random.fold_in(k, e)
        start = jax.random.uniform(ep_key, (), minval=0.0,
                                   maxval=j_noiser.EPISODE_EVERY_S - j_noiser.EPISODE_LEN_S)
        sign = jnp.where(jax.random.bernoulli(jax.random.fold_in(ep_key, 1)), 1.0, -1.0)
        mag = jax.random.uniform(jax.random.fold_in(ep_key, 2), (), minval=0.3, maxval=1.0)
        return start, sign, mag

    return jax.vmap(one)(keys, ep_idx)


def test_noiser_matches_jax_over_episodes():
    keys = jax.random.split(jax.random.key(11), 3)
    ticks = np.arange(0, 3500, 3)       # 175 s: seven episodes
    steer = JaxEpisodeDraws(keys)
    throttle = JaxEpisodeDraws(jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys))
    ctrl = np.asarray([[0.1, 0.5, 0.0], [-0.9, 0.9, 0.0], [0.95, 0.05, 0.3]], np.float32)
    apply_j = jax.jit(jax.vmap(
        lambda k, t, c: j_noiser.apply_noise(k, t, c, 0.05, steer=True, throttle=True),
        in_axes=(0, None, 0)))
    noise_j = jax.jit(jax.vmap(lambda k, t: j_noiser.noise_for_tick(k, t, 0.05, "steer"),
                               in_axes=(0, None)))
    nonzero = 0
    for t in ticks:
        tick = torch.full((3,), int(t), dtype=torch.int64)
        n_t = noiser.noise_for_tick(steer, tick, 0.05, "steer")
        n_j = np.asarray(noise_j(keys, jnp.int32(t)))
        np.testing.assert_allclose(n_t.numpy(), n_j, rtol=0, atol=NOISE_TOL, err_msg=str(t))
        c_t = noiser.apply_noise(steer, tick, torch.tensor(ctrl), throttle_draws=throttle)
        c_j = np.asarray(apply_j(keys, jnp.int32(t), jnp.asarray(ctrl)))
        np.testing.assert_allclose(c_t.numpy(), c_j, rtol=0, atol=NOISE_TOL, err_msg=str(t))
        nonzero += int((n_t != 0).sum())
        assert float(n_t.abs().max()) <= noiser.MAX_STEER_NOISE
    assert nonzero > 0


def test_default_noiser_draws_are_fixed_per_episode():
    a = noiser.NoiserDraws(4, seed=3)
    late = a.episode(torch.tensor([5, 0, 2, 9]))
    early = a.episode(torch.tensor([0, 0, 0, 0]))
    b = noiser.NoiserDraws(4, seed=3)
    zeros = torch.zeros(4, dtype=torch.int64)
    assert all(torch.equal(x, y) for x, y in zip(early, b.episode(zeros)))
    assert all(torch.equal(x, y) for x, y in zip(late, b.episode(torch.tensor([5, 0, 2, 9]))))
    start, sign, mag = late
    assert bool(((start >= 0) & (start < noiser.EPISODE_EVERY_S - noiser.EPISODE_LEN_S)).all())
    assert set(sign.tolist()) <= {-1.0, 1.0}
    assert bool(((mag >= 0.3) & (mag < 1.0)).all())
    ticks = torch.arange(0, 2000, dtype=torch.int64)[:, None].expand(-1, 4).reshape(-1)
    n = noiser.noise_for_tick(noiser.NoiserDraws(ticks.shape[0], seed=3), ticks, 0.05)
    assert float(n.abs().max()) > 0.0


def _route(x0, y, length, n=256):
    xs = np.linspace(x0, x0 + length, n)
    return np.stack([xs, np.full_like(xs, y), np.zeros_like(xs)], 1).astype(np.float32)


ROUTES = [_route(8.0, -1.75, 60.0), _route(20.0, 198.25, 60.0)]
IDS = ["r0", "r1"]


def _both(tmp_path, j_policy, t_policy, n_vehicles, max_steps, name):
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    kw = dict(n_vehicles=n_vehicles, max_steps=max_steps, worlds_per_batch=2, seed=4,
              segment_steps=max_steps // 4)
    paths = {p: str(tmp_path / f"{name}_{p}.json") for p in "tj"}
    j_eval.evaluate_routes(jcfg, jtown, ROUTES, IDS, j_policy, out_path=paths["j"], **kw)
    t_eval.evaluate_routes(tcfg, ttown, ROUTES, IDS, t_policy, out_path=paths["t"],
                           draws=JaxChainDraws(4), **kw)
    t_doc, j_doc = (json.load(open(paths[p])) for p in "tj")
    recs = t_doc["_checkpoint"]["records"]
    assert_records_match(recs, j_doc["_checkpoint"]["records"])
    return recs


def test_npc_agent_matches_jax_and_completes(tmp_path):
    recs = _both(tmp_path, j_baseline.npc_control, baseline.npc_control, 0, 1200, "npc")
    assert min(r["scores"]["score_route"] for r in recs) > 60.0


def test_npc_agent_in_traffic_matches_jax(tmp_path):
    _both(tmp_path, j_baseline.npc_control, baseline.npc_control, 6, 400, "npc_traffic")


def test_dummy_agent_matches_jax(tmp_path):
    recs = _both(tmp_path, j_baseline.dummy_control, baseline.dummy_control, 0, 300, "dummy")
    assert all(0.0 <= r["scores"]["score_composed"] <= 100.0 for r in recs)
