"""PyTorch port parity: the JAX package's last public functions in
thinktwice_tpu_torch, each against its JAX counterpart on the CPU.

- `config.town05_long_config` and `config.longest6_config`: field for field.
- `sim.step.rollout`: two grid-town worlds driven by the autopilot for 12
  ticks, their traffic about to be recycled onto drawn spawn points, the
  draws computed with jax.random from each world's key chain;
  the events of every tick and every integer field of the final state
  exactly, its floats within tests/test_torch_sim.py's 1e-4.
- `sensors.birdview.render_birdview_rgb`: on the channel stacks of a grid
  world after 20 ticks and on a seeded stack that puts values on both sides
  of every threshold, with and without the ego box: exactly equal.
- `ops.voxel_pool.voxel_pool`: tests/test_ops.py's two cases exactly, a
  seeded random case with two leading batch axes within 1e-5, and the
  port's `lift_splat_pool` against it on the naive outer product as
  tests/test_ops.py holds the JAX pair (rtol 1e-4, atol 1e-5).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sim import (
    assert_tree_matches,
    configs,
    jax_reset_batch,
    jax_step_draws,
    towns,
    two_routes,
)
from thinktwice_tpu import config as jax_config
from thinktwice_tpu.agents.autopilot import autopilot_control as jax_autopilot
from thinktwice_tpu.ops.voxel_pool import voxel_pool as jax_voxel_pool
from thinktwice_tpu.sensors.birdview import render_birdview_rgb as jax_render_rgb
from thinktwice_tpu.sim.step import rollout as jax_rollout
from thinktwice_tpu_torch import config
from thinktwice_tpu_torch.agents.autopilot import autopilot_control
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.ops.voxel_pool import lift_splat_pool, voxel_pool
from thinktwice_tpu_torch.sensors.birdview import birdview_from_state, render_birdview_rgb
from thinktwice_tpu_torch.sim.reset import reset_world
from thinktwice_tpu_torch.sim.state import state_from_arrays
from thinktwice_tpu_torch.sim.step import rollout

torch.set_num_threads(1)

ROLLOUT_TICKS = 12
POOL_TOL = 1e-5      # a random voxel_pool: float sums added in another order


@pytest.mark.parametrize("name", ["town05_long_config", "longest6_config"])
def test_benchmark_presets_match(name):
    """The presets equal the JAX package's field for field; the port's own
    fields (the sparse LiDAR encoder's, which the JAX package lacks) sit at
    their defaults, the pillar encoder chosen."""
    port, ref = getattr(config, name)(), getattr(jax_config, name)()
    port_d, ref_d = dataclasses.asdict(port), dataclasses.asdict(ref)
    own = set(port_d["model"]) - set(ref_d["model"])
    assert own == set(config.SPARSE_LIDAR_FIELDS)
    assert port.model.lidar_encoder == "pillar"
    for k in own:
        assert port_d["model"].pop(k) == getattr(config.ModelConfig(), k), k
    assert port_d == ref_d
    assert type(port) is config.Config


def _key_chain_draws(jstate, n_spawn, n_ticks):
    """Each tick's StepDraws of the JAX rollout: step_world splits every
    world's key into (next key, scenario key, recycle key) while the world
    runs."""
    draws, keys = [], jstate.rng
    for _ in range(n_ticks):
        now = types.SimpleNamespace(rng=keys, traffic=jstate.traffic)
        draws.append(jax_step_draws(now, n_spawn))
        keys = jax.vmap(lambda k: jax.random.split(k, 3)[0])(keys)
    return draws


def test_rollout_with_the_autopilot_matches_jax():
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=5, n_vehicles=12)
    # the traffic has stood for almost the recycle time: the deadlock recycle
    # respawns vehicles on the drawn candidates during the rollout
    tr = jstate.traffic
    stood = jcfg.sim.npc_recycle_s - 0.4 * jcfg.sim.dt
    jstate = dataclasses.replace(
        jstate, ego=dataclasses.replace(jstate.ego, speed=jnp.full((2,), 6.0)),
        traffic=dataclasses.replace(tr, stop_s=jnp.where(tr.active, stood, tr.stop_s),
                                    speed=jnp.where(tr.active, 0.0, tr.speed)))
    draws = _key_chain_draws(jstate, jtown.spawn.shape[0], ROLLOUT_TICKS)
    jfinal, jev = jax.jit(jax.vmap(
        lambda s: jax_rollout(jcfg, jtown, s, jax_autopilot, ROLLOUT_TICKS)))(jstate)
    tfinal, tev = rollout(tcfg, ttown, state_from_arrays(jstate, device="cpu"),
                          autopilot_control, ROLLOUT_TICKS, draws=draws)
    assert not bool(np.asarray(jfinal.criteria.done).any())   # the key chain ran every tick
    assert tev.collision_vehicle.shape == (ROLLOUT_TICKS, 2)
    # the scan's events are (worlds, ticks) under vmap; the port's (ticks, worlds)
    assert_tree_matches(tev, jax.tree.map(lambda e: jnp.swapaxes(e, 0, 1), jev))
    assert_tree_matches(tfinal, jfinal)
    assert float(tfinal.criteria.dist_driven.min()) > 3.0        # both egos drove
    moved = torch.linalg.norm(tfinal.traffic.pos - torch.as_tensor(np.asarray(tr.pos)), dim=-1)
    assert int((moved > 10.0).sum()) > 0                        # a vehicle was recycled


def _grid_masks():
    """(2, 15, 192, 192) channel stacks of two grid worlds after 20 ticks of
    the port's autopilot (plain K1 on the CPU), and their ego extents."""
    _, tcfg = configs()
    town = make_grid_town(n_blocks=2, block=100.0, device="cpu")
    g = torch.Generator().manual_seed(3)
    state = reset_world(tcfg, town, torch.as_tensor(two_routes()), n_vehicles=12, generator=g)
    state, _ = rollout(tcfg, town, state, autopilot_control, 20, generator=g)
    return birdview_from_state(tcfg.birdview, town, state), state.ego.extent


def _threshold_masks(seed=0):
    """A seeded (15, 192, 192) stack of 0, each light level, values just
    either side of every threshold and uniform noise."""
    rng = np.random.default_rng(seed)
    levels = np.array([0.0, 0.1, 0.1001, 0.25, 0.2501, 80 / 255, 0.3999, 0.4, 0.6, 0.6001,
                       170 / 255, 0.7499, 0.75, 0.9, 0.9001, 1.0], np.float32)
    pick = rng.integers(0, len(levels), (15, 192, 192))
    noise = rng.uniform(0.0, 1.0, (15, 192, 192)).astype(np.float32)
    return np.where(rng.uniform(size=pick.shape) < 0.8, levels[pick], noise)


def test_render_birdview_rgb_matches_jax():
    bcfg = configs()[1].birdview
    masks, extent = _grid_masks()
    stacks = [masks[0].numpy(), masks[1].numpy(), _threshold_masks()]
    assert all(float((stacks[b][11:] > 0.9).sum()) > 0 for b in (0, 1))   # lights painted
    for m in stacks:
        for ext in (None, extent[0].numpy()):
            port = render_birdview_rgb(bcfg, torch.as_tensor(m), ext)
            ref = np.asarray(jax_render_rgb(bcfg, jnp.asarray(m), ext))
            assert port.dtype == torch.float32 and port.shape == (192, 192, 3)
            np.testing.assert_array_equal(port.numpy(), ref)
    # leading axes: a batch renders as its worlds one by one
    both = render_birdview_rgb(bcfg, masks, extent[0])
    for b in (0, 1):
        assert torch.equal(both[b], render_birdview_rgb(bcfg, masks[b], extent[0]))


def test_voxel_pool_cases_of_the_jax_suite():
    geom = np.array([[[0.5, 0.5, 0.0], [2.5, 0.5, 0.0], [99.0, 0.0, 0.0]]], np.float32)
    feats = np.array([[[1.0, 2.0], [3.0, 4.0], [100.0, 100.0]]], np.float32)
    bev = voxel_pool(torch.as_tensor(geom), torch.as_tensor(feats), x_min=0.0, y_min=0.0,
                     cell=1.0, nx=4, ny=4)
    ref = jax_voxel_pool(jnp.asarray(geom), jnp.asarray(feats), x_min=0.0, y_min=0.0,
                         cell=1.0, nx=4, ny=4)
    assert bev.shape == (1, 4, 4, 2)
    np.testing.assert_array_equal(bev.numpy(), np.asarray(ref))
    assert float(bev.sum()) == 10.0                   # the out-of-grid point dropped
    geom = np.array([[[0.1, 0.1, 0.0], [0.9, 0.9, 0.0]]], np.float32)
    bev = voxel_pool(torch.as_tensor(geom), torch.ones((1, 2, 3)), 0.0, 0.0, 1.0, 2, 2)
    ref = jax_voxel_pool(jnp.asarray(geom), jnp.ones((1, 2, 3)), 0.0, 0.0, 1.0, 2, 2)
    np.testing.assert_array_equal(bev.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(bev[0, 0, 0].numpy(), [2.0, 2.0, 2.0])


def test_voxel_pool_random_batch_matches_jax():
    rng = np.random.default_rng(7)
    geom = np.concatenate([rng.uniform(-3, 9, (2, 3, 400, 2)),
                           rng.uniform(-12, 12, (2, 3, 400, 1))], -1).astype(np.float32)
    feats = rng.standard_normal((2, 3, 400, 5)).astype(np.float32)
    kw = dict(x_min=-1.0, y_min=0.5, cell=0.75, nx=9, ny=7, z_min=-8.0, z_max=8.0)
    bev = voxel_pool(torch.as_tensor(geom), torch.as_tensor(feats), **kw)
    ref = np.asarray(jax_voxel_pool(jnp.asarray(geom), jnp.asarray(feats), **kw))
    assert bev.shape == (2, 3, 7, 9, 5)
    np.testing.assert_allclose(bev.numpy(), ref, rtol=0, atol=POOL_TOL)
    # some points fall outside the grid and some outside the z range
    assert 0 < float(np.abs(ref).sum()) < float(np.abs(feats).sum())


def test_lift_splat_pool_matches_voxel_pool_of_the_outer_product():
    rng = np.random.RandomState(0)
    N, D, HW, C = 2, 5, 12, 7
    geom = torch.as_tensor(rng.uniform(-2, 6, (N, D, HW, 3)), dtype=torch.float32)
    dp = torch.softmax(torch.as_tensor(rng.randn(N, D, HW), dtype=torch.float32), dim=1)
    ctx = torch.as_tensor(rng.randn(N, HW, C), dtype=torch.float32)
    bev = lift_splat_pool(geom[None], dp[None], ctx[None], x_min=0.0, y_min=0.0, cell=1.0,
                          nx=4, ny=4)[0]
    prod = dp[..., None] * ctx[:, None]                 # (N, D, HW, C)
    naive = voxel_pool(geom.reshape(1, -1, 3), prod.reshape(1, -1, C), x_min=0.0, y_min=0.0,
                       cell=1.0, nx=4, ny=4)[0]
    np.testing.assert_allclose(bev.numpy(), naive.numpy(), rtol=1e-4, atol=1e-5)
