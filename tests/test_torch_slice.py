"""PyTorch port parity: the whole closed-loop Roach rollout (birdview through
K1's plain version, the roach_rl6 policy, the rule brakes, the world step)
against the JAX package's, 2 worlds for 10 ticks with the policy every 2.

The JAX side renders with its XLA birdview; a raster edge pixel may differ
(tests/test_torch_birdview.py), so the controls may differ by the policy's
float tolerance and the poses drift: within 1e-2 m after 10 ticks. The
criteria counters and events must be equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from test_torch_sim import (
    configs,
    jax_reset_batch,
    jax_step_draws,
    towns,
    two_routes,
)
from thinktwice_tpu.agents.expert import expert_control as jax_expert_control
from thinktwice_tpu.sim.step import step_world as jax_step_world
from thinktwice_tpu_torch.rollout import rollout, stack_events
from thinktwice_tpu_torch.sim.state import state_from_arrays
from thinktwice_tpu_torch.weights import load_roach_policy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RL6 = os.path.join(REPO, "runs", "roach_rl6", "params.msgpack")
N_TICKS = 10
POLICY_EVERY = 2
POSE_TOL = 1e-2   # m after 10 ticks


def test_rollout_matches_jax():
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    with open(RL6, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=4, n_vehicles=12)
    jstate = dataclasses.replace(
        jstate, ego=dataclasses.replace(jstate.ego, speed=jnp.full((2,), 5.0)))
    start = state_from_arrays(jstate, device="cpu")

    ctrl_fn = jax.jit(jax.vmap(lambda s: jax_expert_control(jcfg, params, jtown, s)[0]))
    step = jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))
    draws, jevents, jctrls = [], [], []
    for t in range(N_TICKS):
        if t % POLICY_EVERY == 0:
            ctrl = ctrl_fn(jstate)
            jctrls.append(np.asarray(ctrl))
        draws.append(jax_step_draws(jstate, jtown.spawn.shape[0]))
        jstate, ev = step(jstate, ctrl)
        jevents.append(ev)

    policy = load_roach_policy(RL6, tcfg, device="cpu")
    final, events, ctrls = rollout(tcfg, policy, ttown, start, N_TICKS,
                                   policy_every=POLICY_EVERY, draws=draws)

    assert len(ctrls) == N_TICKS // POLICY_EVERY
    for a, b in zip(ctrls, jctrls):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-3)
    ev = stack_events(events)
    for f in dataclasses.fields(ev):
        ref = np.stack([np.asarray(getattr(e, f.name)) for e in jevents])
        np.testing.assert_array_equal(getattr(ev, f.name).numpy(), ref, err_msg=f.name)
    for name in ("n_collision_vehicle", "n_collision_walker", "n_collision_static",
                 "n_red_light", "n_stop_sign", "route_idx", "ticks", "done"):
        np.testing.assert_array_equal(getattr(final.criteria, name).numpy(),
                                      np.asarray(getattr(jstate.criteria, name)),
                                      err_msg=name)
    np.testing.assert_allclose(final.ego.pos.numpy(), np.asarray(jstate.ego.pos),
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(final.traffic.pos.numpy(), np.asarray(jstate.traffic.pos),
                               rtol=0, atol=POSE_TOL)
    # the egos drove along their routes
    assert bool((final.criteria.route_idx > 0).all())
