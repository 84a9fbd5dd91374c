"""World-parallel rollouts on one card (counterpart of
`thinktwice_tpu/parallel/worlds.py`).

A batch of worlds is the leading axis of every WorldState tensor, so one
`step_world` call advances all of them. Spreading world groups over
several cards (the JAX package's `make_world_mesh` and sharded rollout)
waits for the multi-GPU slice of the port.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sim.reset import reset_world
from thinktwice_tpu_torch.sim.step import StepDraws, step_world


# routes (W, R, 3) on the town's device -> WorldState of W worlds: the
# world axis is already explicit in reset_world, so the JAX package's
# vmapped batched_reset is reset_world itself.
batched_reset = reset_world


def roll(cfg: Config, town: TownMap, states, policy_fn, n_steps: int,
         draws: list[StepDraws] | None = None,
         generator: torch.Generator | None = None):
    """Yield the WorldState after each of n_steps ticks, with policy_fn(cfg,
    town, state) -> (W, 3) every tick. draws, when given, holds each tick's
    StepDraws; else they come from generator."""
    for t in range(n_steps):
        ctrl = policy_fn(cfg, town, states)
        states, _ = step_world(cfg, town, states, ctrl,
                               draws=None if draws is None else draws[t],
                               generator=generator)
        yield states


@torch.no_grad()
def batched_rollout(cfg: Config, town: TownMap, states, policy_fn, n_steps: int,
                    draws: list[StepDraws] | None = None,
                    generator: torch.Generator | None = None):
    """Roll W worlds n_steps ticks (see roll); returns the final WorldState.
    Aggregate it with summarize_events()."""
    for states in roll(cfg, town, states, policy_fn, n_steps, draws, generator):
        pass
    return states


def summarize_events(final_states) -> dict:
    """Host-side aggregation of per-world criteria into scalar counts."""
    crit = final_states.criteria
    return {
        "worlds": int(crit.route_completion.shape[0]),
        "mean_completion": float(torch.mean(crit.route_completion)),
        "finished": int(torch.sum(crit.finished)),
        "blocked": int(torch.sum(crit.blocked)),
        "collisions_vehicle": int(torch.sum(crit.n_collision_vehicle)),
        "collisions_walker": int(torch.sum(crit.n_collision_walker)),
        "red_lights": int(torch.sum(crit.n_red_light)),
    }
