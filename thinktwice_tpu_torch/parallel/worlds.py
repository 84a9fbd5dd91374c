"""World-parallel rollouts on one card and over a process group
(counterpart of `thinktwice_tpu/parallel/worlds.py`).

A batch of worlds is the leading axis of every WorldState tensor, so one
`step_world` call advances all of them. Over several cards, the
counterpart of the JAX package's `worlds` mesh is a process group of one
rank a card (`make_world_group`): rank r of n steps rows [rW/n, (r+1)W/n)
of the W worlds (`shard_worlds`) with no collective inside the loop, and
the event counts meet once at the end (`summarize_events(final, group)`).
Every rank draws each tick's random numbers for all W worlds from the
generator they seed alike (or takes the global draws given) and keeps its
own rows (`sim.step.WorldSlice`), so the sharded run steps what the
one-process run of all W worlds steps.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.parallel.launch import Group, init_group
from thinktwice_tpu_torch.sim.reset import reset_world
from thinktwice_tpu_torch.sim.state import tree_map
from thinktwice_tpu_torch.sim.step import StepDraws, WorldSlice, step_world


# routes (W, R, 3) on the town's device -> WorldState of W worlds: the
# world axis is already explicit in reset_world, so the JAX package's
# vmapped batched_reset is reset_world itself.
batched_reset = reset_world

# the counterpart of make_world_mesh: the process group the worlds spread over
make_world_group = init_group


def world_slice(group: Group, n_local: int) -> WorldSlice:
    """The rows of rank group.rank, n_local worlds each, in the batch of
    all the ranks' worlds."""
    return WorldSlice(group.rank * n_local, (group.rank + 1) * n_local,
                      group.size * n_local)


def shard_worlds(group: Group, states):
    """This rank's W/n of the W worlds, on its device."""
    W = states.n_worlds
    if W % group.size:
        raise ValueError(f"{W} worlds do not split over {group.size} ranks")
    rows = world_slice(group, W // group.size)
    return tree_map(lambda x: x[rows.start:rows.stop].to(group.device), states)


def gather_worlds(group: Group, states, dst: int = 0):
    """Every rank's worlds, in rank order, as one WorldState on rank dst
    (None on the others)."""
    full = tree_map(lambda x: torch.cat(group.all_gather(x)), states)
    return full if group.rank == dst else None


def roll(cfg: Config, town: TownMap, states, policy_fn, n_steps: int,
         draws: list[StepDraws] | None = None,
         generator: torch.Generator | None = None,
         worlds: WorldSlice | None = None):
    """Yield the WorldState after each of n_steps ticks, with policy_fn(cfg,
    town, state) -> (W, 3) every tick. draws, when given, holds each tick's
    StepDraws; else they come from generator. With worlds, states are those
    rows of a larger batch, and each tick's draws are cut to them."""
    for t in range(n_steps):
        ctrl = policy_fn(cfg, town, states)
        tick = None if draws is None else draws[t]
        if worlds is not None:
            tick = worlds.step_draws(town, states, tick, generator)
        states, _ = step_world(cfg, town, states, ctrl, draws=tick, generator=generator)
        yield states


@torch.no_grad()
def batched_rollout(cfg: Config, town: TownMap, states, policy_fn, n_steps: int,
                    draws: list[StepDraws] | None = None,
                    generator: torch.Generator | None = None,
                    group: Group | None = None):
    """Roll W worlds n_steps ticks (see roll); returns the final WorldState.
    With a group, states are this rank's worlds (shard_worlds), draws (or
    the generator's) are those of every rank's worlds, and no collective
    runs inside the loop. Aggregate the result with summarize_events()."""
    worlds = None if group is None else world_slice(group, states.n_worlds)
    for states in roll(cfg, town, states, policy_fn, n_steps, draws, generator, worlds):
        pass
    return states


def summarize_events(final_states, group: Group | None = None) -> dict:
    """Host-side aggregation of per-world criteria into scalar counts; with
    a group, over every rank's worlds (one all-reduce), as the one-process
    summary of all of them. Sums are taken in float64."""
    crit = final_states.criteria
    sums = torch.stack([torch.sum(x.to(torch.float64)) for x in (
        torch.ones_like(crit.route_completion), crit.route_completion, crit.finished,
        crit.blocked, crit.n_collision_vehicle, crit.n_collision_walker, crit.n_red_light)])
    if group is not None:
        sums = group.all_sum(sums)
    n, completion, *counts = sums.tolist()
    names = ("finished", "blocked", "collisions_vehicle", "collisions_walker", "red_lights")
    return {"worlds": int(n), "mean_completion": completion / n,
            **{k: int(c) for k, c in zip(names, counts)}}
