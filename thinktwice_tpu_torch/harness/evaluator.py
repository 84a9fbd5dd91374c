"""Closed-loop route evaluator: the leaderboard's route loop as batched
rollouts (counterpart of `thinktwice_tpu/harness/evaluator.py`).

Routes are grouped into batches of worlds; each batch resets together and
runs closed loop in `segment_steps`-tick segments until every world's
criteria report done (or the scan cap), and each world's CriteriaState
becomes a route record of the leaderboard's results document. Routes whose
index is already in the results file are skipped on resume.

The random numbers of a batch (the reset's spawn draw, each tick's
StepDraws, and the policy's own draws where it takes them) come from a
draws provider; by default a torch.Generator seeded with `seed`, which also
draws the policy's numbers through the policy's `sample_draws`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.harness.route_parser import SCENARIO_NAME_TO_KIND, ScenarioTrigger
from thinktwice_tpu_torch.harness.statistics import (
    PENALTY_STOP,
    RouteResult,
    compute_global_statistics,
    compute_route_statistics,
    load_results,
    resume_done_indices,
    save_results,
)
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sim.reset import make_scenarios, reset_world
from thinktwice_tpu_torch.sim.state import WorldState, tree_map, zero_scenarios
from thinktwice_tpu_torch.sim.step import StepDraws, step_world
from thinktwice_tpu_torch.sim.weather import DEFAULT as WEATHER_DEFAULT


def derive_map_triggers(town: TownMap, dense_route: np.ndarray,
                        n_walker_triggers: int = 3):
    """Scenario triggers derived from the map itself: a signalized-junction
    crossing at every light approach the route passes, plus walker crossings
    spread along the route, interleaved."""
    # effective length: padded routes repeat the final point, and triggers
    # in the padding would all collapse onto the goal
    steps = np.linalg.norm(np.diff(dense_route[:, :2], axis=0), axis=1)
    moving = np.nonzero(steps > 1e-6)[0]
    n = (int(moving[-1]) + 2) if len(moving) else len(dense_route)

    valid = town.tl_valid.cpu().numpy()
    tl_pos = town.tl_pos.cpu().numpy()[valid]
    tl_yaw = town.tl_yaw.cpu().numpy()[valid]
    pts = dense_route[:n, :2]
    tls = []
    for p, y in zip(tl_pos, tl_yaw):
        d = np.linalg.norm(pts - p[None], axis=1)
        k = int(np.argmin(d))
        if d[k] > 8.0:
            continue
        ryaw = dense_route[k, 2]
        if abs(np.arctan2(np.sin(ryaw - y), np.cos(ryaw - y))) > 1.0:
            continue
        tls.append(
            ScenarioTrigger("Scenario7", p.astype(np.float64), np.rad2deg(y))
        )
    walkers = []
    for f in np.linspace(0.2, 0.8, n_walker_triggers):
        k = int(f * n)
        walkers.append(
            ScenarioTrigger(
                "Scenario3",
                dense_route[k, :2].astype(np.float64),
                np.rad2deg(dense_route[k, 2]),
            )
        )
    # interleave so the max_scenarios cut in build_route_scenarios trims
    # both kinds instead of dropping every walker on light-heavy routes
    triggers = []
    for i in range(max(len(tls), len(walkers))):
        if i < len(tls):
            triggers.append(tls[i])
        if i < len(walkers):
            triggers.append(walkers[i])
    return triggers


def build_route_scenarios(cfg: Config, dense_route: np.ndarray, triggers,
                          device="cuda"):
    """ScenarioTrigger list -> ScenarioState of one route (world axis 1), or
    None when no trigger maps to a kind. Walker scenarios take walker slots
    round-robin; vehicle scenarios take the top traffic slots (above the
    background traffic)."""
    kinds, poss, actors, params = [], [], [], []
    w_slot, v_slot = 0, cfg.sim.max_vehicles - 1
    for t in triggers[: cfg.sim.max_scenarios]:
        kind = SCENARIO_NAME_TO_KIND.get(t.scenario_type, 0)
        if kind == 0:
            continue
        p3 = 0.0
        if kind in (1,):                     # walker actor
            actor = w_slot % cfg.sim.max_walkers
            w_slot += 1
        elif kind in (3, 4, 5, 6):           # one vehicle actor
            actor = v_slot
            v_slot = max(v_slot - 1, 0)
        elif kind == 7:                      # lead + blocker (two slots)
            actor = v_slot
            v_slot = max(v_slot - 1, 0)
            p3 = float(v_slot)               # blocker slot in param[3]
            v_slot = max(v_slot - 1, 0)
        else:                                # ego-only (control loss)
            actor = 0
        kinds.append(kind)
        poss.append(t.pos)
        actors.append(actor)
        params.append([15.0, np.deg2rad(t.yaw_deg), 0.0, p3])
    if not kinds:
        return None
    return make_scenarios(
        cfg,
        kinds=np.asarray(kinds),
        trigger_pos=np.asarray(poss, np.float64),
        actor_idx=np.asarray(actors),
        params=np.asarray(params, np.float64),
        device=device,
    )


@dataclasses.dataclass(frozen=True)
class BatchDraws:
    """The random numbers of one batch of worlds: the reset's spawn draw
    (B, SP), each tick's StepDraws from the state before the tick, and, for
    a policy that takes them, each policy call's draws (passed as
    `draws=`)."""

    spawn_uniform: torch.Tensor
    step: Callable[[WorldState], StepDraws]
    policy: Callable[[WorldState], Any] | None = None


class GeneratorDraws:
    """Draws provider: every batch's numbers from one torch.Generator seeded
    with `seed`. They are drawn on `device` (default: the town's) and moved
    to the town's device, so two runs on different devices that draw on
    the same one see the same numbers. With `sample_policy(n_worlds,
    generator)`, each policy call's draws come from the same generator."""

    def __init__(self, seed: int, device=None,
                 sample_policy: Callable[[int, torch.Generator], Any] | None = None):
        self.seed = seed
        self.device = device
        self.sample_policy = sample_policy
        self.generator: torch.Generator | None = None

    def __call__(self, n_worlds: int, town: TownMap) -> BatchDraws:
        dev = torch.device(self.device) if self.device is not None else town.device
        if self.generator is None:
            self.generator = torch.Generator(device=dev).manual_seed(self.seed)
        g = self.generator
        n_spawn = town.spawn.shape[0]

        def step(state: WorldState) -> StepDraws:
            B, V = state.traffic.active.shape
            return StepDraws(
                steer_normal=torch.randn((B,), generator=g, device=dev).to(town.device),
                recycle_cand=torch.randint(0, n_spawn, (B, V), generator=g,
                                           device=dev).to(town.device),
            )

        policy = None
        if self.sample_policy is not None:
            def policy(state: WorldState):
                return self.sample_policy(state.n_worlds, g)

        spawn = torch.rand((n_worlds, n_spawn), generator=g, device=dev)
        return BatchDraws(spawn_uniform=spawn.to(town.device), step=step, policy=policy)


def _pad_route(r, R: int) -> np.ndarray:
    """Truncate to R points, or pad by repeating the last point."""
    r = np.asarray(r, np.float32)
    if len(r) >= R:
        return r[:R]
    return np.concatenate([r, np.repeat(r[-1:], R - len(r), axis=0)])


@torch.no_grad()
def evaluate_routes(
    cfg: Config,
    town: TownMap,
    routes: Sequence[np.ndarray],       # each (R, 3) dense (x, y, yaw)
    route_ids: Sequence[str],
    policy_fn: Callable,                # (cfg, town, state) -> (B, 3) control,
                                        # or with policy_init given:
                                        # (cfg, town, state, carry) ->
                                        # (control, carry)
    n_vehicles: int = 0,
    max_steps: int | None = None,
    worlds_per_batch: int = 8,
    out_path: str | None = None,
    resume: bool = False,
    stop_penalty: float = PENALTY_STOP,
    seed: int = 0,
    scenarios: Sequence | None = None,  # optional per-route ScenarioState
    policy_init: Callable | None = None,  # (n_worlds) -> the batch's carry
    segment_steps: int = 1024,
    verbose: bool = False,
    weathers: Sequence | None = None,   # optional per-route (10,) params
    policy_every: int = 1,  # run the policy every k ticks, holding the
                            # control in between (2: the expert's 10 Hz)
    draws: Callable[[int, TownMap], BatchDraws] | None = None,  # default:
                                        # GeneratorDraws(seed), with the
                                        # policy's sample_draws if it has one
    batch_log: list | None = None,      # gets one dict per batch: routes,
                                        # worlds, ticks run, seconds
) -> dict:
    """Run every route closed loop on the town's device; returns the global
    statistics record (and writes the results document to out_path after
    every batch).

    The final batch is padded to worlds_per_batch by repeating its last
    route; only its real routes get records. A batch runs whole segments
    and stops once every world is done, or at the scan cap: max_steps, or
    the route timeout bound of the batch's longest route plus two
    segments."""
    R = cfg.sim.max_route_len
    done = resume_done_indices(out_path) if (resume and out_path) else set()
    records = []
    if done and out_path:
        records = load_results(out_path)["_checkpoint"]["records"]

    if segment_steps % policy_every:
        raise ValueError(
            f"segment_steps ({segment_steps}) must be a multiple of "
            f"policy_every ({policy_every})"
        )
    padded = [_pad_route(r, R) for r in routes]
    stateful = policy_init is not None
    dev = town.device
    if draws is None:
        draws = GeneratorDraws(seed, sample_policy=getattr(policy_fn, "sample_draws", None))

    def run_segment(states, carry, batch: BatchDraws):
        for _ in range(segment_steps // policy_every):
            pd = None if batch.policy is None else batch.policy(states)
            kw = {} if pd is None else {"draws": pd}
            if stateful:
                ctrl, carry = policy_fn(cfg, town, states, carry, **kw)
            else:
                ctrl = policy_fn(cfg, town, states, **kw)
            # zero-order hold: the control applies for policy_every ticks;
            # the criteria still tick every world step
            for _k in range(policy_every):
                states, _ = step_world(cfg, town, states, ctrl, draws=batch.step(states))
        return states, carry

    empty_scen = zero_scenarios(cfg, 1, dev)
    scen_list = [
        (tree_map(lambda x: x.to(dev), scenarios[i])
         if scenarios and scenarios[i] is not None else empty_scen)
        for i in range(len(padded))
    ]

    todo = [i for i in range(len(padded)) if i not in done]
    for start in range(0, len(todo), worlds_per_batch):
        chunk = todo[start : start + worlds_per_batch]
        # pad the final chunk to the batch size
        pad_to = worlds_per_batch
        idxs = chunk + [chunk[-1]] * (pad_to - len(chunk))
        routes_b = torch.as_tensor(np.stack([padded[i] for i in idxs]), device=dev)
        batch = draws(pad_to, town)
        scen_b = tree_map(lambda *xs: torch.cat(xs), *[scen_list[i] for i in idxs])
        weather_b = np.stack(
            [
                (
                    weathers[i]
                    if weathers is not None and weathers[i] is not None
                    else WEATHER_DEFAULT
                )
                for i in idxs
            ]
        ).astype(np.float32)

        lengths = [
            float(np.linalg.norm(np.diff(padded[i][:, :2], axis=0), axis=1).sum())
            for i in idxs
        ]
        if max_steps is None:
            # the route timeout bound (0.8 s/m + 5 s at 20 Hz); the in-sim
            # timeout criterion fires first, this is just the cap
            n_steps = int(
                (cfg.sim.timeout_per_meter * max(lengths) + cfg.sim.timeout_base)
                / cfg.sim.dt
            ) + 2 * segment_steps
        else:
            n_steps = max_steps

        t0 = time.time()
        states = reset_world(cfg, town, routes_b, n_vehicles=n_vehicles,
                             spawn_uniform=batch.spawn_uniform, scenario=scen_b,
                             weather=weather_b)
        carry = policy_init(pad_to) if stateful else None
        steps_run = 0
        while steps_run < n_steps:
            states, carry = run_segment(states, carry, batch)
            steps_run += segment_steps
            flags = states.criteria.done.cpu().numpy()
            if verbose:
                comp = states.criteria.route_completion.cpu().numpy()
                print(
                    f"  seg @{steps_run}: done={int(flags.sum())}/{pad_to} "
                    f"completion={np.round(comp, 2).tolist()}",
                    flush=True,
                )
            if flags.all():
                break
        crit_host = tree_map(lambda x: x.cpu(), states.criteria)
        wall = time.time() - t0
        if batch_log is not None:
            batch_log.append(dict(routes=len(chunk), worlds=pad_to, ticks=steps_run,
                                  seconds=wall))

        for j, i in enumerate(chunk):
            crit_j = tree_map(lambda x: x[j], crit_host)
            rr = RouteResult.from_criteria(
                route_ids[i], i, crit_j, lengths[j],
                # criteria.ticks freezes with the world at done: the
                # route's own game time, not the segments'
                duration_game_s=float(crit_j.ticks) * cfg.sim.dt,
                duration_system_s=wall / len(chunk),
            )
            records.append(compute_route_statistics(rr, stop_penalty))
        if out_path:
            # checkpoint after every batch, so that a resume after a crash
            # skips the batches that finished
            save_results(
                out_path,
                records,
                compute_global_statistics(records, total_routes=len(routes)),
            )

    g = compute_global_statistics(records, total_routes=len(routes))
    if out_path:
        save_results(out_path, records, g)
    return g
