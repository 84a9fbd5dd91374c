"""The world step: one 20 Hz tick for a batch of worlds (counterpart of
`thinktwice_tpu/sim/step.py`).

    apply ego control -> traffic policy -> integrate all actors ->
    scenario state machines -> light phases -> criteria -> history ring.

The step's two random draws (the ControlLoss steering noise and the
candidate spawn of the deadlock recycle) are an optional input, StepDraws;
by default they come from a torch.Generator on the state's device. A world
whose route is done freezes (only its tick advances).
"""

from __future__ import annotations

import dataclasses

import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.maps.town import TownMap, traffic_light_states
from thinktwice_tpu_torch.sim import scenarios as scen_lib
from thinktwice_tpu_torch.sim.criteria import update_criteria
from thinktwice_tpu_torch.sim.dynamics import bicycle_step, point_mass_step
from thinktwice_tpu_torch.sim.state import (
    EgoState,
    HistoryState,
    TrafficState,
    WalkerState,
    WorldState,
    tree_map,
)
from thinktwice_tpu_torch.sim.traffic import ego_red_ahead, traffic_policy

ROUTE_WIN = 16  # route points the traffic policy sees ahead of the ego


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """The random numbers of one tick: steer_normal (B,) standard normal,
    recycle_cand (B, V) int64 spawn index in [0, SP)."""

    steer_normal: torch.Tensor
    recycle_cand: torch.Tensor


def sample_step_draws(town: TownMap, state: WorldState,
                      generator: torch.Generator | None = None,
                      n_worlds: int | None = None) -> StepDraws:
    """One tick's draws for the state's worlds (for n_worlds, when given)."""
    B, V = state.traffic.active.shape
    B = B if n_worlds is None else n_worlds
    dev = state.tick.device
    return StepDraws(
        steer_normal=torch.randn((B,), generator=generator, device=dev),
        recycle_cand=torch.randint(0, town.spawn.shape[0], (B, V),
                                   generator=generator, device=dev),
    )


@dataclasses.dataclass(frozen=True)
class WorldSlice:
    """Rows [start, stop) of a batch of `total` worlds: the worlds one rank
    of a process group steps. A tick's draws are made for all `total`
    worlds, from the generator every rank seeds alike or as given, and cut
    to these rows, so a run sharded over ranks draws what the one-process
    run of all the worlds draws (the JAX package keeps a key per world,
    and its sharded run equals its unsharded one)."""

    start: int
    stop: int
    total: int

    def step_draws(self, town: TownMap, state: WorldState, draws: StepDraws | None = None,
                   generator: torch.Generator | None = None) -> StepDraws:
        """These rows of a tick's draws of all the worlds (drawn from
        generator when draws is None)."""
        if draws is None:
            draws = sample_step_draws(town, state, generator, n_worlds=self.total)
        return StepDraws(steer_normal=draws.steer_normal[self.start:self.stop],
                         recycle_cand=draws.recycle_cand[self.start:self.stop])


def _push_history(hist: HistoryState, traffic: TrafficState,
                  walkers: WalkerState, tl_states) -> HistoryState:
    B, Hh = hist.veh_active.shape[:2]
    bidx = torch.arange(B, device=hist.ptr.device)
    ptr = hist.ptr

    def put(ring, value):
        ring = ring.clone()
        ring[bidx, ptr] = value
        return ring

    veh_pose = torch.cat(
        [traffic.pos, traffic.yaw[..., None], traffic.extent], dim=-1
    )
    wlk_pose = torch.cat(
        [walkers.pos, walkers.yaw[..., None], walkers.extent], dim=-1
    )
    return HistoryState(
        veh_pose=put(hist.veh_pose, veh_pose),
        veh_active=put(hist.veh_active, traffic.active),
        wlk_pose=put(hist.wlk_pose, wlk_pose),
        wlk_active=put(hist.wlk_active, walkers.active),
        tl_state=put(hist.tl_state, tl_states.to(torch.int8)),
        ptr=(ptr + 1) % Hh,
        count=torch.clamp_max(hist.count + 1, Hh),
    )


def route_window(route, route_idx, n: int):
    """(B, n, C) slice of route (B, R, C) starting at route_idx, with the
    start clamped so the slice fits (jax.lax.dynamic_slice semantics)."""
    R = route.shape[1]
    start = torch.clamp(route_idx, 0, R - n)
    idx = start[:, None] + torch.arange(n, device=route.device)
    return torch.gather(route, 1, idx[..., None].expand(-1, -1, route.shape[2]))


def time_after_tick(state: WorldState, dt: float):
    """(B,) seconds at the end of this tick, t + dt with t = tick x 0.05,
    rounded once: the reference's XLA fuses the two into a multiply-add, and
    rounding the product first differs by an ulp on many ticks, which
    moves a timeout on its boundary by a tick."""
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    exact = state.tick.to(torch.float64) * f32(0.05) + f32(dt)
    return exact.to(torch.float32)


def _freeze(done, new, old):
    """Keep old where the world is done; done (B,) broadcast over new."""
    d = done.reshape(done.shape + (1,) * (new.dim() - 1))
    return torch.where(d, old, new)


def step_world(cfg: Config, town: TownMap, state: WorldState, control,
               draws: StepDraws | None = None,
               generator: torch.Generator | None = None):
    """Advance every world one tick. control (B, 3) = (steer, throttle,
    brake). Returns (WorldState', Events)."""
    sim = cfg.sim
    if draws is None:
        draws = sample_step_draws(town, state, generator)
    dev = state.tick.device
    ego0 = state.ego

    t = state.time_s
    tl_states = traffic_light_states(town, t)

    # --- scenarios (inject walkers/vehicles, overrides, ego steer noise) --
    (scen, walkers, tr, steer_noise, scripted_mask,
     scripted_speed) = scen_lib.step_scenarios(
        cfg, state.scenario, ego0.pos, state.walkers, state.traffic,
        draws.steer_normal, sim.dt, ego_speed=ego0.speed,
    )
    # light-manipulator slots pin nearby aligned lights; every consumer of
    # this tick's tl_states sees the override
    tl_over = scen_lib.scenario_tl_override(
        scen, town.tl_pos, town.tl_yaw, town.tl_valid
    )
    tl_states = torch.where(tl_over >= 0, tl_over, tl_states)

    # --- ego integration ----------------------------------------------------
    steer = torch.clamp(control[:, 0] + steer_noise, -1.0, 1.0)
    throttle = torch.clamp(control[:, 1], 0.0, 1.0)
    brake = control[:, 2]
    e_pos, e_yaw, e_speed = bicycle_step(
        sim, ego0.pos, ego0.yaw, ego0.speed, steer, throttle, brake,
        drag=sim.drag,
    )
    ego = EgoState(
        pos=e_pos, yaw=e_yaw, speed=e_speed, extent=ego0.extent,
        control=torch.stack([steer, throttle, brake], dim=-1),
    )

    # --- traffic --------------------------------------------------------------
    route_win = route_window(state.route, state.criteria.route_idx, ROUTE_WIN)
    yaw_rate, accel, new_wp, loop_jump = traffic_policy(
        sim, town, tl_states, tr.pos, tr.yaw, tr.speed, tr.extent, tr.wp_idx,
        tr.active, ego0.pos, ego0.yaw, ego0.extent, ego0.speed,
        walkers.pos, walkers.extent, walkers.active,
        ego_route=route_win[..., :2],
        ego_slow_s=state.criteria.slow_s,
        ego_held_red=ego_red_ahead(town, tl_states, route_win),
    )
    # scripted scenario vehicles hold heading and speed
    yaw_rate = torch.where(scripted_mask, torch.zeros_like(yaw_rate), yaw_rate)
    accel = torch.where(scripted_mask,
                        (scripted_speed - tr.speed) / sim.dt * 0.5, accel)

    t_pos, t_yaw, t_speed = point_mass_step(
        tr.pos, tr.yaw, tr.speed, yaw_rate, accel, sim.dt
    )
    # loop-jump teleport onto the successor when the landing is clear of the
    # ego and of other vehicles; until then hold at the route end and retry
    V = tr.pos.shape[1]
    not_self = ~torch.eye(V, dtype=torch.bool, device=dev)
    jump_to = town.lane_pts[new_wp]
    clear_ego = torch.linalg.norm(jump_to - ego0.pos[:, None], dim=-1) > 25.0
    d_pairs = torch.linalg.norm(jump_to[:, :, None] - t_pos[:, None, :], dim=-1)
    clear_veh = torch.all(
        (d_pairs > 8.0) | ~tr.active[:, None, :] | ~not_self, dim=2
    )
    do_jump = loop_jump & ~scripted_mask & tr.active
    teleport = do_jump & clear_ego & clear_veh
    hold = do_jump & ~teleport
    t_pos = torch.where(teleport[..., None], jump_to, t_pos)
    t_pos = torch.where(hold[..., None], tr.pos, t_pos)
    t_yaw = torch.where(teleport, town.lane_yaw[new_wp], t_yaw)
    t_speed = torch.where(teleport | hold, torch.zeros_like(t_speed), t_speed)
    new_wp = torch.where(hold, tr.wp_idx, new_wp)

    # --- deadlock recycle: respawn an NPC stationary longer than any red
    # phase on a random clear spawn point; scenario actors are exempt
    running = scen.state == scen_lib.RUNNING
    v_ids = torch.arange(V, device=dev)
    prot = torch.any(running[..., None] & (scen.actor_idx[..., None] == v_ids), dim=1)
    blocker = scen.param[..., 3].to(torch.int64)
    prot = prot | torch.any(
        (running & (scen.kind == scen_lib.KIND_BLOCKED_OVERTAKE))[..., None]
        & (blocker[..., None] == v_ids),
        dim=1,
    ) | scripted_mask
    stationary = tr.active & (t_speed < 0.5) & ~prot
    flowing = t_speed > 1.5
    stop_s = torch.where(
        stationary, tr.stop_s + sim.dt,
        torch.where(flowing, torch.clamp_min(tr.stop_s - 5.0 * sim.dt, 0.0),
                    tr.stop_s),
    )
    cand = draws.recycle_cand
    cand_pos = town.spawn[cand, :2]
    ok_valid = town.spawn_valid[cand]
    ok_ego = torch.linalg.norm(cand_pos - ego0.pos[:, None], dim=-1) > 30.0
    d_cv = torch.linalg.norm(cand_pos[:, :, None] - t_pos[:, None, :], dim=-1)
    ok_veh = torch.all((d_cv > 10.0) | ~tr.active[:, None, :] | ~not_self, dim=2)
    recycle = (stop_s > sim.npc_recycle_s) & ok_valid & ok_ego & ok_veh
    t_pos = torch.where(recycle[..., None], cand_pos, t_pos)
    t_yaw = torch.where(recycle, town.spawn[cand, 2], t_yaw)
    t_speed = torch.where(recycle, torch.zeros_like(t_speed), t_speed)
    new_wp = torch.where(recycle, town.spawn_wp[cand], new_wp)
    stop_s = torch.where(recycle, torch.zeros_like(stop_s), stop_s)

    act = tr.active
    traffic = TrafficState(
        pos=torch.where(act[..., None], t_pos, tr.pos),
        yaw=torch.where(act, t_yaw, tr.yaw),
        speed=torch.where(act, t_speed, tr.speed),
        extent=tr.extent,
        wp_idx=torch.where(act, new_wp, tr.wp_idx),
        active=tr.active,
        stop_s=torch.where(act, stop_s, tr.stop_s),
    )

    # --- walkers --------------------------------------------------------------
    w_pos, _, _ = point_mass_step(
        walkers.pos, walkers.yaw, walkers.speed,
        torch.zeros_like(walkers.yaw), torch.zeros_like(walkers.speed), sim.dt,
    )
    walkers = dataclasses.replace(
        walkers, pos=torch.where(walkers.active[..., None], w_pos, walkers.pos)
    )

    # --- criteria ---------------------------------------------------------------
    crit, events = update_criteria(
        cfg, town, state.criteria, ego0.pos, ego.pos, ego.yaw, ego.speed,
        ego.extent, traffic.pos, traffic.yaw, traffic.extent, traffic.active,
        walkers.pos, walkers.yaw, walkers.extent, walkers.active, tl_states,
        state.route, state.route_cumlen, state.route_len_m, time_after_tick(state, sim.dt),
    )
    history = _push_history(state.history, traffic, walkers, tl_states)

    new_state = WorldState(
        tick=state.tick + 1,
        ego=ego,
        traffic=traffic,
        walkers=walkers,
        route=state.route,
        route_cumlen=state.route_cumlen,
        route_len_m=state.route_len_m,
        criteria=crit,
        history=history,
        scenario=scen,
        weather=state.weather,
    )
    done = state.criteria.done
    frozen = tree_map(lambda new, old: _freeze(done, new, old), new_state, state)
    frozen = dataclasses.replace(frozen, tick=new_state.tick)
    events = tree_map(lambda e: e & ~done, events)
    return frozen, events


def rollout(cfg: Config, town: TownMap, state: WorldState, policy_fn, n_steps: int,
            draws: list[StepDraws] | None = None,
            generator: torch.Generator | None = None):
    """A closed-loop rollout of n_steps ticks: policy_fn(cfg, town, state) ->
    (B, 3) control, then step_world, every tick. draws, when given, holds
    each tick's StepDraws; else they come from `generator`. Returns (final
    state, Events of (n_steps, B) tensors), stacked on the tick axis as the
    JAX package's scan stacks them."""
    events = []
    for t in range(n_steps):
        ctrl = policy_fn(cfg, town, state)
        state, ev = step_world(cfg, town, state, ctrl,
                               draws=None if draws is None else draws[t],
                               generator=generator)
        events.append(ev)
    return state, tree_map(lambda *xs: torch.stack(xs), *events)
