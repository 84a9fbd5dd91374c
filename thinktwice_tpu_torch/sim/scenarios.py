"""Adversarial scenarios as data-driven state machines (counterpart of
`thinktwice_tpu/sim/scenarios.py`).

Each slot is a row of ScenarioState: a kind, a trigger position, a state
(armed -> running -> done), a timer and the actor slot it drives.
`step_scenarios` advances every slot of every world at once and returns
actor overrides and the ego's steering-noise term.
"""

from __future__ import annotations

import math

import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.geometry import wrap_angle
from thinktwice_tpu_torch.sim.state import ScenarioState, TrafficState, WalkerState

KIND_EMPTY = 0
KIND_DYNAMIC_CROSSING = 1
KIND_CONTROL_LOSS = 2
KIND_LEAD_VEHICLE_BRAKE = 3
KIND_CROSSING_VEHICLE = 4
KIND_ONCOMING_VEHICLE = 5
KIND_VEHICLE_TURNING = 6
KIND_BLOCKED_OVERTAKE = 7
KIND_TL_MANIPULATOR = 8

ARMED, RUNNING, DONE = 0, 1, 2

CROSSING_DURATION = 6.0
CONTROL_LOSS_DURATION = 3.0
CONTROL_LOSS_NOISE = 0.15
LEAD_BRAKE_DURATION = 12.0
LEAD_BRAKE_DELAY = 3.0
LEAD_CRUISE_SPEED = 6.0
CROSS_VEHICLE_SPEED = 8.0
CROSS_VEHICLE_DURATION = 6.0
ONCOMING_SPEED = 6.0
ONCOMING_DURATION = 5.0
CYCLIST_SPEED = 4.0
CYCLIST_DURATION = 8.0
CYCLIST_EXTENT = (0.9, 0.4)
LEAD_SLOW_SPEED = 4.0
BLOCKER_SPEED = 5.5
OVERTAKE_DURATION = 14.0
WALKER_SIDE_OFFSET = 6.0
TL_FORCE_DURATION = 20.0
TL_FORCE_RADIUS = 25.0

_DURATIONS = (
    1e9,                      # EMPTY (never)
    CROSSING_DURATION,
    CONTROL_LOSS_DURATION,
    LEAD_BRAKE_DURATION,
    CROSS_VEHICLE_DURATION,
    ONCOMING_DURATION,
    CYCLIST_DURATION,
    OVERTAKE_DURATION,
    TL_FORCE_DURATION,
)


def _one_hot(idx, n):
    """(B, S) int -> (B, S, n) bool; out-of-range indices give all False
    (like jax.nn.one_hot)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _select(mask, values):
    """sum_s mask[b, s, v] * values[b, s, ...] -> (B, V, ...), the einsum
    that picks each actor's value from the scenario that drives it."""
    m = mask.to(values.dtype)
    if values.dim() == 2:
        return torch.einsum("bsv,bs->bv", m, values)
    return torch.einsum("bsv,bsc->bvc", m, values)


def step_scenarios(cfg: Config, scen: ScenarioState, ego_pos,
                   walkers: WalkerState, traffic: TrafficState, steer_normal,
                   dt: float, ego_speed):
    """Advance every scenario slot one tick.

    steer_normal (B,) is a standard-normal draw per world; the ControlLoss
    noise is CONTROL_LOSS_NOISE times it while such a slot runs. Returns
    (scen', walkers', traffic', steer_noise (B,), scripted_mask (B, V),
    scripted_speed (B, V)). The JAX package also returns a per-vehicle
    speed cap, which no scenario kind sets any more (always 1e4); it has
    no counterpart here."""
    dev = ego_pos.device
    d_trig = torch.linalg.norm(scen.trigger_pos - ego_pos[:, None], dim=-1)
    trigger_dist = torch.where(scen.param[..., 0] > 0, scen.param[..., 0], 15.0)

    fire = (scen.state == ARMED) & (scen.kind != KIND_EMPTY) & (d_trig < trigger_dist)

    durations = torch.tensor(_DURATIONS, device=dev)
    duration = durations[torch.clamp(scen.kind, 0, 8)]
    new_timer = torch.where(
        scen.state == RUNNING, scen.timer + dt,
        torch.where(fire, torch.zeros_like(scen.timer), scen.timer),
    )
    finish = (scen.state == RUNNING) & (new_timer > duration)
    new_state = torch.where(
        fire, RUNNING, torch.where(finish, DONE, scen.state)
    )

    # walker activation for DYNAMIC_CROSSING: param = [trigger_dist,
    # walk_yaw, side_offset, _]; the walker starts at the roadside and dashes
    # across timed to reach the lane center as the ego arrives
    W = walkers.pos.shape[1]
    slot_onehot = _one_hot(scen.actor_idx, W)                    # (B, S, W)
    is_crossing = scen.kind == KIND_DYNAMIC_CROSSING
    activate = (fire & is_crossing)[..., None] & slot_onehot
    deactivate = (finish & is_crossing)[..., None] & slot_onehot
    act_any = torch.any(activate, dim=1)                          # (B, W)
    deact_any = torch.any(deactivate, dim=1)

    side = torch.where(scen.param[..., 2] > 0, scen.param[..., 2],
                       WALKER_SIDE_OFFSET)
    walk_dir = torch.stack(
        [torch.cos(scen.param[..., 1]), torch.sin(scen.param[..., 1])], dim=-1
    )
    roadside = scen.trigger_pos - side[..., None] * walk_dir
    ttc = d_trig / torch.clamp_min(ego_speed, 1.0)[:, None]
    dash = torch.clamp(side / torch.clamp_min(ttc, 0.5), 1.0, 4.0)

    start_pos = _select(activate, roadside)
    start_yaw = _select(activate, scen.param[..., 1])
    start_speed = _select(activate, dash)

    new_wlk = WalkerState(
        pos=torch.where(act_any[..., None], start_pos, walkers.pos),
        yaw=torch.where(act_any, start_yaw, walkers.yaw),
        speed=torch.where(
            act_any, start_speed,
            torch.where(deact_any, torch.zeros_like(walkers.speed), walkers.speed),
        ),
        extent=walkers.extent,
        active=(walkers.active | act_any) & ~deact_any,
    )

    # scenario vehicles (lead brake, crossing, oncoming, turning cyclist,
    # blocked overtake): param = [trigger_dist, drive_yaw, _, blocker_slot]
    V = traffic.pos.shape[1]
    veh_onehot = _one_hot(scen.actor_idx, V)                     # (B, S, V)

    is_lead_brake = scen.kind == KIND_LEAD_VEHICLE_BRAKE
    is_vehicle_scen = (
        (scen.kind == KIND_CROSSING_VEHICLE)
        | (scen.kind == KIND_ONCOMING_VEHICLE)
        | (scen.kind == KIND_VEHICLE_TURNING)
        | (scen.kind == KIND_BLOCKED_OVERTAKE)
        | is_lead_brake
    )
    v_activate = (fire & is_vehicle_scen)[..., None] & veh_onehot
    v_deactivate = (finish & is_vehicle_scen)[..., None] & veh_onehot

    heading = torch.stack(
        [torch.cos(scen.param[..., 1]), torch.sin(scen.param[..., 1])], dim=-1
    )
    left = torch.stack(
        [-torch.sin(scen.param[..., 1]), torch.cos(scen.param[..., 1])], dim=-1
    )
    is_turning = scen.kind == KIND_VEHICLE_TURNING
    is_overtake = scen.kind == KIND_BLOCKED_OVERTAKE
    primary_pos = torch.where(
        is_turning[..., None],
        scen.trigger_pos - WALKER_SIDE_OFFSET * heading,
        torch.where(
            (is_overtake | is_lead_brake)[..., None],
            scen.trigger_pos + 18.0 * heading,
            scen.trigger_pos,
        ),
    )
    lead_speed = torch.where(new_timer < LEAD_BRAKE_DELAY, LEAD_CRUISE_SPEED, 0.0)
    scen_speed = torch.where(
        is_turning, CYCLIST_SPEED,
        torch.where(
            is_overtake, LEAD_SLOW_SPEED,
            torch.where(
                is_lead_brake, lead_speed,
                torch.where(scen.kind == KIND_CROSSING_VEHICLE,
                            CROSS_VEHICLE_SPEED, ONCOMING_SPEED),
            ),
        ),
    )

    # the blocked overtake's second actor: an adjacent-lane blocker
    blk_onehot = _one_hot(scen.param[..., 3].to(torch.int64), V)
    b_activate = (fire & is_overtake)[..., None] & blk_onehot
    b_deactivate = (finish & is_overtake)[..., None] & blk_onehot
    b_running = ((new_state == RUNNING) & is_overtake)[..., None] & blk_onehot
    blocker_pos = scen.trigger_pos + 8.0 * heading + 3.5 * left

    act2 = torch.cat([v_activate, b_activate], dim=1)            # (B, 2S, V)
    deact2 = torch.cat([v_deactivate, b_deactivate], dim=1)
    run2 = torch.cat(
        [((new_state == RUNNING) & is_vehicle_scen)[..., None] & veh_onehot,
         b_running],
        dim=1,
    )
    pos2 = torch.cat([primary_pos, blocker_pos], dim=1)
    yaw2 = torch.cat([scen.param[..., 1]] * 2, dim=1)
    spd2 = torch.cat([scen_speed, torch.full_like(scen_speed, BLOCKER_SPEED)], dim=1)

    v_act_any = torch.any(act2, dim=1)
    v_deact_any = torch.any(deact2, dim=1)
    v_run_any = torch.any(run2, dim=1)
    spawn_pos = _select(act2, pos2)
    spawn_yaw = _select(act2, yaw2)
    run_speed = _select(run2, spd2)

    cyc_slot = torch.any(
        ((fire | (new_state == RUNNING)) & is_turning)[..., None] & veh_onehot,
        dim=1,
    )
    new_extent = torch.where(
        (v_act_any & cyc_slot)[..., None],
        torch.tensor(CYCLIST_EXTENT, device=dev),
        traffic.extent,
    )

    new_traffic = TrafficState(
        pos=torch.where(v_act_any[..., None], spawn_pos, traffic.pos),
        yaw=torch.where(v_act_any, spawn_yaw, traffic.yaw),
        speed=torch.where(
            v_act_any, run_speed,
            torch.where(v_deact_any, torch.zeros_like(traffic.speed), traffic.speed),
        ),
        extent=new_extent,
        wp_idx=traffic.wp_idx,
        active=(traffic.active | v_act_any) & ~v_deact_any,
        stop_s=torch.where(v_act_any, torch.zeros_like(traffic.stop_s), traffic.stop_s),
    )
    scripted_mask = v_run_any
    scripted_speed = run_speed

    # ego steering noise for CONTROL_LOSS
    noise_active = torch.any(
        (new_state == RUNNING) & (scen.kind == KIND_CONTROL_LOSS), dim=1
    )
    steer_noise = torch.where(
        noise_active, CONTROL_LOSS_NOISE * steer_normal,
        torch.zeros_like(steer_normal),
    )

    new_scen = ScenarioState(
        kind=scen.kind,
        trigger_pos=scen.trigger_pos,
        state=new_state,
        timer=new_timer,
        actor_idx=scen.actor_idx,
        param=scen.param,
    )
    return new_scen, new_wlk, new_traffic, steer_noise, scripted_mask, scripted_speed


def scenario_tl_override(scen: ScenarioState, tl_pos, tl_yaw, tl_valid):
    """(B, NL) forced light states, -1 = no override: a running
    KIND_TL_MANIPULATOR slot pins every valid light within TL_FORCE_RADIUS
    of its trigger and within 60 degrees of param[1] to param[3]."""
    running = (scen.state == RUNNING) & (scen.kind == KIND_TL_MANIPULATOR)
    d = torch.linalg.norm(
        tl_pos[None, None, :, :] - scen.trigger_pos[:, :, None, :], dim=-1
    )                                                            # (B, S, NL)
    align = (
        torch.abs(wrap_angle(tl_yaw - scen.param[..., 1, None])) < math.pi / 3
    )
    hit = running[..., None] & (d < TL_FORCE_RADIUS) & align & tl_valid
    forced = torch.clamp(scen.param[..., 3], 0.0, 2.0).to(torch.int64)  # (B, S)
    any_hit = torch.any(hit, dim=1)                              # (B, NL)
    slot = torch.argmax(hit.to(torch.int32), dim=1)              # first slot
    return torch.where(any_hit, torch.gather(forced, 1, slot), -1)
