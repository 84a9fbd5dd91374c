"""Rollout recorder and metrics log (counterpart of
`thinktwice_tpu/harness/metrics_log.py`).

Recording stacks downsampled WorldState snapshots: `record_rollout` runs a
batch of worlds with a tap every `every` ticks and returns dense (F, B, ...)
arrays of the ego, traffic and walker poses and the criteria counters, the
quantities a simulator's recorder keeps per frame. `MetricsLog` gives the
frame queries of a recorder log over one world's frames (`world_frames`),
and the metric functions are numpy over the frame axis. A rollout is saved
as one .npz (`save` / `load`).
"""

from __future__ import annotations

import numpy as np
import torch

from thinktwice_tpu_torch.parallel.worlds import roll
from thinktwice_tpu_torch.sim.step import StepDraws


@torch.no_grad()
def record_rollout(cfg, town, state, policy_fn, n_steps: int, every: int = 4,
                   draws: list[StepDraws] | None = None,
                   generator: torch.Generator | None = None):
    """Roll B worlds n_steps ticks (policy_fn(cfg, town, state) -> (B, 3)
    every tick), snapshotting every `every` ticks; n_steps // every frames.
    draws, when given, holds each tick's StepDraws; else they come from
    generator. Returns (final_state, frames dict of (F, B, ...) arrays)."""
    taps = []
    ticks = roll(cfg, town, state, policy_fn, (n_steps // every) * every, draws, generator)
    for t, state in enumerate(ticks):
        if (t + 1) % every == 0:
            crit = state.criteria
            taps.append(dict(
                tick=state.tick,
                time_s=state.time_s,
                ego_pos=state.ego.pos, ego_yaw=state.ego.yaw,
                ego_speed=state.ego.speed, ego_control=state.ego.control,
                traffic_pos=state.traffic.pos, traffic_yaw=state.traffic.yaw,
                traffic_speed=state.traffic.speed,
                traffic_active=state.traffic.active,
                walker_pos=state.walkers.pos, walker_active=state.walkers.active,
                route_completion=crit.route_completion,
                n_collision_vehicle=crit.n_collision_vehicle,
                n_collision_static=crit.n_collision_static,
                n_red_light=crit.n_red_light,
                blocked_s=crit.blocked_s,
                done=crit.done,
            ))
    frames = {k: torch.stack([tap[k] for tap in taps]).cpu().numpy() for k in taps[0]}
    return state, frames


def world_frames(frames: dict, b: int) -> dict:
    """One world's (F, ...) frames out of record_rollout's (F, B, ...)."""
    return {k: v[:, b] for k, v in frames.items()}


def save(path: str, frames: dict) -> None:
    np.savez_compressed(path, **frames)


def load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class MetricsLog:
    """Frame queries over one world's recorded frames.

    Actor ids: 0 = ego, 1..V = traffic slots, V+1.. = walker slots."""

    def __init__(self, frames: dict):
        self.f = frames
        self.V = frames["traffic_pos"].shape[1]
        self.W = frames["walker_pos"].shape[1]

    # --- frame bookkeeping ------------------------------------------------
    def get_total_frame_count(self) -> int:
        return len(self.f["tick"])

    def get_elapsed_time(self, frame: int) -> float:
        return float(self.f["time_s"][frame])

    def get_ego_vehicle_id(self) -> int:
        return 0

    def get_actor_ids_with_type_id(self, kind: str):
        if kind.startswith("vehicle"):
            return list(range(1, self.V + 1))
        if kind.startswith("walker"):
            return list(range(self.V + 1, self.V + 1 + self.W))
        return [0]

    def get_actor_alive_frames(self, actor_id: int):
        """(first, last) frame the actor is active (slot-recycled actors
        count alive while their slot is active)."""
        act = self._active_series(actor_id)
        idx = np.nonzero(act)[0]
        if len(idx) == 0:
            return None, None
        return int(idx[0]), int(idx[-1])

    # --- per-frame state --------------------------------------------------
    def _active_series(self, actor_id: int):
        if actor_id == 0:
            return np.ones(self.get_total_frame_count(), bool)
        if actor_id <= self.V:
            return self.f["traffic_active"][:, actor_id - 1]
        return self.f["walker_active"][:, actor_id - self.V - 1]

    def get_actor_transform(self, actor_id: int, frame: int):
        """-> (pos (2,), yaw)."""
        if actor_id == 0:
            return self.f["ego_pos"][frame], float(self.f["ego_yaw"][frame])
        if actor_id <= self.V:
            i = actor_id - 1
            return (self.f["traffic_pos"][frame, i],
                    float(self.f["traffic_yaw"][frame, i]))
        i = actor_id - self.V - 1
        return self.f["walker_pos"][frame, i], 0.0

    def get_all_actor_transforms(self, actor_id: int):
        if actor_id == 0:
            return self.f["ego_pos"], self.f["ego_yaw"]
        if actor_id <= self.V:
            i = actor_id - 1
            return self.f["traffic_pos"][:, i], self.f["traffic_yaw"][:, i]
        i = actor_id - self.V - 1
        return self.f["walker_pos"][:, i], np.zeros(len(self.f["tick"]))

    def get_actor_velocity(self, actor_id: int, frame: int) -> float:
        if actor_id == 0:
            return float(self.f["ego_speed"][frame])
        if actor_id <= self.V:
            return float(self.f["traffic_speed"][frame, actor_id - 1])
        return 0.0

    # --- criteria series ----------------------------------------------------
    def get_criterion_series(self, name: str):
        return self.f[name]


# --- example metrics, vectorized over the frames ----------------------------

def distance_between(log: MetricsLog, id_a: int, id_b: int) -> np.ndarray:
    """Per-frame distance between two actors."""
    pa, _ = log.get_all_actor_transforms(id_a)
    pb, _ = log.get_all_actor_transforms(id_b)
    return np.linalg.norm(pa - pb, axis=-1)


def distance_to_route(log: MetricsLog, route_xy: np.ndarray) -> np.ndarray:
    """Per-frame ego cross-track distance to the dense route (the route
    stands for the lane center)."""
    ego, _ = log.get_all_actor_transforms(0)
    d = np.linalg.norm(ego[:, None, :] - route_xy[None, :, :], axis=-1)
    return d.min(axis=1)
