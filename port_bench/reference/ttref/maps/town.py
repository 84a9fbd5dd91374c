"""Static per-town world description as a dataclass of tensors
(counterpart of `thinktwice_tpu/maps/town.py`).

A town is shared by every world of a batch, so its tensors carry no world
axis. Rasters are uint8, tables float32, indices int64 and masks bool.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch



@dataclasses.dataclass(frozen=True)
class TownMap:
    # rasters: row = y pixel, col = x pixel; px = ppm * (world - offset)
    road: torch.Tensor            # (H, W) uint8 0/1
    lane_all: torch.Tensor        # (H, W) uint8 0/1
    lane_broken: torch.Tensor     # (H, W) uint8 0/1
    sidewalk: torch.Tensor        # (H, W) uint8 0/1
    world_offset: torch.Tensor    # (2,) f32 meters
    pixels_per_meter: torch.Tensor  # () f32

    # drivable lane network (traffic NPC routes)
    lane_pts: torch.Tensor        # (L, 2) f32
    lane_yaw: torch.Tensor        # (L,) f32
    lane_next: torch.Tensor       # (L,) i64 successor index
    lane_valid: torch.Tensor      # (L,) bool

    # analytic road geometry (thick segments) for the birdview
    road_segs: torch.Tensor       # (RS, 5) x1, y1, x2, y2, half_width
    road_seg_valid: torch.Tensor  # (RS,) bool
    lane_segs: torch.Tensor       # (LS, 6) x1, y1, x2, y2, half_width, broken
    lane_seg_valid: torch.Tensor  # (LS,) bool

    # traffic lights
    tl_pos: torch.Tensor          # (NL, 2)
    tl_yaw: torch.Tensor          # (NL,)
    tl_stopline: torch.Tensor     # (NL, 2, 2)
    tl_group: torch.Tensor        # (NL,) i64
    tl_slot: torch.Tensor         # (NL,) i64
    tl_nslots: torch.Tensor       # (NL,) i64
    tl_valid: torch.Tensor        # (NL,) bool

    # stop signs
    stop_pos: torch.Tensor        # (NS, 2)
    stop_yaw: torch.Tensor        # (NS,)
    stop_valid: torch.Tensor      # (NS,) bool

    # spawn points (x, y, yaw) and the lane waypoint at each
    spawn: torch.Tensor           # (SP, 3)
    spawn_valid: torch.Tensor     # (SP,) bool
    spawn_wp: torch.Tensor        # (SP,) i64

    def world_to_pixel(self, xy):
        """(..., 2) world meters -> (..., 2) float pixel coords (px, py)."""
        return self.pixels_per_meter * (xy - self.world_offset)

    @property
    def device(self) -> torch.device:
        return self.lane_pts.device

    def to(self, device) -> "TownMap":
        return TownMap(**{f.name: getattr(self, f.name).to(device)
                          for f in dataclasses.fields(TownMap)})


# Light cycle (green 10 s, yellow 3 s, all-red clearance 2 s; junction
# groups alternate which slot is green).
TL_GREEN_S = 10.0
TL_YELLOW_S = 3.0
TL_RED_CLEAR_S = 2.0
TL_SLOT_S = TL_GREEN_S + TL_YELLOW_S + TL_RED_CLEAR_S

TL_GREEN, TL_YELLOW, TL_RED = 0, 1, 2


def traffic_light_states(town: TownMap, t):
    """Light phase at sim time t -> (..., NL) int64 states, where t has the
    shape (...,) (one time per world).

    Each junction group cycles through `nslots` slots of TL_SLOT_S seconds;
    a light is green for the first TL_GREEN_S of its own slot, yellow for the
    next TL_YELLOW_S and red otherwise."""
    t = t[..., None]
    nslots = torch.clamp_min(town.tl_nslots, 1)
    cycle = nslots.to(torch.float32) * TL_SLOT_S
    tmod = torch.remainder(t, cycle)
    slot_now = torch.floor(tmod / TL_SLOT_S).to(torch.int64)
    t_in_slot = tmod - slot_now.to(torch.float32) * TL_SLOT_S
    my_slot = slot_now == town.tl_slot
    state = torch.where(
        my_slot & (t_in_slot < TL_GREEN_S),
        TL_GREEN,
        torch.where(
            my_slot & (t_in_slot < TL_GREEN_S + TL_YELLOW_S), TL_YELLOW, TL_RED
        ),
    )
    return torch.where(town.tl_valid, state, TL_RED)


def pad_rows(a: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    """Pad or truncate the leading axis to n rows."""
    a = np.asarray(a)
    if len(a) >= n:
        return a[:n]
    pad_shape = (n - len(a),) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, a.dtype)], axis=0)


# Route densification (host side, numpy): posed keypoints (x, y, yaw) of a
# route XML through a C1 Hermite spline, the lane-following path without
# OpenDRIVE.
