"""Privileged BEV raster: the Roach ChauffeurNet observation for a batch of
worlds (counterpart of `birdview_from_state` in
`thinktwice_tpu/sensors/birdview.py`).

Channels (normalized to [0, 1]): 0 road, 1 route, 2 lane (broken lanes at
120/255), 3-6 vehicles and 7-10 walkers at history (-16, -11, -6, -1),
11-14 traffic lights and stop signs (green 80, yellow 170, red 255). The
raster is 192 x 192 px at 5 px/m with the ego 40 px above the bottom edge,
heading up. It goes through K1 (ops/birdview_cuda.py), the counterpart of
the JAX package's `use_pallas=True` path: the kernel on the card, its
plain version on the CPU.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.config import BirdviewConfig
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.ops.birdview_cuda import (
    LANE_BROKEN_VALUE,
    TL_GREEN_VALUE,
    TL_RED_VALUE,
    TL_YELLOW_VALUE,
    birdview_bits,
    build_primitives,
    decode_bits,
    ego_table,
)
from thinktwice_tpu_torch.sim.state import WorldState

STOP_EXTENT = (0.6, 2.8)   # half-sizes of a painted stop-sign box
STOP_RADIUS_M = 30.0       # stop signs paint while the ego is this near

__all__ = [
    "LANE_BROKEN_VALUE", "TL_GREEN_VALUE", "TL_YELLOW_VALUE", "TL_RED_VALUE",
    "birdview_inputs", "birdview_bits_from_state", "birdview_from_state",
    "render_birdview_rgb",
]


def birdview_inputs(cfg: BirdviewConfig, town: TownMap, state: WorldState):
    """-> (prims (B, NP, 8), ego (B, 4)): K1's inputs for every world. The
    route window is the next n_route_points waypoints from the criteria's
    route index; a stop sign paints while the ego is within 30 m of it and
    has not completed its stop."""
    R = state.route.shape[1]
    offs = torch.arange(cfg.n_route_points, device=state.route.device)
    win = torch.clamp(state.criteria.route_idx[:, None] + offs, 0, R - 1)
    route_window = torch.gather(
        state.route[..., :2], 1, win[..., None].expand(-1, -1, 2)
    )

    d_stop = torch.linalg.norm(town.stop_pos - state.ego.pos[:, None], dim=-1)
    stop_active = (
        town.stop_valid & ~state.criteria.stop_has_stopped & (d_stop < STOP_RADIUS_M)
    )
    ns = town.stop_pos.shape[0]
    stop_pose = torch.cat(
        [town.stop_pos, town.stop_yaw[:, None],
         torch.tensor([STOP_EXTENT], device=town.device).expand(ns, 2)],
        dim=-1,
    ).expand(state.n_worlds, ns, 5)

    prims = build_primitives(cfg, town, state.history, route_window,
                             stop_pose=stop_pose, stop_active=stop_active)
    return prims, ego_table(state.ego.pos, state.ego.yaw)


def birdview_bits_from_state(cfg: BirdviewConfig, town: TownMap,
                             state: WorldState):
    """(B, W, W) int32 coverage masks of every world through K1."""
    prims, ego = birdview_inputs(cfg, town, state)
    return birdview_bits(cfg, prims, ego)


def birdview_from_state(cfg: BirdviewConfig, town: TownMap, state: WorldState):
    """(B, 15, W, W) float observation of every world through K1."""
    return decode_bits(cfg, birdview_bits_from_state(cfg, town, state))


def render_birdview_rgb(cfg: BirdviewConfig, masks, ego_extent=None):
    """The ObsManager's debug RGB image composed from the channel stack
    (chauffeurnet.py:143-166 'rendered', the history tints faded). masks
    (..., C, W, W) in [0, 1] -> (..., W, W, 3) float32 RGB in [0, 1]; with
    ego_extent (half-length, half-width in m), the ego box in white at the
    canonical position."""
    W = cfg.width
    img = torch.zeros(masks.shape[:-3] + (W, W, 3), device=masks.device)

    def paint(img, mask, color, alpha=1.0):
        c = torch.tensor(color, dtype=torch.float32, device=masks.device) / 255.0
        return torch.where(mask[..., None] > 0.1, c * alpha, img)

    img = paint(img, masks[..., 0, :, :], (83, 87, 83))         # road (ALUMINIUM_5)
    img = paint(img, masks[..., 1, :, :], (136, 138, 133))      # route (ALUMINIUM_3)
    img = paint(img, masks[..., 2, :, :], (255, 0, 255))        # lanes (MAGENTA)
    n_hist = len(cfg.history_idx)
    for i in range(n_hist):
        fade = 1.0 - 0.2 * (n_hist - 1 - i)
        img = paint(img, masks[..., 3 + i, :, :], (0, 0, 255), fade)             # vehicles
        img = paint(img, masks[..., 3 + n_hist + i, :, :], (0, 255, 255), fade)  # walkers
        tl = masks[..., 3 + 2 * n_hist + i, :, :]
        img = paint(img, (tl > 0.25) & (tl < 0.4), (0, 255, 0), fade)      # green
        img = paint(img, (tl > 0.6) & (tl < 0.75), (255, 255, 0), fade)    # yellow
        img = paint(img, tl > 0.9, (255, 0, 0), fade)                      # red
    if ego_extent is not None:
        r0 = W - cfg.pixels_ev_to_bottom
        ex = int(float(ego_extent[0]) * cfg.pixels_per_meter)
        ey = int(float(ego_extent[1]) * cfg.pixels_per_meter)
        img[..., r0 - ex:r0 + ex, W // 2 - ey:W // 2 + ey, :] = 1.0
    return img
