"""Procedural grid-town generator (counterpart of
`thinktwice_tpu/maps/procedural.py`).

Builds a fully populated `TownMap` (rasters, lane network, lights, stop
signs, spawn points) in numpy and hands it over as tensors on the requested
device: two-lane roads of 3.5 m lanes, signalized intersections, a Manhattan
block layout. The numpy code is a copy of the JAX package's, so both
packages build the same town from the same arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.maps.town import TownMap, pad_rows

LANE_W = 3.5
ROAD_HALF_W = LANE_W  # two lanes
PPM = 5.0


def _raster_canvas(extent_m: float, margin: float = 20.0):
    size_px = int((extent_m + 2 * margin) * PPM)
    offset = np.array([-margin, -margin], np.float32)
    return size_px, offset


def _draw_box(img, offset, p0, p1, half_w):
    """Fill an axis-aligned road rectangle from p0 to p1 (meters) of half-width."""
    lo = np.minimum(p0, p1) - half_w
    hi = np.maximum(p0, p1) + half_w
    x0, y0 = np.floor((lo - offset) * PPM).astype(int)
    x1, y1 = np.ceil((hi - offset) * PPM).astype(int)
    h, w = img.shape
    img[max(y0, 0) : min(y1, h), max(x0, 0) : min(x1, w)] = 1


def _draw_dashes(img, offset, p0, p1, dash=3.0, gap=3.0, px_w=1):
    """Dashed centerline along an axis-aligned segment."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = p1 - p0
    length = np.linalg.norm(d)
    if length < 1e-6:
        return
    u = d / length
    s = 0.0
    h, w = img.shape
    while s < length:
        e = min(s + dash, length)
        a = (p0 + u * s - offset) * PPM
        b = (p0 + u * e - offset) * PPM
        n = max(int(np.linalg.norm(b - a)), 1)
        ts = np.linspace(0, 1, n + 1)
        pts = (a[None] + ts[:, None] * (b - a)[None]).astype(int)
        for px, py in pts:
            if 0 <= py < h and 0 <= px < w:
                img[
                    max(py - px_w, 0) : min(py + px_w + 1, h),
                    max(px - px_w, 0) : min(px + px_w + 1, w),
                ] = 1
        s += dash + gap


def make_grid_town(
    n_blocks: int = 2,
    block: float = 100.0,
    max_lane_pts: int = 2048,
    max_lights: int = 64,
    max_stops: int = 32,
    max_spawn: int = 256,
    max_road_segs: int = 32,
    max_lane_segs: int = 32,
    signalized: bool = True,
    device="cuda",
) -> TownMap:
    """Build an (n_blocks x n_blocks)-block grid town.

    Grid lines at x,y ∈ {0, block, ..., n_blocks*block}. Right-hand traffic:
    on a horizontal road, the +x lane sits at y_center + LANE_W/2; on a
    vertical road, the +y lane at x_center - LANE_W/2 (mirroring CARLA's
    left-handed frame where +y is "south" is irrelevant here — consistency is
    what matters).

    The lane network is a set of closed rectangular loops (one clockwise loop
    per block ring, in the outer lane) so every waypoint has exactly one
    successor and NPCs drive forever. Lights guard each interior intersection.
    """
    extent = n_blocks * block
    size_px, offset = _raster_canvas(extent)

    road = np.zeros((size_px, size_px), np.uint8)
    lane_all = np.zeros_like(road)
    lane_broken = np.zeros_like(road)
    sidewalk = np.zeros_like(road)

    grid = [i * block for i in range(n_blocks + 1)]
    for g in grid:
        # horizontal road y=g, vertical road x=g
        _draw_box(road, offset, np.array([-10.0, g]), np.array([extent + 10.0, g]), ROAD_HALF_W)
        _draw_box(road, offset, np.array([g, -10.0]), np.array([g, extent + 10.0]), ROAD_HALF_W)
        _draw_dashes(lane_broken, offset, [0.0, g], [extent, g])
        _draw_dashes(lane_broken, offset, [g, 0.0], [g, extent])
        # sidewalks as thin strips just outside the road
        _draw_box(sidewalk, offset, np.array([-10.0, g - ROAD_HALF_W - 1.0]),
                  np.array([extent + 10.0, g - ROAD_HALF_W - 0.2]), 0.0)
        _draw_box(sidewalk, offset, np.array([-10.0, g + ROAD_HALF_W + 0.2]),
                  np.array([extent + 10.0, g + ROAD_HALF_W + 1.0]), 0.0)
    lane_all = np.maximum(lane_all, lane_broken)

    # analytic thick-segment geometry for the BEV rasterizer
    road_segs, lane_segs = [], []
    for g in grid:
        road_segs.append((-10.0, g, extent + 10.0, g, ROAD_HALF_W))
        road_segs.append((g, -10.0, g, extent + 10.0, ROAD_HALF_W))
        lane_segs.append((0.0, g, extent, g, 0.25, 1.0))  # broken centerline
        lane_segs.append((g, 0.0, g, extent, 0.25, 1.0))
    road_segs = np.asarray(road_segs, np.float32)
    lane_segs = np.asarray(lane_segs, np.float32)

    # --- lane loops -------------------------------------------------------
    half = LANE_W / 2.0
    spacing = 2.0
    lane_pts, lane_yaw, lane_next = [], [], []

    def add_loop(corners):
        """corners: CCW list of (x, y); emit waypoints around the loop."""
        start = len(lane_pts)
        for i in range(len(corners)):
            p0 = np.asarray(corners[i], np.float64)
            p1 = np.asarray(corners[(i + 1) % len(corners)], np.float64)
            d = p1 - p0
            length = np.linalg.norm(d)
            u = d / length
            yaw = np.arctan2(u[1], u[0])
            n = max(int(length // spacing), 1)
            for k in range(n):
                lane_pts.append(p0 + u * (k * spacing))
                lane_yaw.append(yaw)
                lane_next.append(len(lane_pts))  # provisional: next entry
        lane_next[-1] = start  # close the loop

    # one CCW loop per block, driving on the right side of each bounding road
    for bi in range(n_blocks):
        for bj in range(n_blocks):
            x0, x1 = grid[bi], grid[bi + 1]
            y0, y1 = grid[bj], grid[bj + 1]
            add_loop(
                [
                    (x0 + 0, y0 - half),   # bottom edge heading +x (right lane of y=y0 road)
                    (x1 + half, y0 + 0),   # right edge heading +y (right lane of x=x1 road)
                    (x1 - 0, y1 + half),   # top edge heading -x
                    (x0 - half, y1 - 0),   # left edge heading -y
                ]
            )
    # outer perimeter: one big CCW ring on the outer lanes of the perimeter roads
    add_loop(
        [
            (0.0, -half),
            (extent + half, 0.0),
            (extent, extent + half),
            (-half, extent),
        ]
    )

    lane_pts = np.asarray(lane_pts, np.float32)
    lane_yaw = np.asarray(lane_yaw, np.float32)
    lane_next = np.asarray(lane_next, np.int32)
    n_lane = len(lane_pts)
    lane_valid = np.ones(n_lane, bool)

    # --- traffic lights at interior intersections -------------------------
    tl_pos, tl_yaw, tl_stopline, tl_group, tl_slot, tl_nslots = [], [], [], [], [], []
    if signalized:
        interior = [(gx, gy) for gx in grid[1:-1] for gy in grid[1:-1]]
        # also signalize perimeter-road crossings with interior roads
        for gi, (cx, cy) in enumerate(interior):
            # four approaches: heading +x (from -x side), -x, +y, -y
            setback = ROAD_HALF_W + 2.0
            approaches = [
                ((cx - setback, cy - half), 0.0),        # eastbound, right lane
                ((cx + setback, cy + half), np.pi),      # westbound
                ((cx - half, cy - setback), np.pi / 2),  # northbound
                ((cx + half, cy + setback), -np.pi / 2), # southbound
            ]
            for (px, py), yaw in approaches:
                tl_pos.append((px, py))
                tl_yaw.append(yaw)
                # stop line perpendicular to approach, spanning the lane
                nvec = np.array([-np.sin(yaw), np.cos(yaw)])
                c = np.array([px, py])
                tl_stopline.append((c - nvec * half, c + nvec * half))
                tl_group.append(gi)
                tl_slot.append(0 if abs(np.sin(yaw)) < 0.5 else 1)  # EW=0, NS=1
                tl_nslots.append(2)

    n_tl = len(tl_pos)
    tl_pos = np.asarray(tl_pos, np.float32).reshape(n_tl, 2)
    tl_yaw = np.asarray(tl_yaw, np.float32)
    tl_stopline = np.asarray(tl_stopline, np.float32).reshape(n_tl, 2, 2)
    tl_group = np.asarray(tl_group, np.int32)
    tl_slot = np.asarray(tl_slot, np.int32)
    tl_nslots = np.asarray(tl_nslots, np.int32)

    # --- stop signs at the (unsignalized) perimeter corners ---------------
    # each corner gets one stop per approach direction along the perimeter
    stop_pos, stop_yaw = [], []
    half_l = LANE_W / 2.0
    setb = ROAD_HALF_W + 2.0
    corners = [(0.0, 0.0), (extent, 0.0), (extent, extent), (0.0, extent)]
    approach_of_corner = [
        (0.0, (-setb, -half_l)),          # eastbound into (0,0)... heading +x
        (np.pi / 2, (half_l, -setb)),     # northbound into (extent, 0)
        (np.pi, (setb, half_l)),          # westbound into (extent, extent)
        (-np.pi / 2, (-half_l, setb)),    # southbound into (0, extent)
    ]
    for (cx, cy), (yaw, (ox, oy)) in zip(corners, approach_of_corner):
        stop_pos.append((cx + ox, cy + oy))
        stop_yaw.append(yaw)
    stop_pos = np.asarray(stop_pos, np.float32).reshape(-1, 2)
    stop_yaw = np.asarray(stop_yaw, np.float32)
    n_stop = len(stop_pos)

    # --- spawn points: lane waypoints far from intersections --------------
    sp, sp_wp = [], []
    for i in range(0, n_lane, 8):
        p = lane_pts[i]
        near_junction = any(
            abs(p[0] - g) < 15 and abs(p[1] - g2) < 15 for g in grid for g2 in grid
        )
        if not near_junction:
            sp.append((p[0], p[1], lane_yaw[i]))
            sp_wp.append(i)
    spawn = np.asarray(sp, np.float32).reshape(-1, 3)
    spawn_wp = np.asarray(sp_wp, np.int32)

    device = resolve_device(device)

    def j(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=device)

    n_spawn = len(spawn)
    return TownMap(
        road=j(road),
        lane_all=j(lane_all),
        lane_broken=j(lane_broken),
        sidewalk=j(sidewalk),
        world_offset=j(offset.astype(np.float32)),
        pixels_per_meter=j(np.float32(PPM)),
        lane_pts=j(pad_rows(lane_pts, max_lane_pts)),
        lane_yaw=j(pad_rows(lane_yaw, max_lane_pts)),
        lane_next=j(pad_rows(lane_next, max_lane_pts).astype(np.int32)),
        lane_valid=j(pad_rows(lane_valid, max_lane_pts).astype(bool)),
        tl_pos=j(pad_rows(tl_pos, max_lights)),
        tl_yaw=j(pad_rows(tl_yaw, max_lights)),
        tl_stopline=j(pad_rows(tl_stopline.reshape(n_tl, 4), max_lights).reshape(max_lights, 2, 2)),
        tl_group=j(pad_rows(tl_group, max_lights).astype(np.int32)),
        tl_slot=j(pad_rows(tl_slot, max_lights).astype(np.int32)),
        tl_nslots=j(pad_rows(tl_nslots, max_lights, fill=1).astype(np.int32)),
        tl_valid=j(pad_rows(np.ones(n_tl, bool), max_lights).astype(bool)),
        stop_pos=j(pad_rows(stop_pos, max_stops)),
        stop_yaw=j(pad_rows(stop_yaw, max_stops)),
        stop_valid=j(pad_rows(np.ones(n_stop, bool), max_stops).astype(bool)),
        spawn=j(pad_rows(spawn, max_spawn)),
        spawn_valid=j(pad_rows(np.ones(n_spawn, bool), max_spawn).astype(bool)),
        spawn_wp=j(pad_rows(spawn_wp, max_spawn).astype(np.int32)),
        road_segs=j(pad_rows(road_segs, max_road_segs)),
        road_seg_valid=j(pad_rows(np.ones(len(road_segs), bool), max_road_segs).astype(bool)),
        lane_segs=j(pad_rows(lane_segs, max_lane_segs)),
        lane_seg_valid=j(pad_rows(np.ones(len(lane_segs), bool), max_lane_segs).astype(bool)),
    )


def grid_town_rasters(town: TownMap) -> dict:
    """A town's rasters in the layout of a town H5 (`maps.compile_h5.
    read_town_h5`): road, the lane markings and sidewalk as they are, and a
    stopline raster drawn from the valid traffic-light stop lines, 3 px
    wide. It stands in for an imported town's H5 where none is at hand."""
    ppm = float(town.pixels_per_meter)
    offset = town.world_offset.detach().cpu().numpy().astype(np.float64)
    road = town.road.detach().cpu().numpy().astype(np.uint8)
    stopline = np.zeros_like(road)
    h, w = road.shape
    for (a, b) in town.tl_stopline[town.tl_valid].detach().cpu().numpy().astype(np.float64):
        pa, pb = (a - offset) * ppm, (b - offset) * ppm
        n = max(int(np.ceil(2.0 * np.linalg.norm(pb - pa))), 1)
        for t in np.linspace(0.0, 1.0, n + 1):
            px, py = (pa + t * (pb - pa)).astype(int)
            stopline[max(py - 1, 0):min(py + 2, h), max(px - 1, 0):min(px + 2, w)] = 1
    return {
        "road": road,
        "lane_marking_all": town.lane_all.detach().cpu().numpy().astype(np.uint8),
        "lane_marking_white_broken": town.lane_broken.detach().cpu().numpy().astype(np.uint8),
        "sidewalk": town.sidewalk.detach().cpu().numpy().astype(np.uint8),
        "stopline": stopline,
        "world_offset": offset,
        "pixels_per_meter": ppm,
    }
