"""Lane-graph routing and route planning over an imported town's road
raster (counterpart of `thinktwice_tpu/maps/router.py`, numpy and `heapq`
on the host, as the JAX package's are).

- `build_graph`, `plan_route`, `generate_random_routes`: A* over a
  TownMap's lane network. Nodes are the valid lane waypoints; edges are the
  successor links plus lane-change and junction links between nearby,
  heading-aligned waypoints of different lanes. The TownMap's tensors are
  read to numpy once.
- `RasterPlanner`: A* over 2 m cells of an imported town's road raster,
  then rightmost-lane placement and snaps through distance-transform tables
  (`scipy.ndimage`, imported in the functions that use it). It is built
  from the road raster, its world offset and its pixels per metre;
  `RasterPlanner.from_h5` reads those from a town H5 (`maps.compile_h5.
  read_town_h5`). `raster_planner` keeps one planner per H5 path.
"""

from __future__ import annotations

import heapq

import numpy as np

from thinktwice_tpu_torch.maps.town import TownMap, densify_polyline, pad_rows


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class LaneGraph:
    def __init__(self, pts: np.ndarray, yaw: np.ndarray, adj: list[list[tuple[int, float]]]):
        self.pts = pts
        self.yaw = yaw
        self.adj = adj

    def nearest(self, xy) -> int:
        return int(np.argmin(np.linalg.norm(self.pts - np.asarray(xy)[None], axis=1)))


def build_graph(town: TownMap, link_radius: float = 6.0,
                heading_tol: float = np.deg2rad(75.0)) -> LaneGraph:
    valid = _np(town.lane_valid)
    pts = _np(town.lane_pts)[valid]
    yaw = _np(town.lane_yaw)[valid]
    nxt_all = _np(town.lane_next)
    # remap successor indices into the compacted valid set
    remap = -np.ones(len(valid), int)
    remap[np.nonzero(valid)[0]] = np.arange(valid.sum())
    nxt = remap[nxt_all[valid]]

    n = len(pts)
    adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for i in range(n):
        j = int(nxt[i])
        if j >= 0:
            adj[i].append((j, float(np.linalg.norm(pts[j] - pts[i]))))

    # cross links: nearby waypoints with compatible heading (lane changes and
    # junction hops). Grid hash for O(n) neighborhood queries.
    cell = link_radius
    grid: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(pts):
        grid.setdefault((int(p[0] // cell), int(p[1] // cell)), []).append(i)
    for i, p in enumerate(pts):
        cx, cy = int(p[0] // cell), int(p[1] // cell)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for j in grid.get((cx + dx, cy + dy), ()):
                    if j == i or j == int(nxt[i]):
                        continue
                    d = float(np.linalg.norm(pts[j] - pts[i]))
                    if d > link_radius or d < 0.5:
                        continue
                    dyaw = abs(np.arctan2(np.sin(yaw[j] - yaw[i]),
                                          np.cos(yaw[j] - yaw[i])))
                    if dyaw < heading_tol:
                        # the target must lie roughly ahead of i
                        fwd = np.asarray([np.cos(yaw[i]), np.sin(yaw[i])])
                        if np.dot(pts[j] - pts[i], fwd) > 0.0:
                            adj[i].append((j, d * 1.5))  # mild lane-change cost
    return LaneGraph(pts, yaw, adj)


def plan_route(graph: LaneGraph, start_xy, goal_xy) -> np.ndarray | None:
    """A* shortest path -> (K, 3) polyline (x, y, yaw) or None."""
    s = graph.nearest(start_xy)
    g = graph.nearest(goal_xy)
    goal_p = graph.pts[g]

    dist = {s: 0.0}
    prev: dict[int, int] = {}
    pq = [(float(np.linalg.norm(graph.pts[s] - goal_p)), s)]
    visited = set()
    while pq:
        _, u = heapq.heappop(pq)
        if u == g:
            break
        if u in visited:
            continue
        visited.add(u)
        for v, w in graph.adj[u]:
            nd = dist[u] + w
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                prev[v] = u
                h = float(np.linalg.norm(graph.pts[v] - goal_p))
                heapq.heappush(pq, (nd + h, v))
    if g not in dist:
        return None
    path = [g]
    while path[-1] != s:
        path.append(prev[path[-1]])
    path.reverse()
    pts = graph.pts[path]
    yaw = graph.yaw[path]
    return np.concatenate([pts, yaw[:, None]], axis=1).astype(np.float32)


class RasterPlanner:
    """A* route interpolation over an imported town's road raster.

    ≡ interpolate_trajectory (leaderboard/utils/route_manipulation.py:21-160):
    the reference densifies route-XML keypoints by running GlobalRoutePlanner
    A* over the OpenDRIVE lane graph, so the dense route follows actual roads.
    Imported towns carry no lane topology — only the pre-baked H5 rasters —
    so here the A* runs over a coarsened drivable-cell grid (2 m cells), with
    an edge-distance penalty that keeps the path near the road center, then a
    lane-positioning pass that marches to the road edges along the local
    normal and places each point at the rightmost-lane center (right-hand
    traffic, lane half-width 1.75 m) so opposing-direction routes — and the
    NPC lane chains compile_town derives from them — occupy physically
    separate lanes instead of sharing the road-center line.

    Without this, cubic-Hermite densification between sparse keypoints cuts
    off-road: measured on Town05, 0.2-8% of eval-route points (runs up to
    40 m) and ~41% of the 2-keypoint training-bank routes.
    """

    def __init__(self, road: np.ndarray, offset, ppm: float, cell_m: float = 2.0):
        """road (H, W) uint8 raster (row = y pixel), offset (2,) world
        metres of pixel (0, 0), ppm pixels per metre."""
        from scipy import ndimage

        road = np.asarray(road, np.uint8)
        self.offset = np.asarray(offset, np.float64)
        self.ppm = float(ppm)
        ds = max(int(round(cell_m * self.ppm)), 1)
        h, w = (road.shape[0] // ds) * ds, (road.shape[1] // ds) * ds
        blocks = road[:h, :w].reshape(h // ds, ds, w // ds, ds)
        self.drivable = blocks.mean(axis=(1, 3)) >= 0.25
        self.cell_m = ds / self.ppm
        # meters from each drivable cell to the nearest road edge
        self.edge_m = (
            ndimage.distance_transform_edt(self.drivable) * self.cell_m
        )
        # fine-raster snap table: nearest on-road pixel for every pixel
        # (cell centers of 25%-road cells can themselves be off-road; the
        # final dense route snaps through this to land exactly on the road)
        self._road_fine = road > 0
        # fine edge clearance in meters (the coarse edge_m cannot resolve
        # below one 2 m cell, so sub-cell clearance thresholds need this)
        self._edge_fine_m = (
            ndimage.distance_transform_edt(self._road_fine) / self.ppm
        ).astype(np.float32)
        # snap TARGETS need real clearance, not bare on-road membership: the
        # nearest road pixel to an off-road point is the road/curb boundary
        # pixel itself, and a route point there parks the 1.06 m-half-width
        # ego on the sidewalk (measured: route-0 had stretches at 0.0 m from
        # the sidewalk -> repeated layout collisions under perfect tracking)
        clear = self._edge_fine_m >= 1.5
        if not clear.any():
            clear = self._road_fine
        _, self._snap_idx = ndimage.distance_transform_edt(
            ~clear, return_indices=True
        )
        self._snap_idx = self._snap_idx.astype(np.int32)
        # wider-clearance snap table for TURNS: a turning box sweeps its
        # half-diagonal (2.67 m), not its half-width — corner clips happened
        # with the ego within 1 m of a route that itself had 1.1-1.5 m
        # clearance (measured route-0: every layout hit at turn_5m > 10 deg)
        clear2 = self._edge_fine_m >= 2.0
        if not clear2.any():
            clear2 = clear
        _, self._snap_idx2 = ndimage.distance_transform_edt(
            ~clear2, return_indices=True
        )
        self._snap_idx2 = self._snap_idx2.astype(np.int32)

    @classmethod
    def from_h5(cls, h5_path: str, cell_m: float = 2.0, read=None) -> "RasterPlanner":
        """The planner of a town H5's road raster. read: path -> the
        rasters (maps.compile_h5.read_town_h5 unless given)."""
        if read is None:
            from thinktwice_tpu_torch.maps.compile_h5 import read_town_h5 as read

        r = read(h5_path)
        return cls(r["road"], r["world_offset"], r["pixels_per_meter"], cell_m)

    # --- coordinate helpers ------------------------------------------------
    def _to_cell(self, xy) -> tuple[int, int]:
        p = (np.asarray(xy, np.float64) - self.offset) * self.ppm
        c = p / (self.cell_m * self.ppm)
        return int(c[1]), int(c[0])  # (row, col)

    def _to_world(self, rc: np.ndarray) -> np.ndarray:
        """(K, 2) cell (row, col) -> (K, 2) world xy at cell centers."""
        rc = np.asarray(rc, np.float64) + 0.5
        return rc[:, ::-1] * self.cell_m + self.offset[None]

    def _snap(self, rc: tuple[int, int], radius_cells: int = 8):
        """Nearest drivable cell (the keypoint may round off-road)."""
        r, c = rc
        h, w = self.drivable.shape
        r = min(max(r, 0), h - 1)
        c = min(max(c, 0), w - 1)
        if self.drivable[r, c]:
            return (r, c)
        rr = radius_cells
        r0, r1 = max(r - rr, 0), min(r + rr + 1, h)
        c0, c1 = max(c - rr, 0), min(c + rr + 1, w)
        win = self.drivable[r0:r1, c0:c1]
        if not win.any():
            return None
        cand = np.argwhere(win)
        d = np.linalg.norm(cand - np.asarray([[r - r0, c - c0]]), axis=1)
        k = int(np.argmin(d))
        return (int(cand[k, 0]) + r0, int(cand[k, 1]) + c0)

    def _astar(self, start, goal) -> np.ndarray | None:
        """(K, 2) cell path or None. Step cost = distance x (1 + center
        penalty), heuristic = euclidean — keeps the path near road center."""
        h, w = self.drivable.shape
        steps = [(-1, -1, 1.41421), (-1, 0, 1.0), (-1, 1, 1.41421),
                 (0, -1, 1.0), (0, 1, 1.0),
                 (1, -1, 1.41421), (1, 0, 1.0), (1, 1, 1.41421)]
        gp = np.asarray(goal, np.float64)
        dist = {start: 0.0}
        prev: dict[tuple[int, int], tuple[int, int]] = {}
        pq = [(float(np.linalg.norm(np.asarray(start, np.float64) - gp)), start)]
        visited = set()
        while pq:
            _, u = heapq.heappop(pq)
            if u == goal:
                path = [u]
                while path[-1] != start:
                    path.append(prev[path[-1]])
                path.reverse()
                return np.asarray(path, np.int64)
            if u in visited:
                continue
            visited.add(u)
            du = dist[u]
            for dr, dc, sc in steps:
                v = (u[0] + dr, u[1] + dc)
                if not (0 <= v[0] < h and 0 <= v[1] < w):
                    continue
                if not self.drivable[v]:
                    continue
                pen = 0.6 * max(0.0, 2.5 - self.edge_m[v]) / 2.5
                nd = du + sc * (1.0 + pen)
                if nd < dist.get(v, np.inf):
                    dist[v] = nd
                    prev[v] = u
                    hh = float(np.hypot(v[0] - gp[0], v[1] - gp[1]))
                    heapq.heappush(pq, (nd + hh, v))
        return None

    def _on_road(self, xy: np.ndarray, min_edge_m: float = 0.1) -> np.ndarray:
        """(K,) bool: world points on the road with >= min_edge_m of fine-
        raster clearance to the road edge."""
        p = (np.asarray(xy, np.float64) - self.offset[None]) * self.ppm
        r = np.clip(p[:, 1].astype(int), 0, self._road_fine.shape[0] - 1)
        c = np.clip(p[:, 0].astype(int), 0, self._road_fine.shape[1] - 1)
        return self._road_fine[r, c] & (self._edge_fine_m[r, c] >= min_edge_m)

    def _lane_position(self, poly: np.ndarray) -> np.ndarray:
        """Shift each path point onto the rightmost-lane center.

        The round-2 'keypoint-learned median offset' was a no-op: plan()
        anchors every keypoint onto the path (leg endpoints), so the measured
        keypoint offsets were identically zero and every route ran down the
        A* road-center line — opposing-direction routes, and the NPC lane
        chains compile_town derives from them, coincided (measured on Town05:
        6,405 antiparallel lane-point pairs within 1.2 m → head-on NPC
        collisions and chronic congestion).

        Here: march along the local road normal to both edges; on
        corridor-like road (4.2 m < width < 20 m, both edges found) place the
        point LANE_HALF = 1.75 m from the vehicle-right edge. Vehicle-right
        is (-hd_y, +hd_x) in the H5 world frame — right-hand traffic,
        verified against the Town05 eval-route keypoints' lane positions.
        Single-lane roads (width < 4.6 m) keep the center. Junction aprons
        (wide/unbounded marches) get weight 0, and the shift is arc-length
        averaged with those zeros so lane entries blend in smoothly.
        """
        d = np.gradient(poly, axis=0)
        hd = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        right = np.stack([-hd[:, 1], hd[:, 0]], axis=1)
        max_m, step = 16.0, 0.25
        ks = np.arange(step, max_m + step, step)

        def _edge_dist(dirs: np.ndarray) -> np.ndarray:
            q = poly[:, None, :] + ks[None, :, None] * dirs[:, None, :]
            pix = (q - self.offset[None, None]) * self.ppm
            r = np.clip(pix[..., 1].astype(int), 0,
                        self._road_fine.shape[0] - 1)
            c = np.clip(pix[..., 0].astype(int), 0,
                        self._road_fine.shape[1] - 1)
            on = self._road_fine[r, c]
            first_off = np.argmin(on, axis=1)  # 0 when all on-road
            return np.where(on.all(axis=1), max_m + step, ks[first_off])

        re_ = _edge_dist(right)
        le_ = _edge_dist(-right)
        w = re_ + le_
        lane_half = 1.75
        corridor = (w > 4.2) & (w < 20.0) & (re_ <= max_m) & (le_ <= max_m)
        target = np.where(w < 2 * lane_half + 1.1, w / 2.0, lane_half)
        shift = np.where(corridor, np.clip(re_ - target, -8.0, 8.0), 0.0)
        wgt = corridor.astype(np.float64)
        win = min(7, len(poly)) | 1  # odd
        ker = np.ones(win) / win
        num = np.convolve(shift * wgt, ker, mode="same")
        den = np.convolve(wgt, ker, mode="same")
        # dividing by max(den, 1) counts junction points as zero shift →
        # the lane offset tapers to nothing entering a junction
        shift_sm = num / np.maximum(den, 1.0)
        shifted = poly + shift_sm[:, None] * right
        ok = self._on_road(shifted, min_edge_m=1.0)
        return np.where(ok[:, None], shifted, poly)

    def plan(
        self,
        keypoints_xy: np.ndarray,
        keypoints_yaw_deg: np.ndarray | None = None,
        spacing: float = 1.0,
        max_len: int | None = None,
    ) -> np.ndarray:
        """Dense on-road route through the posed keypoints -> (N, 3)
        (x, y, yaw_rad), same contract as maps.town.interpolate_route.

        keypoints_yaw_deg is accepted for interface parity with
        interpolate_route but unused: the lane-positioning pass places the
        path on the driving side, and headings come from the planned path."""
        kp = np.asarray(keypoints_xy, np.float64)
        legs: list[np.ndarray] = []
        for i in range(len(kp) - 1):
            a, b = self._snap(self._to_cell(kp[i])), self._snap(
                self._to_cell(kp[i + 1]))
            path = self._astar(a, b) if (a and b) else None
            if path is None or len(path) < 2:
                # disconnected raster (rare): straight fallback for this leg
                legs.append(np.stack([kp[i], kp[i + 1]]))
                continue
            pts = self._to_world(path)
            # anchor exact keypoint positions at the leg ends
            pts[0], pts[-1] = kp[i], kp[i + 1]
            legs.append(pts)
        if not legs:
            raise ValueError("route needs >= 2 keypoints")
        poly = np.concatenate(
            [legs[0]] + [leg[1:] for leg in legs[1:]], axis=0
        )

        # smooth the jagged 8-connected path (keep endpoints; revert any
        # point the smoothing pushes off-road)
        for _ in range(2):
            sm = poly.copy()
            sm[1:-1] = (poly[:-2] + poly[1:-1] + poly[2:]) / 3.0
            ok = self._on_road(sm)
            poly = np.where(ok[:, None], sm, poly)

        poly = self._lane_position(poly)

        dense = densify_polyline(poly, spacing=spacing).astype(np.float64)
        # exact snap at full raster resolution: points off-road OR hugging the
        # curb (< 1.15 m fine clearance) move to the nearest pixel with >= 1.5 m
        # clearance (pushes in ~0.2-2 m, keeps the path shape)
        pix = (dense - self.offset[None]) * self.ppm
        r = np.clip(pix[:, 1].astype(int), 0, self._road_fine.shape[0] - 1)
        c = np.clip(pix[:, 0].astype(int), 0, self._road_fine.shape[1] - 1)
        # local turn magnitude (heading change over ~8 m) decides the
        # clearance the ego's swept box needs at each point
        n_ = len(dense)
        i0 = np.maximum(np.arange(n_) - 4, 0)
        i1 = np.minimum(np.arange(n_) + 4, n_ - 1)
        back = dense - dense[i0]
        fwd_ = dense[i1] - dense
        hdg_b = np.arctan2(back[:, 1], back[:, 0])
        hdg_f = np.arctan2(fwd_[:, 1], fwd_[:, 0])
        turn = np.abs(np.arctan2(np.sin(hdg_f - hdg_b), np.cos(hdg_f - hdg_b)))
        turning = turn > 0.15
        turning[:5] = turning[-5:] = False   # degenerate end windows
        # dilate so a whole turn snaps against ONE clearance table — a
        # turning/straight boundary otherwise snaps adjacent points to
        # different targets and leaves a >60° heading kink at the seam
        from scipy import ndimage as _ndi

        turning = _ndi.binary_dilation(turning, iterations=4)
        edge_here = self._edge_fine_m[r, c]
        need_fix = ~self._road_fine[r, c] | (edge_here < 1.15) | (
            turning & (edge_here < 1.7)
        )
        nr = np.where(turning, self._snap_idx2[0, r, c],
                      self._snap_idx[0, r, c]).astype(np.float64)
        nc = np.where(turning, self._snap_idx2[1, r, c],
                      self._snap_idx[1, r, c]).astype(np.float64)
        snapped = np.stack([nc, nr], axis=1) / self.ppm + self.offset[None]
        dense = np.where(need_fix[:, None], snapped, dense)
        # the snap leaves ~meter-scale kinks; relax them where the smoothed
        # point keeps clearance — or at least does not lose any (so kinks
        # in tight spots still smooth instead of surviving as >60° heading
        # jumps in the final route)
        for _ in range(4):
            pix0 = (dense - self.offset[None]) * self.ppm
            r0 = np.clip(pix0[:, 1].astype(int), 0, self._road_fine.shape[0] - 1)
            c0 = np.clip(pix0[:, 0].astype(int), 0, self._road_fine.shape[1] - 1)
            edge_cur = self._edge_fine_m[r0, c0]
            sm = dense.copy()
            sm[2:-2] = (dense[:-4] + dense[1:-3] + dense[2:-2]
                        + dense[3:-1] + dense[4:]) / 5.0
            pix = (sm - self.offset[None]) * self.ppm
            r = np.clip(pix[:, 1].astype(int), 0, self._road_fine.shape[0] - 1)
            c = np.clip(pix[:, 0].astype(int), 0, self._road_fine.shape[1] - 1)
            edge_sm = self._edge_fine_m[r, c]
            ok = self._road_fine[r, c] & (
                (edge_sm >= np.where(turning, 1.6, 1.0))
                | (edge_sm >= edge_cur - 0.05)
            )
            dense = np.where(ok[:, None], sm, dense)
        # targeted hairpin removal: any remaining >35° heading jump between
        # successive points is a snap seam no vehicle can track (turn radius
        # < 1 m); smooth a window around it accepting ANY on-road position —
        # a momentary clearance dip beats an untrackable kink
        for _ in range(6):
            seg_ = np.diff(dense, axis=0)
            hd_ = np.arctan2(seg_[:, 1], seg_[:, 0])
            dh_ = np.abs(np.arctan2(np.sin(np.diff(hd_)), np.cos(np.diff(hd_))))
            kinks = np.nonzero(dh_ > 0.6)[0] + 1
            if not len(kinks):
                break
            win = np.zeros(len(dense), bool)
            for k in kinks:
                win[max(k - 3, 0): k + 4] = True
            win[0] = win[-1] = False
            sm = dense.copy()
            sm[1:-1] = (dense[:-2] + dense[1:-1] + dense[2:]) / 3.0
            pix = (sm - self.offset[None]) * self.ppm
            r = np.clip(pix[:, 1].astype(int), 0, self._road_fine.shape[0] - 1)
            c = np.clip(pix[:, 0].astype(int), 0, self._road_fine.shape[1] - 1)
            ok = win & self._road_fine[r, c]
            dense = np.where(ok[:, None], sm, dense)

        # the snap/smooth passes bunch some points onto shared pixels, which
        # turns finite-difference headings into noise — resample to uniform
        # arc length before computing yaw, then pull any interpolated point
        # that cut an off-road chord back onto the road
        dense = densify_polyline(dense, spacing=spacing).astype(np.float64)
        pix = (dense - self.offset[None]) * self.ppm
        r = np.clip(pix[:, 1].astype(int), 0, self._road_fine.shape[0] - 1)
        c = np.clip(pix[:, 0].astype(int), 0, self._road_fine.shape[1] - 1)
        off = ~self._road_fine[r, c]
        nr = self._snap_idx[0, r, c].astype(np.float64)
        nc = self._snap_idx[1, r, c].astype(np.float64)
        dense = np.where(
            off[:, None],
            np.stack([nc, nr], axis=1) / self.ppm + self.offset[None],
            dense,
        )
        # the pull-back jitters points near convex curb corners; relax the
        # neighborhoods (on-road acceptance only) so headings stay smooth
        win = _ndi.binary_dilation(off, iterations=3)
        win[0] = win[-1] = False
        for _ in range(3):
            sm = dense.copy()
            sm[1:-1] = (dense[:-2] + dense[1:-1] + dense[2:]) / 3.0
            pix = (sm - self.offset[None]) * self.ppm
            r = np.clip(pix[:, 1].astype(int), 0, self._road_fine.shape[0] - 1)
            c = np.clip(pix[:, 0].astype(int), 0, self._road_fine.shape[1] - 1)
            ok = win & self._road_fine[r, c]
            dense = np.where(ok[:, None], sm, dense)

        # clearance restoration: the hairpin/pull-back passes above accept
        # bare on-road positions, which can drag a turn back against the curb
        # (measured on Town05 Long route 9: final clearance dipped to 0.28 m
        # where the turn snap had placed 2.0 m — a perfectly-tracked ego box
        # still penetrated 0.36 m there). Push low-clearance points up the
        # distance-transform gradient, projected onto the local NORMAL so the
        # path shape/tangent is preserved (no new kinks), accepting only
        # on-road moves.
        n = len(dense)
        i0 = np.maximum(np.arange(n) - 4, 0)
        i1 = np.minimum(np.arange(n) + 4, n - 1)
        back = dense - dense[i0]
        fwd_ = dense[i1] - dense
        hdg_b = np.arctan2(back[:, 1], back[:, 0])
        hdg_f = np.arctan2(fwd_[:, 1], fwd_[:, 0])
        turn = np.abs(np.arctan2(np.sin(hdg_f - hdg_b), np.cos(hdg_f - hdg_b)))
        target = np.where(turn > 0.15, 1.8, 1.3)
        eh, ew = self._edge_fine_m.shape
        for _ in range(8):
            pix = (dense - self.offset[None]) * self.ppm
            r = np.clip(pix[:, 1].astype(int), 1, eh - 2)
            c = np.clip(pix[:, 0].astype(int), 1, ew - 2)
            edge_now = self._edge_fine_m[r, c]
            low = edge_now < target
            if not low.any():
                break
            gx = (self._edge_fine_m[r, c + 1]
                  - self._edge_fine_m[r, c - 1]) * 0.5 * self.ppm
            gy = (self._edge_fine_m[r + 1, c]
                  - self._edge_fine_m[r - 1, c]) * 0.5 * self.ppm
            g = np.stack([gx, gy], axis=1)
            g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-6)
            d_ = np.gradient(dense, axis=0)
            t_ = d_ / np.maximum(
                np.linalg.norm(d_, axis=1, keepdims=True), 1e-9
            )
            nvec = np.stack([-t_[:, 1], t_[:, 0]], axis=1)
            push = np.sum(g * nvec, axis=1, keepdims=True) * nvec
            step = np.clip(target - edge_now, 0.0, 0.25)[:, None]
            cand = dense + np.where(low[:, None], push * step, 0.0)
            pixc = (cand - self.offset[None]) * self.ppm
            rc_ = np.clip(pixc[:, 1].astype(int), 0, eh - 1)
            cc_ = np.clip(pixc[:, 0].astype(int), 0, ew - 1)
            ok = self._road_fine[rc_, cc_]
            dense = np.where((low & ok)[:, None], cand, dense)

        # headings from ±3-point central differences (tolerates the ~0.4 m
        # pull-back jitter near curb corners without heading spikes)
        n = len(dense)
        i0 = np.maximum(np.arange(n) - 3, 0)
        i1 = np.minimum(np.arange(n) + 3, n - 1)
        diffs = dense[i1] - dense[i0]
        yaw = np.arctan2(diffs[:, 1], diffs[:, 0])
        route = np.concatenate([dense, yaw[:, None]], axis=1).astype(np.float32)
        if max_len is not None:
            route = pad_rows(route, max_len, fill=0.0)
            if len(np.asarray(route)) > 0 and max_len > len(dense):
                route[len(dense):] = route[len(dense) - 1]
        return route


_PLANNERS: dict[str, RasterPlanner] = {}


def raster_planner(h5_path: str, read=None) -> RasterPlanner:
    """Cached per-H5 planner (the distance transform is ~0.5 s to build);
    read as RasterPlanner.from_h5 takes it."""
    if h5_path not in _PLANNERS:
        _PLANNERS[h5_path] = RasterPlanner.from_h5(h5_path, read=read)
    return _PLANNERS[h5_path]


def generate_random_routes(
    town: TownMap,
    n_routes: int,
    min_length: float = 100.0,
    max_length: float = 1500.0,
    seed: int = 0,
    max_tries: int = 200,
) -> list[np.ndarray]:
    """Random spawn-pair routes ≡ generate_random_routes.py (spawn pairs
    filtered by planned distance)."""
    graph = build_graph(town)
    spawns = _np(town.spawn)[_np(town.spawn_valid)]
    rng = np.random.RandomState(seed)
    routes = []
    tries = 0
    while len(routes) < n_routes and tries < max_tries:
        tries += 1
        a, b = spawns[rng.randint(len(spawns))], spawns[rng.randint(len(spawns))]
        r = plan_route(graph, a[:2], b[:2])
        if r is None:
            continue
        length = float(np.linalg.norm(np.diff(r[:, :2], axis=0), axis=1).sum())
        if min_length <= length <= max_length:
            routes.append(r)
    return routes
