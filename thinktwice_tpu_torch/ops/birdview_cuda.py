"""K1, the birdview tile rasterizer: a hand-written CUDA kernel
(`csrc/birdview.cu`) and its plain PyTorch version (counterpart of
`thinktwice_tpu/ops/birdview_pallas.py`).

1. `build_primitives` flattens every drawable of every world into one table
   of rows [kind, bit, q0..q5] (see the note at the top of the CUDA source).
2. `birdview_bits` ORs `1 << bit` of each covering primitive into an int32
   mask per pixel: the kernel for a CUDA tensor, the plain version for a CPU
   tensor. There is no fallback from one to the other.
3. `decode_bits` turns the mask into the 15-channel float stack.

Bit layout: 0 road, 1 route, 2 lane solid, 3 lane broken, 4+h vehicles
(history h = 0..3), 8+h walkers, 12+3h+s traffic lights (s: 0 green,
1 yellow, 2 red); active stop signs paint the red bit.

The CUDA source is compiled with nvcc for sm_90a at first use (`ops/nvcc.py`)
and loaded with ctypes.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.config import BirdviewConfig
from thinktwice_tpu_torch.maps.town import TL_GREEN, TL_RED, TL_YELLOW, TownMap
from thinktwice_tpu_torch.ops.nvcc import CudaKernel, check_tensor, cf, ci, vp

LANE_BROKEN_VALUE = 120.0 / 255.0
TL_GREEN_VALUE = 80.0 / 255.0
TL_YELLOW_VALUE = 170.0 / 255.0
TL_RED_VALUE = 1.0

ROW = 8
TILE_MARGIN_M = 0.05   # cull margin; far above the rounding of pixel coords
PLAIN_CHUNK = 64       # primitives per step of the plain version
PLAIN_TILE = 48        # pixels a side of the plain version's tiles


def n_bits(cfg: BirdviewConfig) -> int:
    return 12 + 3 * len(cfg.history_idx)


# --------------------------------------------------------------------------
# primitive table


def history_slot(hist, idx: int):
    """(B,) ring slot of history index idx (-1 = latest), clamped to the
    oldest entry held."""
    Hh = hist.veh_active.shape[1]
    clamped = torch.maximum(torch.full_like(hist.count, idx), -hist.count)
    return torch.remainder(hist.ptr + clamped, Hh)


def _seg_rows(a, b, half_width, bit, valid):
    """Rows for thick segments a -> b (B, N, 2)."""
    abx = b[..., 0] - a[..., 0]
    aby = b[..., 1] - a[..., 1]
    denom = torch.clamp_min(abx * abx + aby * aby, 1e-9)
    hw = torch.as_tensor(half_width, dtype=torch.float32, device=a.device)
    bit = torch.as_tensor(bit, dtype=torch.float32, device=a.device)
    q = torch.broadcast_tensors(
        torch.zeros_like(abx), bit, a[..., 0], a[..., 1], abx, aby, denom, hw
    )
    rows = torch.stack(q, dim=-1)
    return torch.where(valid[..., None], rows, _unused(rows))


def _box_rows(pose, bit, valid, scale=1.0, min_ext=0.0):
    """Rows for oriented boxes pose (B, N, 5) = x, y, yaw, ex, ey."""
    ext = torch.clamp_min(pose[..., 3:5] * scale, min_ext)
    yaw = pose[..., 2]
    one = torch.ones_like(yaw)
    rows = torch.stack(
        [one, one * float(bit), pose[..., 0], pose[..., 1], torch.cos(yaw),
         torch.sin(yaw), ext[..., 0], ext[..., 1]],
        dim=-1,
    )
    return torch.where(valid[..., None], rows, _unused(rows))


def _unused(rows):
    out = torch.zeros_like(rows)
    out[..., 1] = -1.0
    return out


def build_primitives(cfg: BirdviewConfig, town: TownMap, hist, route_window,
                     stop_pose=None, stop_active=None):
    """-> (B, NP, 8) float32 primitive table of B worlds. route_window
    (B, n_route_points, 2); hist the worlds' HistoryState; stop_pose
    (B, NS, 5) and stop_active (B, NS) the stop signs to paint."""
    B = route_window.shape[0]
    dev = route_window.device
    bidx = torch.arange(B, device=dev)
    parts = []

    def town_segs(a, b, hw, bit, valid):
        shape = (B,) + tuple(a.shape)
        return _seg_rows(a.expand(shape), b.expand(shape), hw, bit,
                         valid.expand(shape[:2]))

    half_route = cfg.route_thickness / cfg.pixels_per_meter
    parts.append(_seg_rows(
        route_window[:, :-1], route_window[:, 1:], half_route, 1.0,
        torch.ones(route_window[:, 1:, 0].shape, dtype=torch.bool, device=dev),
    ))

    half_tl = cfg.stopline_thickness / cfg.pixels_per_meter
    min_ext = 0.8 if cfg.scale_bbox else 0.0
    for h, idx in enumerate(cfg.history_idx):
        slot = history_slot(hist, idx)
        parts.append(_box_rows(hist.veh_pose[bidx, slot], 4 + h,
                               hist.veh_active[bidx, slot], 1.0, min_ext))
        parts.append(_box_rows(hist.wlk_pose[bidx, slot], 8 + h,
                               hist.wlk_active[bidx, slot],
                               2.0 if cfg.scale_bbox else 1.0, min_ext))
        tls = hist.tl_state[bidx, slot].to(torch.float32)         # (B, NL)
        parts.append(town_segs(
            town.tl_stopline[:, 0], town.tl_stopline[:, 1], half_tl,
            12.0 + 3.0 * h + tls, town.tl_valid,
        ))
        if stop_pose is not None:
            parts.append(_box_rows(stop_pose, 12 + 3 * h + TL_RED, stop_active))

    lane = town.lane_segs
    broken = lane[:, 5] >= 0.5
    for bit, valid in ((2, town.lane_seg_valid & ~broken),
                       (3, town.lane_seg_valid & broken)):
        parts.append(town_segs(lane[:, 0:2], lane[:, 2:4], lane[:, 4], float(bit), valid))
    road = town.road_segs
    parts.append(town_segs(road[:, 0:2], road[:, 2:4], road[:, 4], 0.0,
                           town.road_seg_valid))
    return torch.cat(parts, dim=1).contiguous()


def ego_table(ego_pos, ego_yaw):
    """(B, 4) rows x, y, cos(yaw), sin(yaw)."""
    return torch.stack(
        [ego_pos[:, 0], ego_pos[:, 1], torch.cos(ego_yaw), torch.sin(ego_yaw)],
        dim=-1,
    ).contiguous()


# --------------------------------------------------------------------------
# plain PyTorch version


def pixel_world_coords(cfg: BirdviewConfig, ego):
    """World x, y (B, W*W) of every pixel, row 0 ahead of the ego, in the
    kernel's order of operations."""
    W = cfg.width
    dev = ego.device
    rows = torch.arange(W, dtype=torch.float32, device=dev)[:, None].expand(W, W)
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(W, W)
    # a tensor divisor: PyTorch on the card multiplies by the reciprocal of
    # a Python number divisor, which rounds unlike the kernel's division
    ppm = torch.tensor(cfg.pixels_per_meter, dtype=torch.float32, device=dev)
    a = ((float(W) - float(cfg.pixels_ev_to_bottom) - rows) / ppm).reshape(1, -1)
    b = ((cols - 0.5 * float(W)) / ppm).reshape(1, -1)
    ex, ey, c, s = (ego[:, i, None] for i in range(4))
    wx = ex + a * c + b * (-s)
    wy = ey + a * s + b * c
    return wx, wy


def row_bounds(prims):
    """World-space bounds (x0, x1, y0, y1), each (B, NP), that hold every
    point a row covers: a segment's end points widened by its half width,
    a box's extents turned by its heading."""
    seg = prims[..., 0] < 0.5
    qx, qy, q2, q3, q4, q5 = (prims[..., i] for i in range(2, 8))
    xb, yb = qx + q2, qy + q3
    hx = torch.where(seg, q5, q2.abs() * q4 + q3.abs() * q5)
    hy = torch.where(seg, q5, q3.abs() * q4 + q2.abs() * q5)
    x0 = torch.where(seg, torch.minimum(qx, xb), qx) - hx
    x1 = torch.where(seg, torch.maximum(qx, xb), qx) + hx
    y0 = torch.where(seg, torch.minimum(qy, yb), qy) - hy
    y1 = torch.where(seg, torch.maximum(qy, yb), qy) + hy
    return x0, x1, y0, y1


def _first(mask, rows):
    """Each world's rows where mask holds, first and in their order: ->
    (B, n, ROW) with n the largest count, a world's surplus rows unused."""
    n = int(mask.sum(dim=1).max())
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :n]
    out = torch.gather(rows, 1, order[..., None].expand(-1, -1, ROW))
    return torch.where(torch.gather(mask, 1, order)[..., None], out, _unused(out))


def _seg_cover(wx, wy, p):
    """(B, P, C) coverage of pixels (B, P, 1) by segment rows p (B, 1, C, 8):
    q = x1, y1, abx, aby, denom, half_width."""
    x1, y1, abx, aby, denom, hw = (p[..., i] for i in range(2, 8))
    t = ((wx - x1) * abx + (wy - y1) * aby) / denom
    t = torch.clamp(t, 0.0, 1.0)
    dx = wx - (x1 + t * abx)
    dy = wy - (y1 + t * aby)
    return dx * dx + dy * dy <= hw * hw


def _box_cover(wx, wy, p):
    """(B, P, C) coverage by box rows: q = cx, cy, cos, sin, ex, ey."""
    cx, cy, c, s, bex, bey = (p[..., i] for i in range(2, 8))
    rx = wx - cx
    ry = wy - cy
    lx = rx * c + ry * s
    ly = -rx * s + ry * c
    return (torch.abs(lx) <= bex) & (torch.abs(ly) <= bey)


def birdview_bits_plain(cfg: BirdviewConfig, prims, ego, chunk: int = PLAIN_CHUNK):
    """The plain version of K1: each PLAIN_TILE x PLAIN_TILE tile of pixels
    against every used segment row, then every used box row, whose bounds
    reach the tile (with TILE_MARGIN_M to spare: a row that reaches no
    pixel's position covers none, so leaving it out changes no bit), in
    chunks of rows. The OR over a chunk runs as a product with the one-hot
    of each row's bit, which is exact for 0/1 entries. -> (B, W, W) int32."""
    B = prims.shape[0]
    W = cfg.width
    nb = n_bits(cfg)
    wx, wy = (a.reshape(B, W, W) for a in pixel_world_coords(cfg, ego))
    lo_x, hi_x, lo_y, hi_y = row_bounds(prims)
    used = prims[..., 1] >= 0
    seg = prims[..., 0] < 0.5
    m = TILE_MARGIN_M
    bit_ids = torch.arange(nb, device=prims.device, dtype=torch.float32)
    acc = torch.zeros((B, W, W, nb), dtype=torch.bool, device=prims.device)
    T = PLAIN_TILE
    for r0 in range(0, W, T):
        for c0 in range(0, W, T):
            tx = wx[:, r0:r0 + T, c0:c0 + T].reshape(B, -1)
            ty = wy[:, r0:r0 + T, c0:c0 + T].reshape(B, -1)
            reach = (used & (hi_x >= tx.amin(1, keepdim=True) - m)
                     & (lo_x <= tx.amax(1, keepdim=True) + m)
                     & (hi_y >= ty.amin(1, keepdim=True) - m)
                     & (lo_y <= ty.amax(1, keepdim=True) + m))
            px, py = tx[..., None], ty[..., None]                # (B, P, 1)
            tile = torch.zeros((B, tx.shape[1], nb), dtype=torch.bool, device=prims.device)
            for kind, cover in ((seg, _seg_cover), (~seg, _box_cover)):
                rows = _first(reach & kind, prims)
                for k0 in range(0, rows.shape[1], chunk):
                    p = rows[:, None, k0:k0 + chunk, :]          # (B, 1, C, 8)
                    onehot = (p[:, 0, :, 1, None] == bit_ids).to(torch.float32)  # (B, C, nb)
                    tile |= torch.bmm(cover(px, py, p).to(torch.float32), onehot) > 0.5
            acc[:, r0:r0 + T, c0:c0 + T] = tile.reshape(B, -1, min(T, W - c0), nb)
    weights = torch.bitwise_left_shift(
        torch.ones(nb, dtype=torch.int32, device=prims.device),
        torch.arange(nb, dtype=torch.int32, device=prims.device),
    )
    return (acc.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


# --------------------------------------------------------------------------
# the kernel


K1 = CudaKernel("birdview", "birdview.cu", {
    "tt_birdview_bits": ([vp, ci, ci, vp, vp, ci, cf, cf, cf, vp], ci),
})


def birdview_bits_cuda(cfg: BirdviewConfig, prims, ego):
    """Launch K1 on the current stream -> (B, W, W) int32."""
    B, NP, _ = prims.shape
    check_tensor(prims, "prims", torch.float32, (B, NP, ROW))
    check_tensor(ego, "ego", torch.float32, (B, 4))
    if ego.device != prims.device:
        raise ValueError("prims and ego must lie on the same device")
    lib = K1.library()
    W = cfg.width
    out = torch.empty((B, W, W), dtype=torch.int32, device=prims.device)
    with torch.cuda.device(prims.device):
        stream = torch.cuda.current_stream(prims.device).cuda_stream
        rc = lib.tt_birdview_bits(
            prims.data_ptr(), B, NP, ego.data_ptr(), out.data_ptr(), W,
            float(cfg.pixels_ev_to_bottom), float(cfg.pixels_per_meter),
            TILE_MARGIN_M, stream,
        )
    K1.check(rc)
    K1.launches += 1
    return out


def birdview_bits(cfg: BirdviewConfig, prims, ego):
    """(B, W, W) int32 coverage masks: K1 for tensors on the card, its plain
    version for tensors on the CPU."""
    if prims.device.type == "cpu":
        return birdview_bits_plain(cfg, prims, ego)
    return birdview_bits_cuda(cfg, prims, ego)


def decode_bits(cfg: BirdviewConfig, bits):
    """(B, W, W) int32 -> (B, n_channels, W, W) float stack: road, route,
    lane (broken at 120/255), vehicles, walkers, lights (80, 170, 255)/255
    per history frame, red over yellow over green."""

    def b(n):
        return ((bits >> n) & 1).to(torch.float32)

    H = len(cfg.history_idx)
    c_lane = torch.where(b(3) > 0, LANE_BROKEN_VALUE, b(2))
    veh = [b(4 + h) for h in range(H)]
    wlk = [b(8 + h) for h in range(H)]
    tl = []
    for h in range(H):
        g = b(12 + 3 * h + TL_GREEN)
        y = b(12 + 3 * h + TL_YELLOW)
        r = b(12 + 3 * h + TL_RED)
        tl.append(torch.where(
            r > 0, TL_RED_VALUE,
            torch.where(y > 0, TL_YELLOW_VALUE,
                        torch.where(g > 0, TL_GREEN_VALUE, 0.0)),
        ))
    return torch.stack([b(0), b(1), c_lane, *veh, *wlk, *tl], dim=1)
