"""The least time of K1's work on an H100 (frozen from the port's
`chip_smoke.py` `k1_bound`, with the two plain helpers it used from
`ops/birdview_cuda.py`).

Bytes: the primitive and ego tables read once, the (B, W, W) int32 masks
written once. Operations: every pixel's world coordinates plus one coverage
test for each (pixel, primitive) pair whose primitive's bounding box holds
the pixel, counted on these inputs. The bound is the larger of the two
times.
"""

from __future__ import annotations

import torch

from port_bench.counts.peaks import HBM_BYTES_PER_S, flop_per_s

K1_FLOP_PER_PAIR = 15      # float operations of one pixel-primitive test
K1_FLOP_PER_PIXEL = 8      # the pixel's world coordinates


def pixel_world_coords(width: int, pixels_ev_to_bottom: int, pixels_per_meter: float, ego):
    """World x, y (B, W*W) of every pixel, row 0 ahead of the ego."""
    W = width
    dev = ego.device
    rows = torch.arange(W, dtype=torch.float32, device=dev)[:, None].expand(W, W)
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(W, W)
    ppm = torch.tensor(pixels_per_meter, dtype=torch.float32, device=dev)
    a = ((float(W) - float(pixels_ev_to_bottom) - rows) / ppm).reshape(1, -1)
    b = ((cols - 0.5 * float(W)) / ppm).reshape(1, -1)
    ex, ey, c, s = (ego[:, i, None] for i in range(4))
    return ex + a * c + b * (-s), ey + a * s + b * c


def row_bounds(prims):
    """World-space bounds (x0, x1, y0, y1), each (B, NP), that hold every
    point a row covers: a segment's ends widened by its half width, a box's
    extents turned by its heading."""
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


@torch.no_grad()
def k1_bound(width: int, pixels_ev_to_bottom: int, pixels_per_meter: float, prims, ego) -> dict:
    """-> {bound_ms, bound_by, pairs, bytes, flops} of one launch on prims
    (B, NP, 8) and ego (B, 4)."""
    B, NP, _ = prims.shape
    wx, wy = pixel_world_coords(width, pixels_ev_to_bottom, pixels_per_meter, ego)
    wx, wy = wx[..., None], wy[..., None]
    x0, x1, y0, y1 = row_bounds(prims)
    used = prims[..., 1] >= 0
    pairs = 0
    for k0 in range(0, NP, 64):
        k = slice(k0, k0 + 64)
        inside = ((wx >= x0[:, None, k]) & (wx <= x1[:, None, k]) & (wy >= y0[:, None, k])
                  & (wy <= y1[:, None, k]) & used[:, None, k])
        pairs += int(inside.sum())
    n_bytes = prims.numel() * 4 + ego.numel() * 4 + B * width * width * 4
    flops = pairs * K1_FLOP_PER_PAIR + B * width * width * K1_FLOP_PER_PIXEL
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s("float32") * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                pairs=pairs, bytes=n_bytes, flops=flops)
