"""The least time of K2's work on an H100 (frozen from the port's
`chip_smoke.py` `k2_bound`, with the kernel's tile cull in plain PyTorch
from `ops/raycast_cuda.py`, which counts the pairs the kernel tests).
"""

from __future__ import annotations

import torch

from port_bench.counts.peaks import HBM_BYTES_PER_S, flop_per_s

THREADS = 256           # rays a block of the kernel takes without a grid
K2_TILE = (16, 32)      # a block's tile of a grid of rays, rows x cols
# the cull's slack, as the kernel is built with it
CULL_ABS = 0.05         # metres added to every sphere's radius
CULL_REL = 1e-3         # of the distance to the sphere's centre
CULL_COS = 1e-4         # taken off the cone's cos half-angle
CULL_MIN_COS = 0.05     # a wider cone keeps every active box
CULL_MIN_DIR = 1e-3     # so does a tile with a shorter ray
K2_FLOP_PER_PAIR = 45   # float operations of one ray-box slab test
K2_FLOP_PER_CULL = 42   # float operations of one (tile, box) cone-sphere test


def check_grid(n_rays: int, grid) -> None:
    """Raise unless grid (rows, cols) splits n_rays into whole views."""
    if grid is None:
        return
    rows, cols = (int(v) for v in grid)
    if rows <= 0 or cols <= 0 or n_rays % (rows * cols):
        raise ValueError(f"grid {tuple(grid)} does not split {n_rays} rays into views")


def ray_tiles(n_rays: int, grid=None):
    """(T, rays a block) int64: the rays each block of the kernel takes, -1
    where a slot has none. grid None: 256 consecutive rays a block; grid
    (rows, cols): a K2_TILE tile of one view."""
    check_grid(n_rays, grid)
    if grid is None:
        T = -(-n_rays // THREADS)
        ids = torch.arange(T * THREADS).reshape(T, THREADS)
        return torch.where(ids < n_rays, ids, torch.full_like(ids, -1))
    rows, cols = grid
    th, tw = K2_TILE
    views = n_rays // (rows * cols)
    tr, tc = -(-rows // th), -(-cols // tw)
    blk = torch.arange(views * tr * tc)
    view, rem = blk // (tr * tc), blk % (tr * tc)
    tid = torch.arange(th * tw)
    row = (rem // tc)[:, None] * th + tid // tw
    col = (rem % tc)[:, None] * tw + tid % tw
    ids = (view[:, None] * rows + row) * cols + col
    return torch.where((row < rows) & (col < cols), ids, torch.full_like(ids, -1))


def k2_tile_cull_plain(origins, dirs, table, grid=None):
    """The kernel's per-tile cull in plain PyTorch -> (keep (B, T, N) bool,
    ids (T, rays a block)): keep[b, t, j] when box j of world b survives the cull
    of tile t, whose rays are ids[t] (-1: none). Each tile's rays become a
    cone: a ball around the centre of their origins' bounding box and the
    axis of their unit directions with the least cosine to it; a box is kept
    when it is active and its bounding sphere, grown by the ball, CULL_ABS
    and CULL_REL of its distance, meets the cone widened by CULL_COS. A tile
    whose cone is wider than acos(CULL_MIN_COS) or that holds a ray shorter
    than CULL_MIN_DIR keeps every active box. The same formula as the
    kernel's; only its sums round in another order."""
    B, R, _ = origins.shape
    ids = ray_tiles(R, grid).to(origins.device)
    live = ids >= 0
    o = origins[:, ids.clamp_min(0)]                             # (B, T, rays, 3)
    d = dirs[:, ids.clamp_min(0)]
    dn = torch.sqrt((d * d).sum(-1))
    bad = live & ~(dn >= CULL_MIN_DIR)
    use = live & ~bad
    u = torch.where(use[..., None], d / dn[..., None], torch.zeros_like(d))
    big = torch.full_like(o, 3.0e38)
    lo = torch.where(live[..., None], o, big).amin(2)            # (B, T, 3)
    hi = torch.where(live[..., None], o, -big).amax(2)
    s = u.sum(2)
    sn = torch.sqrt((s * s).sum(-1))
    axis = s / sn[..., None]
    cos_i = torch.where(use, (u * axis[:, :, None]).sum(-1), torch.full_like(dn, 3.0e38))
    cos_t = cos_i.amin(2) - CULL_COS                             # (B, T)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    centre = 0.5 * (lo + hi)
    ext = hi - lo
    r = 0.5 * torch.sqrt((ext * ext).sum(-1))
    keep_all = bad.any(2) | ~(sn > 0) | ~(cos_t > CULL_MIN_COS) | ~(r <= 3.0e38)

    p = table[:, None]                                           # (B, 1, N, 9)
    hz = 0.5 * torch.abs(p[..., 6] - p[..., 8])
    rad = torch.sqrt((p[..., 4] ** 2 + p[..., 5] ** 2) / (p[..., 2] ** 2 + p[..., 3] ** 2)
                     + hz * hz)
    v = torch.stack([p[..., 0], p[..., 1], 0.5 * (p[..., 6] + p[..., 8])], -1) \
        - centre[:, :, None]                                     # (B, T, N, 3)
    v2 = (v * v).sum(-1)
    vn = torch.sqrt(v2)
    big_r = rad + r[..., None] + CULL_ABS + CULL_REL * vn
    along = (v * axis[:, :, None]).sum(-1)
    meets = (vn <= big_r) | (along >= cos_t[..., None] * torch.sqrt(v2 - big_r * big_r)
                             - sin_t[..., None] * big_r)
    keep = (p[..., 7] > 0.5) & (keep_all[..., None] | meets)
    return keep, ids


@torch.no_grad()
def k2_bound(inputs) -> dict:
    """The least time of the K2 launches of `inputs`, [(origins (B, R, 3),
    dirs (B, R, 3), table (B, N, 9), grid)], on an H100: the (ray, box)
    pairs that the per-tile cull keeps, each a slab test, plus one
    cone-sphere test for each (tile, box); bytes: rays read once (24 bytes),
    t and idx written once (12), the box tables read once. -> {bound_ms,
    bound_by, pairs, tests, bytes}."""
    pairs = tests = n_bytes = 0
    for o, d, table, grid in inputs:
        B, R, _ = o.shape
        keep, ids = k2_tile_cull_plain(o, d, table, grid)
        pairs += int((keep.sum(-1) * (ids >= 0).sum(-1)).sum())
        tests += keep.numel()
        n_bytes += B * R * (24 + 12) + table.numel() * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (pairs * K2_FLOP_PER_PAIR + tests * K2_FLOP_PER_CULL) / flop_per_s("float32") * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                pairs=pairs, tests=tests, bytes=n_bytes)
