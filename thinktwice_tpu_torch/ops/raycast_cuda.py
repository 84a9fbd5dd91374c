"""K2, the ray-vs-box intersector: a hand-written CUDA kernel
(`csrc/raycast.cu`) and its plain PyTorch version (counterpart of
`thinktwice_tpu/ops/raycast_pallas.py`).

1. `box_table` turns box poses (B, N, 6 or 7) and their active flags into
   rows [x, y, cos(yaw), sin(yaw), ext_x, ext_y, z_top, active, z_base].
2. `ray_boxes_table` gives the nearest hit of every ray of every world,
   t (B, R) float32 and the box index idx (B, R) int64 (MAX_T and -1 on a
   miss): the kernel for a CUDA tensor, the plain version for a CPU tensor.
   There is no fallback from one to the other. An optional grid (rows,
   cols) says that the R rays are views x rows x cols in row-major order;
   the kernel then culls the boxes once per tile (K2_TILE) of one view,
   else once per 256 consecutive rays. The result does not depend on it.
3. `k2_tile_cull_plain` is the kernel's per-tile cull in plain PyTorch:
   each tile's kept boxes, for the tests (the cull keeps every box a ray of
   the tile hits) and for counting the pairs the kernel tests.

The CUDA source is compiled with nvcc for sm_90a at first use (`ops/nvcc.py`)
and loaded with ctypes.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.ops.nvcc import CudaKernel, check_tensor, ci, vp

MAX_T = 1e6
EPS = 1e-9
ROW = 9
PLAIN_PAIRS = 1 << 24   # (world, ray, box) triples per step of the plain version
THREADS = 256           # threads of a block of the kernel; rays a block without a grid
K2_TILE = (16, 32)      # a block's tile of a grid of rays, rows x cols (2 a thread)
# the cull's slack; the kernel is built with these values
CULL_ABS = 0.05         # metres added to every sphere's radius
CULL_REL = 1e-3         # of the distance to the sphere's centre
CULL_COS = 1e-4         # taken off the cone's cos half-angle
CULL_MIN_COS = 0.05     # a wider cone keeps every active box
CULL_MIN_DIR = 1e-3     # so does a tile with a shorter ray

K2 = CudaKernel("raycast", "raycast.cu", {
    "tt_ray_boxes": ([vp, vp, ci, ci, vp, ci, vp, vp, ci, ci, vp], ci),
}, defines={
    "K2_MAX_T": MAX_T, "K2_EPS": EPS, "K2_THREADS": THREADS,
    "K2_TILE_H": K2_TILE[0], "K2_TILE_W": K2_TILE[1],
    "K2_CULL_ABS": CULL_ABS, "K2_CULL_REL": CULL_REL, "K2_CULL_COS": CULL_COS,
    "K2_CULL_MIN_COS": CULL_MIN_COS, "K2_CULL_MIN_DIR": CULL_MIN_DIR,
})


def box_table(box_pose, box_active):
    """box_pose (B, N, 6) x, y, yaw, ext_x, ext_y, z_top, or (B, N, 7) with a
    trailing z_base; box_active (B, N) -> (B, N, 9) float32 rows."""
    p = box_pose.to(torch.float32)
    z0 = p[..., 6] if p.shape[-1] > 6 else torch.zeros_like(p[..., 5])
    yaw = p[..., 2]
    return torch.stack(
        [p[..., 0], p[..., 1], torch.cos(yaw), torch.sin(yaw), p[..., 3],
         p[..., 4], p[..., 5], box_active.to(torch.float32), z0],
        dim=-1,
    ).contiguous()


def _guard(d):
    return torch.where(torch.abs(d) < EPS, torch.full_like(d, EPS), d)


def ray_boxes_plain(origins, dirs, table, chunk: int | None = None):
    """The plain version of K2: the slab test of every ray against every
    active box, in chunks of rays so that the (rays x boxes) intermediates
    stay small (64 MB each by default). An inactive box is hit by no ray,
    so each world's active boxes are taken first, in their order, and the
    hit's index mapped back. origins, dirs (B, R, 3); table (B, N, 9) ->
    (t (B, R), idx (B, R))."""
    B, R, _ = origins.shape
    active = table[..., 7] > 0.5
    n = int(active.sum(dim=1).max()) if table.shape[1] else 0
    order = torch.argsort((~active).to(torch.int8), dim=1, stable=True)[:, :n]
    table = torch.gather(table, 1, order[..., None].expand(-1, -1, ROW))
    chunk = chunk or max(1, PLAIN_PAIRS // max(1, B * n))
    t_out = torch.full((B, R), MAX_T, dtype=torch.float32, device=origins.device)
    idx_out = torch.full((B, R), -1, dtype=torch.int64, device=origins.device)
    if n == 0:
        return t_out, idx_out
    bx, by, c, s, ex, ey, hz, act, z0 = (table[:, None, :, i] for i in range(ROW))
    for r0 in range(0, R, chunk):
        o = origins[:, r0:r0 + chunk, None, :]
        d = dirs[:, r0:r0 + chunk, None, :]
        rx = o[..., 0] - bx
        ry = o[..., 1] - by
        lx = rx * c + ry * s
        ly = -rx * s + ry * c
        ldx = _guard(d[..., 0] * c + d[..., 1] * s)
        ldy = _guard(-d[..., 0] * s + d[..., 1] * c)
        dzs = _guard(d[..., 2])
        tx1, tx2 = (-ex - lx) / ldx, (ex - lx) / ldx
        ty1, ty2 = (-ey - ly) / ldy, (ey - ly) / ldy
        tz1, tz2 = (z0 - o[..., 2]) / dzs, (hz - o[..., 2]) / dzs
        t_near = torch.maximum(
            torch.maximum(torch.minimum(tx1, tx2), torch.minimum(ty1, ty2)),
            torch.minimum(tz1, tz2))
        t_far = torch.minimum(
            torch.minimum(torch.maximum(tx1, tx2), torch.maximum(ty1, ty2)),
            torch.maximum(tz1, tz2))
        hit = (t_near <= t_far) & (t_far > 0) & (act > 0.5)
        t_hit = torch.where(hit, torch.clamp_min(t_near, 0.0),
                            torch.full_like(t_near, MAX_T))
        t_min, idx = torch.min(t_hit, dim=-1)   # the first minimum: lowest index
        t_out[:, r0:r0 + chunk] = t_min
        idx_out[:, r0:r0 + chunk] = torch.where(t_min < MAX_T, torch.gather(order, 1, idx),
                                                torch.full_like(idx, -1))
    return t_out, idx_out


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


def ray_boxes_cuda(origins, dirs, table, grid=None):
    """Launch K2 on the current stream -> (t (B, R), idx (B, R)). grid
    (rows, cols): a block culls for a K2_TILE tile of one view; without a
    grid, for 256 consecutive rays."""
    B, R, _ = origins.shape
    N = table.shape[1]
    check_grid(R, grid)
    check_tensor(origins, "origins", torch.float32, (B, R, 3))
    check_tensor(dirs, "dirs", torch.float32, (B, R, 3))
    check_tensor(table, "table", torch.float32, (B, N, ROW))
    if not origins.device == dirs.device == table.device:
        raise ValueError("origins, dirs and table must lie on the same device")
    lib = K2.library()
    t = torch.empty((B, R), dtype=torch.float32, device=origins.device)
    idx = torch.empty((B, R), dtype=torch.int64, device=origins.device)
    with torch.cuda.device(origins.device):
        stream = torch.cuda.current_stream(origins.device).cuda_stream
        rows, cols = grid if grid is not None else (0, 0)
        rc = lib.tt_ray_boxes(origins.data_ptr(), dirs.data_ptr(), B, R,
                              table.data_ptr(), N, t.data_ptr(), idx.data_ptr(),
                              rows, cols, stream)
    K2.check(rc)
    K2.launches += 1
    return t, idx


def ray_boxes_table(origins, dirs, table, grid=None):
    """Nearest box hit of every ray: K2 for tensors on the card, its plain
    version for tensors on the CPU. grid (rows, cols): the rays are views x
    rows x cols, row-major (it changes which rays share the kernel's cull,
    not the result)."""
    if origins.device.type == "cpu":
        check_grid(origins.shape[1], grid)
        return ray_boxes_plain(origins, dirs, table)
    return ray_boxes_cuda(origins, dirs, table, grid)
