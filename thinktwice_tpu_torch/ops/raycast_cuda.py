"""K2, the ray-vs-box intersector: a hand-written CUDA kernel
(`csrc/raycast.cu`) and its plain PyTorch version (counterpart of
`thinktwice_tpu/ops/raycast_pallas.py`).

1. `box_table` turns box poses (B, N, 6 or 7) and their active flags into
   rows [x, y, cos(yaw), sin(yaw), ext_x, ext_y, z_top, active, z_base].
2. `ray_boxes_table` gives the nearest hit of every ray of every world,
   t (B, R) float32 and the box index idx (B, R) int64 (MAX_T and -1 on a
   miss): the kernel for a CUDA tensor, the plain version for a CPU tensor.
   There is no fallback from one to the other.

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

K2 = CudaKernel("raycast", "raycast.cu", {
    "tt_ray_boxes": ([vp, vp, ci, ci, vp, ci, vp, vp, vp], ci),
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
    box, in chunks of rays so that the (rays x boxes) intermediates stay
    small (64 MB each by default). origins, dirs (B, R, 3); table (B, N, 9)
    -> (t (B, R), idx (B, R))."""
    B, R, _ = origins.shape
    chunk = chunk or max(1, PLAIN_PAIRS // max(1, B * table.shape[1]))
    t_out = torch.full((B, R), MAX_T, dtype=torch.float32, device=origins.device)
    idx_out = torch.full((B, R), -1, dtype=torch.int64, device=origins.device)
    if table.shape[1] == 0:
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
        idx_out[:, r0:r0 + chunk] = torch.where(t_min < MAX_T, idx,
                                                torch.full_like(idx, -1))
    return t_out, idx_out


def ray_boxes_cuda(origins, dirs, table):
    """Launch K2 on the current stream -> (t (B, R), idx (B, R))."""
    B, R, _ = origins.shape
    N = table.shape[1]
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
        rc = lib.tt_ray_boxes(origins.data_ptr(), dirs.data_ptr(), B, R,
                              table.data_ptr(), N, t.data_ptr(), idx.data_ptr(),
                              stream)
    K2.check(rc)
    K2.launches += 1
    return t, idx


def ray_boxes_table(origins, dirs, table):
    """Nearest box hit of every ray: K2 for tensors on the card, its plain
    version for tensors on the CPU."""
    if origins.device.type == "cpu":
        return ray_boxes_plain(origins, dirs, table)
    return ray_boxes_cuda(origins, dirs, table)
