"""Hard voxelization with the HardSimpleVFE mean: K5, a hand-written CUDA
kernel (`csrc/voxelize.cu`), and its plain version (mmdet3d's
`Voxelization` with `max_num_points` and `max_voxels`, and
`HardSimpleVFE`; no counterpart in the JAX package, whose LiDAR branch
pools pillars).

The definition, per world: scan the points in input order; drop masked
points and points outside the range; a voxel takes the next id when its
first point arrives, until the world's cap; a voxel keeps its first
`max_points` points. The voxels of the batch follow one another world by
world, as mmdet3d's MVX detectors concatenate them. A voxel's feature is
the mean of its kept points' features, summed in point order in float32.

Both versions return `Voxels`. On the card every array has a fixed
capacity, cap = B * min(max_voxels, P) rows, the counts stay on the device
(`n`: kept, dropped by the cap) and nothing synchronises with the host;
rows past the voxels kept are empty (coordinate -1, count 0, features 0).
The card's version also returns the dense index grid (B, D, H, W) int32
that the sparse convolution's rulebooks read (`ops/sparse_conv.py`): a
voxel's row in its cell, -1 where the cap dropped it, EMPTY elsewhere. The
plain version, for tensors on the CPU, returns exactly the voxels kept (cap
= n) and no grid. Its voxels, point indices, counts and features are the
same bits as K5's.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from thinktwice_tpu_torch.ops.nvcc import CudaKernel, check_tensor, ci, vp

EMPTY = 0x7FFFFFFF       # an index grid's cell that holds no voxel

int_p, float_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
K5 = CudaKernel("voxelize", "voxelize.cu", {
    "tt_voxelize": ([vp, vp, ci, ci, ci, float_p, float_p, int_p, int_p, ci, ci,
                     vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp], ci),
})


@dataclasses.dataclass(frozen=True)
class VoxelSpec:
    """The voxel grid: lo (x, y, z) the range's lower corner, size (x, y,
    z) a voxel's edges, cells (nx, ny, nz) the voxel grid, shape (D, H, W)
    the sparse tensor's (D >= nz: mmdet3d's middle encoder takes one more z
    layer), max_points a voxel, max_voxels a world."""

    lo: tuple
    size: tuple
    cells: tuple
    shape: tuple
    max_points: int
    max_voxels: int

    @classmethod
    def from_config(cls, cfg) -> "VoxelSpec":
        """The spec of a ModelConfig's sparse_* fields; the cells are
        mmdet3d's round((hi - lo) / size) and must fit sparse_shape."""
        r, size = cfg.sparse_point_range, cfg.sparse_voxel_size
        cells = tuple(int(round((r[i + 3] - r[i]) / size[i])) for i in range(3))
        D, H, W = cfg.sparse_shape
        if (W, H) != cells[:2] or D < cells[2]:
            raise ValueError(f"sparse_shape {cfg.sparse_shape} does not hold the voxel grid "
                             f"{cells} (x, y, z) of the range and voxel size")
        return cls(tuple(r[:3]), tuple(size), cells, (D, H, W), cfg.sparse_max_points,
                   cfg.sparse_max_voxels)


@dataclasses.dataclass
class Voxels:
    """feats (cap, F) float32; coords (cap, 4) int32 (b, z, y, x);
    point_idx (cap, max_points) int32, each kept point's index in its
    world, -1 past the count; counts (cap,) int32; n (2,) int32 on the
    device: voxels kept, voxels dropped by the cap (summed over worlds);
    grid (B, D, H, W) int32 on the card, None on the CPU."""

    feats: torch.Tensor
    coords: torch.Tensor
    point_idx: torch.Tensor
    counts: torch.Tensor
    n: torch.Tensor
    grid: torch.Tensor | None


def voxel_cells(points, spec: VoxelSpec):
    """(cx, cy, cz) int64 voxel coordinates of points (..., >= 3) in
    float32, and whether each lies inside the voxel grid."""
    c = [torch.floor((points[..., i] - spec.lo[i]) / spec.size[i]).to(torch.int64)
         for i in range(3)]
    inside = torch.ones_like(c[0], dtype=torch.bool)
    for i in range(3):
        inside &= (c[i] >= 0) & (c[i] < spec.cells[i])
    return c, inside


def voxelize_plain(points, mask, spec: VoxelSpec) -> Voxels:
    """The plain version: points (B, P, F) float32, mask (B, P) bool ->
    Voxels of exactly the voxels kept."""
    B, P, F = points.shape
    M, cap = spec.max_points, spec.max_voxels
    D, H, W = spec.shape
    (cx, cy, cz), inside = voxel_cells(points, spec)
    valid = mask & inside
    key = (cz * H + cy) * W + cx
    feats, coords, idxs, counts = [], [], [], []
    dropped = 0
    for b in range(B):
        pid = torch.nonzero(valid[b]).flatten()                # in point order
        uniq, inv = torch.unique(key[b, pid], return_inverse=True)
        first = torch.full((len(uniq),), P, dtype=torch.int64).scatter_reduce(
            0, inv, pid, "amin")
        order = torch.argsort(first)                            # voxels by first point
        rank = torch.empty_like(order)
        rank[order] = torch.arange(len(order))
        vid = rank[inv]                                         # each point's voxel id
        nv = min(len(uniq), cap)
        dropped += len(uniq) - nv
        perm = torch.argsort(vid, stable=True)                  # point order in a voxel
        sv = vid[perm]
        start = torch.searchsorted(sv, sv, side="left")
        slot = torch.empty_like(perm)
        slot[perm] = torch.arange(len(perm)) - start
        keep = (vid < nv) & (slot < M)
        idx = torch.full((nv, M), -1, dtype=torch.int64)
        idx[vid[keep], slot[keep]] = pid[keep]
        cnt = (idx >= 0).sum(1)
        acc = torch.zeros((nv, F), dtype=torch.float32)
        for j in range(M):
            have = idx[:, j] >= 0
            acc = acc + torch.where(have[:, None], points[b, idx[:, j].clamp_min(0)],
                                    torch.zeros_like(acc))
        feats.append(acc / cnt.clamp_min(1).to(torch.float32)[:, None])
        k = uniq[order[:nv]]
        coords.append(torch.stack([torch.full_like(k, b), k // (H * W), (k // W) % H, k % W], 1))
        idxs.append(idx)
        counts.append(cnt)
    coords = torch.cat(coords).to(torch.int32)
    n = torch.tensor([coords.shape[0], dropped], dtype=torch.int32)
    return Voxels(torch.cat(feats), coords, torch.cat(idxs).to(torch.int32),
                  torch.cat(counts).to(torch.int32), n, None)


def voxelize_cuda(points, mask, spec: VoxelSpec) -> Voxels:
    """Launch K5 on the current stream (a fill, then 14 kernels at 10 points
    a voxel) -> Voxels at capacity B * min(max_voxels, P), with the index
    grid."""
    if points.dim() != 3 or points.shape[-1] < 3:
        raise ValueError(f"points must be (B, P, F >= 3), got {tuple(points.shape)}")
    B, P, F = points.shape
    check_tensor(points, "points", torch.float32, (B, P, F))
    check_tensor(mask, "mask", torch.bool, (B, P))
    D, H, W = spec.shape
    if B * D * H * W >= 2**31 or B * P >= 2**31:
        raise ValueError("K5 indexes the grid and the points with 32-bit integers")
    cap = B * min(spec.max_voxels, P)
    M, dev = spec.max_points, points.device
    i32 = dict(dtype=torch.int32, device=dev)
    grid = torch.full((B, D, H, W), EMPTY, **i32)
    pcell, pvid = torch.empty((B, P), **i32), torch.empty((B, P), **i32)
    head = torch.empty((B, P), dtype=torch.uint8, device=dev)
    nraw, slots = torch.empty((B,), **i32), torch.empty((cap, M), **i32)
    out = Voxels(torch.empty((cap, F), dtype=torch.float32, device=dev),
                 torch.empty((cap, 4), **i32), torch.empty((cap, M), **i32),
                 torch.empty((cap,), **i32), torch.empty((2,), **i32), grid)
    lib = K5.library()
    f3 = lambda v: (ctypes.c_float * 3)(*[float(x) for x in v])  # noqa: E731
    i3 = lambda v: (ctypes.c_int * 3)(*[int(x) for x in v])  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_voxelize(
            points.data_ptr(), mask.data_ptr(), B, P, F, f3(spec.lo), f3(spec.size),
            i3(spec.cells), i3(spec.shape), spec.max_voxels, M, grid.data_ptr(),
            pcell.data_ptr(), head.data_ptr(), pvid.data_ptr(), nraw.data_ptr(),
            slots.data_ptr(), out.coords.data_ptr(), out.feats.data_ptr(),
            out.point_idx.data_ptr(), out.counts.data_ptr(), out.n.data_ptr(), stream)
    K5.check(rc)
    K5.launches += 1
    return out


def voxelize(points, mask, spec: VoxelSpec) -> Voxels:
    """Hard voxelization and the VFE mean: K5 for tensors on the card, the
    plain version for tensors on the CPU."""
    if points.device.type == "cpu":
        return voxelize_plain(points, mask, spec)
    return voxelize_cuda(points, mask, spec)
