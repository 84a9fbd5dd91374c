"""Lift-splat pooling of frustum features into the BEV grid (counterparts of
`thinktwice_tpu/ops/voxel_pool.py`: `lift_splat_pool`, the model's path, and
`voxel_pool`, the reference's CUDA `voxel_pooling` as a segment sum).

The depth (x) context outer product is never formed: a scalar scatter puts
each frustum point's depth probability into W[cell, (camera, pixel)], and
one (cells x NHW) @ (NHW x C) product per sample contracts the context.
The product is a plain float32 torch.matmul, as the JAX package leaves it
to XLA at full precision (keep TF32 off on the card for the same numbers).
"""

from __future__ import annotations

import torch


def lift_splat_pool(geom_xyz, depth_prob, context, x_min: float, y_min: float,
                    cell: float, nx: int, ny: int, z_min: float = -10.0,
                    z_max: float = 10.0):
    """geom_xyz (B or 1, N, D, HW, 3) ego-frame frustum points; depth_prob
    (B, N, D, HW); context (B, N, HW, C) -> (B, ny, nx, C). Points outside
    the grid or the z range are dropped."""
    B, N, D, HW = depth_prob.shape
    C = context.shape[-1]
    xi = torch.floor((geom_xyz[..., 0] - x_min) / cell).to(torch.int64)
    yi = torch.floor((geom_xyz[..., 1] - y_min) / cell).to(torch.int64)
    inb = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
           & (geom_xyz[..., 2] >= z_min) & (geom_xyz[..., 2] <= z_max))
    cells = nx * ny
    cell_id = torch.where(inb, yi * nx + xi, torch.full_like(xi, cells))
    dev = depth_prob.device
    nhw = (torch.arange(N, device=dev)[:, None, None] * HW
           + torch.arange(HW, device=dev)[None, None, :])          # (N, 1, HW)
    flat_id = (cell_id * (N * HW) + nhw).expand(B, N, D, HW).reshape(B, -1)
    w = torch.zeros((B, (cells + 1) * N * HW), dtype=torch.float32, device=dev)
    w.scatter_add_(1, flat_id, depth_prob.reshape(B, -1).to(torch.float32))
    w = w.reshape(B, cells + 1, N * HW)[:, :cells]
    bev = torch.matmul(w, context.reshape(B, N * HW, C).to(torch.float32))
    return bev.reshape(B, ny, nx, C)


def voxel_pool(geom_xyz, feats, x_min: float, y_min: float, cell: float, nx: int, ny: int,
               z_min: float = -10.0, z_max: float = 10.0):
    """geom_xyz (..., N, 3) ego-frame points; feats (..., N, C) their
    features -> (..., ny, nx, C): each point's features added into its
    cell with index_add_ over nx * ny + 1 bins, the last the overflow bin
    of the points outside the grid or the z range, which is dropped."""
    batch_shape = geom_xyz.shape[:-2]
    N, C = geom_xyz.shape[-2], feats.shape[-1]
    g = geom_xyz.reshape(-1, N, 3)
    f = feats.reshape(-1, N, C)
    B = g.shape[0]
    xi = torch.floor((g[..., 0] - x_min) / cell).to(torch.int64)
    yi = torch.floor((g[..., 1] - y_min) / cell).to(torch.int64)
    inb = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
           & (g[..., 2] >= z_min) & (g[..., 2] <= z_max))
    cells = nx * ny
    flat = torch.where(inb, yi * nx + xi, torch.full_like(xi, cells))
    flat = flat + (cells + 1) * torch.arange(B, device=flat.device)[:, None]
    pooled = torch.zeros((B * (cells + 1), C), dtype=f.dtype, device=f.device)
    pooled.index_add_(0, flat.reshape(-1), f.reshape(-1, C))
    bev = pooled.reshape(B, cells + 1, C)[:, :cells].reshape(B, ny, nx, C)
    return bev.reshape(*batch_shape, ny, nx, C)
