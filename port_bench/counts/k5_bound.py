"""The least time of K5's work on an H100 (hard voxelization with the
HardSimpleVFE mean, `thinktwice_tpu_torch/csrc/voxelize.cu`), from one
launch's own sizes and counts.

Bytes: the points (B, P, F) float32 and the mask (B, P) read once; for each
voxel kept, its features (F float32), coordinate (4 int32), kept point
indices (max_points int32) and count (int32) written once. The dense index
grid the kernel fills is its own design and is not counted, nor are the
empty rows past the voxels kept. No float operations worth counting: the
bound is the bytes over the HBM bandwidth.
"""

from __future__ import annotations

from port_bench.counts.peaks import HBM_BYTES_PER_S


def k5_bound(calls) -> dict:
    """calls: [{B, P, F, M, n: [kept, dropped]}] -> {bytes, bound_ms}."""
    total = 0
    for c in calls:
        total += c["B"] * c["P"] * (4 * c["F"] + 1)
        total += c["n"][0] * 4 * (c["F"] + 4 + c["M"] + 1)
    return {"bytes": total, "bound_ms": 1e3 * total / HBM_BYTES_PER_S}
