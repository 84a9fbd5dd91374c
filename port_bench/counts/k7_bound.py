"""The least time of K7's work on an H100 (the rulebooks of the sparse
convolutions, `thinktwice_tpu_torch/csrc/sparse_conv.cu` `tt_rulebook_*`),
from one call's own sizes and counts.

Bytes: a neighbour table (n_out x K int32) written once and its outputs'
coordinates (n_out x 4 int32) read once; a strided level besides reads its
inputs' coordinates (n_in x 4 int32) and writes its outputs' (n_out x 4
int32) once. The dense grids the kernels mark and scan are their design and
are not counted. No float operations: the bound is the bytes over the HBM
bandwidth.
"""

from __future__ import annotations

from port_bench.counts.peaks import HBM_BYTES_PER_S


def k7_bound(calls) -> dict:
    """calls: [{n_out, K, n_in (None for a submanifold table)}] -> {bytes,
    bound_ms}."""
    total = 0
    for c in calls:
        total += 4 * c["n_out"] * (c["K"] + 4)
        if c["n_in"] is not None:
            total += 16 * (c["n_in"] + c["n_out"])
    return {"bytes": total, "bound_ms": 1e3 * total / HBM_BYTES_PER_S}
