"""The least time of K6's work on an H100 (one sparse convolution over a
neighbour table, `thinktwice_tpu_torch/csrc/sparse_conv.cu`
`tt_sparse_conv_kernel`), from one launch's own sizes and counts.

Bytes: the input rows (n_in x C_in float32) read once, the table (n_out x K
int32) read once, the weights (K x C_in x C_out float32) and the batch
norm's four (C_out,) arrays read once, the residual (n_out x C_out) read
once where there is one, the output (n_out x C_out float32) written once.
Operations: 2 x the active pairs x C_in x C_out (a multiply-add is two),
the work of the pairs alone, never a dense grid's. The bound is the larger
of the bytes over the HBM bandwidth and the operations over the float32
peak (the encoder computes in float32).
"""

from __future__ import annotations

from port_bench.counts.peaks import HBM_BYTES_PER_S, flop_per_s


def k6_bound(calls) -> dict:
    """calls: [{n_in, n_out, pairs, K, cin, cout, residual}] -> {bytes,
    flops, bound_ms} summed over the launches, each launch's bound the
    larger of its two times."""
    total_bytes = total_flops = 0
    bound = 0.0
    for c in calls:
        b = 4 * (c["n_in"] * c["cin"] + c["n_out"] * c["K"] + c["K"] * c["cin"] * c["cout"]
                 + 4 * c["cout"] + c["n_out"] * c["cout"] * (2 if c["residual"] else 1))
        f = 2 * c["pairs"] * c["cin"] * c["cout"]
        total_bytes += b
        total_flops += f
        bound += max(b / HBM_BYTES_PER_S, f / flop_per_s("float32"))
    return {"bytes": total_bytes, "flops": total_flops, "bound_ms": 1e3 * bound}
