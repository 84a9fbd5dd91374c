"""K6 (the sparse convolution)'s share of its roofline: the frozen bound
(`counts/k6_bound.py`) of the launches traced after the window, each
from its own sizes and counts, over the device time of the kernels named
`tt_sparse_conv_kernel*` in the trace, in percent."""

from port_bench.counts.k6_bound import k6_bound

KERNEL = "tt_sparse_conv_kernel"


def read(run: dict):
    calls, t = run.get("k6"), run.get("trace")
    if not calls or not t:
        return None
    device_ms = sum(b - a for name, a, b in t["kernels"] if KERNEL in name) / 1e3
    if device_ms <= 0:
        return None
    return 100.0 * k6_bound(calls)["bound_ms"] / device_ms
