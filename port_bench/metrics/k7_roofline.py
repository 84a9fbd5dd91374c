"""K7 (the sparse convolutions' rulebooks)'s share of its roofline: the frozen bound
(`counts/k7_bound.py`) of the launches traced after the window, each
from its own sizes and counts, over the device time of the kernels named
`tt_rulebook*` in the trace, in percent."""

from port_bench.counts.k7_bound import k7_bound

KERNEL = "tt_rulebook"


def read(run: dict):
    calls, t = run.get("k7"), run.get("trace")
    if not calls or not t:
        return None
    device_ms = sum(b - a for name, a, b in t["kernels"] if KERNEL in name) / 1e3
    if device_ms <= 0:
        return None
    return 100.0 * k7_bound(calls)["bound_ms"] / device_ms
