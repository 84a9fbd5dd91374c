"""K5 (hard voxelization and the VFE mean)'s share of its roofline: the frozen bound
(`counts/k5_bound.py`) of the launches traced after the window, each
from its own sizes and counts, over the device time of the kernels named
`tt_voxelize*` in the trace, in percent."""

from port_bench.counts.k5_bound import k5_bound

KERNEL = "tt_voxelize"


def read(run: dict):
    calls, t = run.get("k5"), run.get("trace")
    if not calls or not t:
        return None
    device_ms = sum(b - a for name, a, b in t["kernels"] if KERNEL in name) / 1e3
    if device_ms <= 0:
        return None
    return 100.0 * k5_bound(calls)["bound_ms"] / device_ms
