"""K2's share of its roofline: the frozen bound (`counts/k2_bound.py`) of the
launches traced after the window, each on its own inputs, over
K2's device time in the trace, in percent."""

from port_bench.counts.k2_bound import k2_bound


def read(run: dict):
    k = run.get("k2")
    t = run.get("trace")
    if not k or not t or not k["inputs"]:
        return None
    device_ms = sum(b - a for name, a, b in t["kernels"] if k["kernel"] in name) / 1e3
    if device_ms <= 0:
        return None
    bound_ms = k2_bound(k["inputs"])["bound_ms"]
    return 100.0 * bound_ms / device_ms
