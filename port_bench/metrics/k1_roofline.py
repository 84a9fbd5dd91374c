"""K1's share of its roofline: the frozen bound (`counts/k1_bound.py`) of the
launches traced after the window, each on its own inputs, over
K1's device time in the trace, in percent."""

from port_bench.counts.k1_bound import k1_bound


def read(run: dict):
    k = run.get("k1")
    t = run.get("trace")
    if not k or not t or not k["inputs"]:
        return None
    device_ms = sum(b - a for name, a, b in t["kernels"] if k["kernel"] in name) / 1e3
    if device_ms <= 0:
        return None
    bound_ms = sum(k1_bound(k["width"], k["pixels_ev_to_bottom"], k["pixels_per_meter"], prims, ego)["bound_ms"]
                   for prims, ego in k["inputs"])
    return 100.0 * bound_ms / device_ms
