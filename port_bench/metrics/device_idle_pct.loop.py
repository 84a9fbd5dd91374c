"""The device's idle share of the window, in percent (closed-loop cells):
100 minus the busy share. The busy time a tick is the union of the kernels'
and copies' intervals over the ticks traced after the window; it is set
against the window's own ticks, which run without the profiler (its
bookkeeping slows the host that launches the kernels): 1 - busy a tick x
the window's ticks over their seconds, each tick's length from the device
stamps."""

from port_bench.counts.device_busy import busy_us


def read(run: dict):
    t = run.get("trace")
    ticks = run.get("step_ms")
    if not t or not t["kernels"] or not t.get("steps") or not ticks:
        return None
    busy_per_tick = busy_us([(a, b) for _, a, b in t["kernels"]]) / 1e6 / t["steps"]
    return 100.0 * (1.0 - busy_per_tick * len(ticks) / (sum(ticks) / 1e3))
