"""Reads a `torch.profiler` trace of part of the window: the device's
kernels and copies, the host's spans, the busy time and the breakdown the
result line carries."""

from __future__ import annotations

from port_bench.counts.device_busy import busy_us, idle_gaps

TOP = 10


def read_profile(prof, span_names) -> dict:
    """-> {kernels: [(name, start_us, end_us)], spans: [(name, start_us,
    end_us)]}: the device's kernels and copies (not its annotations) and the
    host's calls of the benchmark's spans."""
    from torch.autograd import DeviceType

    kernels, spans = [], []
    names = set(span_names)
    for e in prof.events():
        t = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name not in names:
                kernels.append(t)
        elif e.name in names:
            spans.append(t)
    return {"kernels": kernels, "spans": spans}


def busy_seconds(kernels) -> float:
    return busy_us([(a, b) for _, a, b in kernels]) / 1e6


def breakdown(trace: dict) -> dict:
    """{device_ops: [[name, seconds]], idle_gaps: [[what the host was
    doing, seconds]]}, each the TOP largest: device time summed by kernel
    name; the device's idle gaps inside the traced window, summed by the
    innermost host span that holds the gap's middle."""
    kernels, spans = trace["kernels"], trace["spans"]
    by_name: dict[str, float] = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    if not kernels:
        return {"device_ops": [], "idle_gaps": []}
    lo = min(a for _, a, _ in kernels + spans)
    hi = max(b for _, _, b in kernels + spans)
    by_host: dict[str, float] = {}
    for a, b in idle_gaps([(x, y) for _, x, y in kernels], lo, hi):
        mid = 0.5 * (a + b)
        holding = [(s1 - s0, n) for n, s0, s1 in spans if s0 <= mid <= s1]
        what = min(holding)[1] if holding else "outside the spans"
        by_host[what] = by_host.get(what, 0.0) + (b - a) / 1e6
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}
