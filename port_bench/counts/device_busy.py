"""The device's busy time: the union of the intervals of its kernels and
copies (frozen from the port's `chip_smoke.py` `device_busy`)."""

from __future__ import annotations


def busy_us(intervals) -> float:
    """Microseconds covered by at least one of the (start, end) intervals;
    overlapping kernels (on several streams) count once."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """[(start, end)] of the stretches of [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for t0, t1 in sorted(intervals):
        if t0 > end:
            gaps.append((end, min(t0, hi)))
        end = max(end, t1)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]
