"""The 95th percentile, over every tick of the window, of the time from one
tick's completion on the device to the next (the first from the window's
start), read from a device stamp after each tick."""


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics, over all values."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def read(run: dict):
    return percentile(run["step_ms"], 95.0) if run.get("step_ms") else None
