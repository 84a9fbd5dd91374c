"""Milliseconds of one `step_world` call on the device (its span's two
device stamps), the mean over the window's calls."""


def read(run: dict):
    ms = run["spans"].get("step_world")
    return sum(ms) / len(ms) if ms else None
