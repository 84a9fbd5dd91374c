"""Milliseconds of one `expert_control` call on the device (its span's two
device stamps), the mean over the window's calls."""


def read(run: dict):
    ms = run["spans"].get("expert_control")
    return sum(ms) / len(ms) if ms else None
