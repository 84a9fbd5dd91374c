"""Env-steps a second: worlds x ticks completed in the window over the
window's seconds (the whole window, drained to its last tick)."""


def read(run: dict):
    return run["units"] / run["window_s"] if run.get("window_s") else None
