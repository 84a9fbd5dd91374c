"""Device kernels and copies a tick, in the traced part of the window."""


def read(run: dict):
    t = run.get("trace")
    return len(t["kernels"]) / t["steps"] if t and t["kernels"] else None
