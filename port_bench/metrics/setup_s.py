"""Set-up seconds: from the start of the process to the start of the
window (loading, building the kernels, warming up every shape)."""


def read(run: dict):
    return run["setup_s"]
