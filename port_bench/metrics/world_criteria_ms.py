"""Device milliseconds of one call of the world step's criteria stage
(`update_criteria`): the program's span `step_world.criteria`, the mean
over the traced ticks' calls.
Read under the profiler, which slows the host: compare it with runs traced
the same way, not with the window's metrics."""

from port_bench.program_spans import mean_device_ms


def read(run: dict):
    return mean_device_ms(run, "step_world.criteria")
