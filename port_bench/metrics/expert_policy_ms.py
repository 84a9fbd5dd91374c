"""Device milliseconds of one call of the expert's policy stage (the state
vector, the Roach CNN, the Beta mode, the control): the program's span
`expert_control.policy`, the mean over the traced ticks' calls.
Read under the profiler, which slows the host: compare it with runs traced
the same way, not with the window's metrics."""

from port_bench.program_spans import mean_device_ms


def read(run: dict):
    return mean_device_ms(run, "expert_control.policy")
