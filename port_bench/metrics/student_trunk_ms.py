"""Device milliseconds of one call of the student's camera trunk (the
multi-sweep LSS): the program's span `student_forward.trunk`, the mean
over the traced ticks' calls.
Read under the profiler, which slows the host: compare it with runs traced
the same way, not with the window's metrics."""

from port_bench.program_spans import mean_device_ms


def read(run: dict):
    return mean_device_ms(run, "student_forward.trunk")
