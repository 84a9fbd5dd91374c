"""Device milliseconds of one call of the sparse LiDAR encoder's sparse
stage: the program's span `student_forward.lidar.sparse` (the rulebooks,
K6 and the dense scatter), the mean over the traced ticks' calls. A
program without the span gives nothing to read.
Read under the profiler, which slows the host: compare it with runs traced
the same way, not with the window's metrics."""

from port_bench.program_spans import mean_device_ms


def read(run: dict):
    return mean_device_ms(run, "student_forward.lidar.sparse")
