"""Device milliseconds of one call of the student's LiDAR branch: the
program's span `student_forward.lidar` (the encoder, ConvGN_2 and
ConvGN_3), the mean over the traced ticks' calls.
Read under the profiler, which slows the host: compare it with runs traced
the same way, not with the window's metrics."""

from port_bench.program_spans import mean_device_ms


def read(run: dict):
    return mean_device_ms(run, "student_forward.lidar")
