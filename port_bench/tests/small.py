"""Small sizes of the cells for the CPU tests: the cells' own files with the
worlds, the vehicles and the student's widths cut, so a run takes seconds."""

from __future__ import annotations

from port_bench import registry


def roach_small():
    tr = registry.traffic("grid64")
    tr.update(worlds=2, vehicles=6, warmup_ticks=4, trace_ticks=4, checks=2)
    return tr, None


def student_small():
    bench = registry.load_benchmark()
    tr = registry.traffic("loop8")
    tr.update(worlds=2, vehicles=6, warmup_ticks=4, trace_ticks=2, checks=2, history_calls=2)
    tr["sim"].update(max_vehicles=8, max_walkers=4, max_route_len=256, max_scenarios=4)
    conf = registry.config(bench, "student_rl6")
    conf.update(backbone_depth=10, image_size=[32, 64])
    conf["lidar"].update(n_beams=4, n_azimuth=64)
    conf["model"].update(refine_num=1, bev_channels=64, n_depth_bins=16, lidar_pillar_grid=84)
    return tr, conf
