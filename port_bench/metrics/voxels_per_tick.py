"""Voxels the sparse LiDAR encoder kept a traced tick, summed over the
worlds: the program's counter `voxels`, summed over its spans and divided
by the traced ticks. A program without the counter gives nothing to read."""

from port_bench.program_spans import records


def read(run: dict):
    recs = records(run)
    if not recs:
        return None
    counts = [r["counters"]["voxels"] for r in recs.values()
              if "voxels" in r.get("counters", {})]
    if not counts:
        return None
    return sum(counts) / run["trace"]["steps"]
