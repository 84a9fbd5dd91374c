"""Host-to-device synchronisations a traced tick makes inside the program's
spans, each counted on its innermost span (0.0 when the spans ran and none
synchronised)."""

from port_bench.program_spans import records


def read(run: dict):
    recs = records(run)
    if not recs:
        return None
    return sum(r["syncs"] for r in recs.values()) / run["trace"]["steps"]
