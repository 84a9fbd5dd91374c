"""Human-readable per-route result tables for the console (a copy of
`thinktwice_tpu/harness/result_writer.py`): a grid table per route
(durations and each criterion's SUCCESS/FAILURE) and a global summary,
from the results document of `harness.statistics.results_document`.
"""

from __future__ import annotations

GREEN = "\033[92m"
RED = "\033[91m"
BOLD = "\033[1m"
END = "\033[0m"


def _grid(rows: list[list[str]]) -> str:
    """Minimal fancy_grid-style tabulation (no external deps)."""
    widths = [
        max(len(str(r[c])) for r in rows) for c in range(len(rows[0]))
    ]

    def line(l, m, r, fill="═"):
        return l + m.join(fill * (w + 2) for w in widths) + r

    def row(cells):
        return (
            "│"
            + "│".join(f" {str(c):<{w}} " for c, w in zip(cells, widths))
            + "│"
        )

    out = [line("╒", "╤", "╕")]
    for i, r in enumerate(rows):
        out.append(row(r))
        out.append(
            line("╞", "╪", "╡") if i == 0 and len(rows) > 1
            else line("├", "┼", "┤", "─") if i < len(rows) - 1
            else line("╘", "╧", "╛")
        )
    # strip ANSI codes from width math is overkill; accept slight misalign
    return "\n".join(out)


def _status_cell(ok: bool) -> str:
    return f"{GREEN}SUCCESS{END}" if ok else f"{RED}FAILURE{END}"


def route_report(record: dict) -> str:
    """One route's table."""
    meta = record.get("meta", {})
    scores = record.get("scores", {})
    infr = record.get("infractions", {})
    out = (
        f"\n{BOLD}========= Results of {record.get('route_id', '?')} "
        f"------ {record.get('status', '?')} ========={END}\n\n"
    )
    sys_t = float(meta.get("duration_system", 0.0))
    game_t = float(meta.get("duration_game", 0.0))
    out += _grid(
        [
            ["Duration (System Time)", f"{sys_t:.2f}s"],
            ["Duration (Game Time)", f"{game_t:.2f}s"],
            ["Ratio (Game / System)",
             f"{game_t / sys_t:.3f}" if sys_t > 0 else "-"],
            ["Route length", f"{float(meta.get('route_length', 0)):.0f} m"],
            ["Driving score", f"{scores.get('score_composed', 0):.2f}"],
        ]
    )
    out += "\n\n"

    def count(key):
        v = infr.get(key, [])
        return len(v) if isinstance(v, list) else v

    completed = record.get("status") == "Completed"
    crit_rows = [["Criterion", "Result", "Value"]]
    crit_rows.append(
        ["RouteCompletionTest", _status_cell(completed),
         f"{scores.get('score_route', 0):.1f} %"]
    )
    for name, key in (
        ("CollisionTest(vehicle)", "collisions_vehicle"),
        ("CollisionTest(walker)", "collisions_pedestrian"),
        ("CollisionTest(layout)", "collisions_layout"),
        ("RunningRedLightTest", "red_light"),
        ("RunningStopTest", "stop_infraction"),
    ):
        n = count(key)
        crit_rows.append([name, _status_cell(n == 0), f"{n} times"])
    crit_rows.append(
        ["OutsideRouteLanesTest",
         _status_cell(count("outside_route_lanes") == 0),
         (infr.get("outside_route_lanes") or ["0%"])[0]
         if isinstance(infr.get("outside_route_lanes"), list)
         else str(infr.get("outside_route_lanes"))]
    )
    crit_rows.append(
        ["InRouteTest", _status_cell(count("route_dev") == 0), ""]
    )
    crit_rows.append(
        ["AgentBlockedTest", _status_cell(count("vehicle_blocked") == 0), ""]
    )
    crit_rows.append(
        ["Timeout", _status_cell(count("route_timeout") == 0), ""]
    )
    out += _grid(crit_rows) + "\n"
    return out


def global_report(doc: dict) -> str:
    """Global summary table from a results document."""
    g = doc["_checkpoint"]["global_record"]
    s = g["scores"]
    rows = [
        ["Metric", "Value"],
        ["Driving score", f"{s['score_composed']:.3f}"],
        ["Route completion", f"{s['score_route']:.3f}"],
        ["Infraction penalty", f"{s['score_penalty']:.3f}"],
    ]
    for k, v in g.get("infractions", {}).items():
        rows.append([f"{k} (/km)", f"{float(v):.3f}"])
    return (
        f"\n{BOLD}========= Global results "
        f"({len(doc['_checkpoint']['records'])} routes) ========={END}\n"
        + _grid(rows)
        + "\n"
    )


def print_results(doc: dict, per_route: bool = True) -> None:
    if per_route:
        for rec in doc["_checkpoint"]["records"]:
            print(route_report(rec))
    print(global_report(doc))
