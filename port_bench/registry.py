"""Finds what `BENCHMARK.json` names: a cell's configuration file, its
traffic file, the loop its traffic drives and the reader of each metric.

Everything is found by name, so a later change adds a cell, a traffic mix
or a metric by adding files and entries, never by editing a file here:

- a configuration: the `file` of its entry under `configs`;
- a traffic mix: `traffic/<traffic>.json`, whose `loop` names the module
  `loops/<loop>.py` that drives it;
- a metric: `metrics/<name>.py`, whose `read(run)` returns its value or
  None when the run holds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration file of configuration `name`, as a dict."""
    entry = _named(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, "traffic", f"{name}.json")) as f:
        return json.load(f)


def loop(kind: str):
    """The module that drives a traffic mix's loop (`loops/<kind>.py`)."""
    return importlib.import_module(f"port_bench.loops.{kind}")


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those that list the cell under `workloads`, and those with
    no `workloads` key."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(name: str, here: str = HERE):
    """`read(run)` of `metrics/<name>.py` (a name may hold dots, so the file
    is loaded by its path)."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
