"""Reads the program's own spans (`thinktwice_tpu_torch.tracing`). They are
on while the profiler records the steps traced after the window, so their
records hold those steps only. A program without them gives nothing to
read."""

from __future__ import annotations


def records(run: dict) -> dict | None:
    """The program's span records of a traced run, or None."""
    if not run.get("trace"):
        return None
    try:
        from thinktwice_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.records() or None


def mean_device_ms(run: dict, name: str):
    """Mean device milliseconds of one call of span `name`, or None."""
    ms = (records(run) or {}).get(name, {}).get("device_ms")
    return sum(ms) / len(ms) if ms else None
