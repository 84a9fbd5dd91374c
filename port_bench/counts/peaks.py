"""The H100's published peaks (`peaks.json`), the denominators of every
roofline and MFU share the benchmark reports."""

from __future__ import annotations

import json
import os

_PEAKS = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")))
HBM_BYTES_PER_S = float(_PEAKS["hbm_bytes_per_s"])


def flop_per_s(precision: str) -> float:
    """The dense peak of one precision ('float32', 'tf32', 'bfloat16', ...)."""
    return float(_PEAKS["flop_per_s"][precision])
