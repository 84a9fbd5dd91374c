"""The comparison on the card at the cells' small sizes: the port's
kernels (K1, K2) and the card's arithmetic against the reference, and the
control not correct there too. Marked `cuda`; skips without a card.

    python -m pytest -m cuda port_bench/tests/test_pb_card.py
"""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import harness, registry
from port_bench.tests.small import roach_small, student_small

CELLS = [("roach_rl6.grid64", roach_small), ("student_rl6.loop8", student_small)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def run(card, cell, small, **kw):
    traffic, conf = small()
    return harness.run_cell(registry.load_benchmark(), cell, 2**31 + 41, 2.0, False, card,
                            time.perf_counter(), traffic=traffic, conf=conf, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,small", CELLS)
def test_card_agrees_with_reference(card, cell, small):
    out = run(card, cell, small)
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,small", CELLS)
def test_card_control_is_not_correct(card, cell, small):
    out = run(card, cell, small, control=True)
    assert not out["correct"], out["checks"]
