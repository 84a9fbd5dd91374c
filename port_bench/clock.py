"""Stamps on the device's timeline: CUDA events on the card, the host's
clock on the CPU (where the work is synchronous)."""

from __future__ import annotations

import time

import torch


class Stamp:
    def __init__(self, device: torch.device):
        self._event = (torch.cuda.Event(enable_timing=True) if device.type == "cuda"
                       else None)
        self._t = None

    def record(self) -> "Stamp":
        if self._event is not None:
            self._event.record()
        else:
            self._t = time.perf_counter()
        return self

    def ms_since(self, earlier: "Stamp") -> float:
        """Milliseconds from `earlier` to this stamp (after a synchronize)."""
        if self._event is not None:
            return earlier._event.elapsed_time(self._event)
        return (self._t - earlier._t) * 1e3


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
