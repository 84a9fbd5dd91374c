"""Spans and captures around the port's public functions, recorded from
the benchmark's own files (the `Spy` pattern of the port's smoke).

`Span` replaces module.name by a wrapper for as long as it is installed:
each call runs inside `torch.profiler.record_function(span name)` and
between two device stamps, so its device time is read after the window;
`keep`, when given, also keeps each call's arguments and result (as
references: the port's functions make new tensors) while `capturing` is on.
"""

from __future__ import annotations

import torch

from port_bench.clock import Stamp


class Span:
    def __init__(self, module, name: str, span: str, device: torch.device, keep: bool = False):
        self._mod, self._name, self.span, self._device = module, name, span, device
        self._keep = keep
        self.stamps: list[tuple[Stamp, Stamp]] = []
        self.calls: list[tuple] = []
        self.capturing = False
        self._real = None

    def install(self) -> "Span":
        real = self._real = getattr(self._mod, self._name)

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(self.span):
                a = Stamp(self._device).record()
                out = real(*args, **kwargs)
                b = Stamp(self._device).record()
            self.stamps.append((a, b))
            if self._keep and self.capturing:
                self.calls.append((args, kwargs, out))
            return out

        setattr(self._mod, self._name, wrapper)
        return self

    def remove(self) -> None:
        if self._real is not None:
            setattr(self._mod, self._name, self._real)
            self._real = None

    def ms(self) -> list[float]:
        """Device milliseconds of every call (after a synchronize)."""
        return [b.ms_since(a) for a, b in self.stamps]


class Tap:
    """Replaces module.name by a wrapper that keeps its last call's result
    while `on` (a reference: no copy, no device work)."""

    def __init__(self, module, name: str):
        self._mod, self._name = module, name
        self.on, self.last = False, None
        self._real = getattr(module, name)

        def wrapper(*args, **kwargs):
            out = self._real(*args, **kwargs)
            if self.on:
                self.last = out
            return out

        setattr(module, name, wrapper)

    def remove(self) -> None:
        setattr(self._mod, self._name, self._real)
