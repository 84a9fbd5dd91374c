"""The port's spans and its counter of host-to-device synchronisations.

A span names one stage of the program:

    with tracing.span("step_world.traffic"):
        ...

Spans are off unless a torch profiler records or a `recording()` block is
open. Off, entering a span reads two flags and returns a shared no-op
object: no `record_function`, no CUDA event, no clock read, no allocation.

On, a span enters `torch.profiler.record_function(name)`, so the profiler's
trace holds it beside the kernels, inside its parent; it records a pair of
CUDA events on the current stream (the host clock when CUDA is not
initialised), reads the host clock at entry and exit, and keeps its parent,
the innermost open span.

While spans are on and CUDA is initialised, every host-to-device
synchronisation the process makes through a stream (a blocking copy,
`.item()`, `nonzero`, a stream's synchronize) is counted against the
innermost open span: torch's sync debug mode is set to "warn", and its
warning is counted and swallowed. The mode does not flag
`torch.cuda.synchronize()` (a device synchronise), so that is not counted.
The first span entry or synchronisation after the profiler stops, or a call
of `records()`, sets the mode back to "default".

A counter counts work the program does on the device (voxels kept, active
pairs of a sparse convolution):

    tracing.count("voxels", n)      # n a device tensor; summed

While spans are on it keeps a reference to the tensor on the innermost open
span (no kernel, no copy, no sync); off, it costs what a span off costs.
The counts are read only in `records()`, after its one synchronise.

`records()` gives, per span name, its parent, calls, device ms of each call,
inclusive and self host ms, syncs and counters; `reset()` clears them. Spans carry no
tick: reading the world's tick from the card would itself synchronise, so a
per-tick figure divides by the ticks the caller traced. Spans keep one stack
for the process: open them from one thread at a time.
"""

from __future__ import annotations

import contextlib
import re
import time
import warnings

import torch
from torch.autograd import profiler as _profiler

SYNC_WARNING = "called a synchronizing CUDA operation"

_recording = False   # a recording() block is open
_armed = False       # the sync counter is armed
_live = False        # _recording or _armed: what the off path reads beside the profiler's flag
_stack: list = []    # the open spans, innermost last
_records: dict = {}
_outside = 0         # syncs counted while no span was open
_pool: list = []     # CUDA events free for reuse
_filter = None       # the warnings filter that lets every sync warning through
_shown = None        # warnings.showwarning as it was before arming


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Record:
    __slots__ = ("parent", "calls", "pairs", "device_ms", "host_ns", "self_ns", "syncs",
                 "counts", "counted")

    def __init__(self, parent: str | None):
        self.parent = parent
        self.calls = self.host_ns = self.self_ns = self.syncs = 0
        self.pairs: list = []          # (start, end) CUDA events not yet read
        self.device_ms: list[float] = []
        self.counts: dict = {}         # counter name -> tensors not yet read
        self.counted: dict = {}        # counter name -> the sum read so far


class _Span:
    __slots__ = ("name", "record", "fn", "events", "t0", "child_ns")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0

    def __enter__(self):
        rec = _records.get(self.name)
        if rec is None:
            rec = _records[self.name] = _Record(_stack[-1].name if _stack else None)
        self.record = rec
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (_pool.pop() if _pool else torch.cuda.Event(enable_timing=True),
                           _pool.pop() if _pool else torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter_ns() - self.t0
        _stack.pop()
        rec = self.record
        rec.calls += 1
        rec.host_ns += dt
        rec.self_ns += dt - self.child_ns
        if self.events is None:
            rec.device_ms.append(dt / 1e6)
        else:
            self.events[1].record()
            rec.pairs.append(self.events)
        if _stack:
            _stack[-1].child_ns += dt
        self.fn.__exit__(exc_type, exc, tb)
        return None


def _enabled() -> bool:
    return _recording or _profiler._is_profiler_enabled


def span(name: str):
    """A context manager that spans one stage of the program (see the
    module's docstring)."""
    if _live or _profiler._is_profiler_enabled:
        if not _enabled():
            _disarm()
            return _OFF
        if not _armed and torch.cuda.is_initialized():
            _arm()
        return _Span(name)
    return _OFF


def count(name: str, value) -> None:
    """Add value (a tensor, summed; or a number) to counter `name` of the
    innermost open span while spans are on (see the module's docstring)."""
    if not (_live or _profiler._is_profiler_enabled) or not _stack or not _enabled():
        return
    _stack[-1].record.counts.setdefault(name, []).append(value)


def _showwarning(message, category, filename, lineno, file=None, line=None):
    """warnings.showwarning while armed: counts a sync warning against the
    innermost open span and swallows it, and passes any other warning on."""
    global _outside
    if not str(message).startswith(SYNC_WARNING):
        return _shown(message, category, filename, lineno, file, line)
    if not _enabled():
        _disarm()
    elif _stack:
        _stack[-1].record.syncs += 1
    else:
        _outside += 1
    return None


def _arm() -> None:
    global _armed, _live, _filter, _shown
    warnings.filterwarnings("always", message=re.escape(SYNC_WARNING), category=UserWarning)
    _filter = warnings.filters[0]
    _shown = warnings.showwarning
    warnings.showwarning = _showwarning
    with warnings.catch_warnings():   # torch's notice that the mode is a prototype
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    _armed = _live = True


def _disarm() -> None:
    global _armed, _live
    if _armed:
        torch.cuda.set_sync_debug_mode("default")
        if warnings.showwarning is _showwarning:
            warnings.showwarning = _shown
        if _filter in warnings.filters:
            warnings.filters.remove(_filter)
        _armed = False
    _live = _recording


@contextlib.contextmanager
def recording():
    """Spans on without a profiler, for the block."""
    global _recording, _live
    before = _recording
    _recording = _live = True
    try:
        yield
    finally:
        _recording = before
        _live = _recording or _armed
        if _armed and not _enabled():
            _disarm()


def records() -> dict:
    """{span name: {parent, calls, device_ms (one a call), host_ms
    (inclusive), self_host_ms (not covered by child spans), syncs, counters
    {name: sum}}} of every span closed since the last reset(). Synchronises
    the device once (not counted) when CUDA events or counts are pending."""
    if _armed and not _enabled():
        _disarm()
    if torch.cuda.is_initialized() and any(r.pairs or r.counts for r in _records.values()):
        torch.cuda.synchronize()
    out = {}
    for name, r in _records.items():
        for a, b in r.pairs:
            r.device_ms.append(a.elapsed_time(b))
            _pool.extend((a, b))
        r.pairs.clear()
        for key, values in r.counts.items():
            total = sum(int(v.sum()) if torch.is_tensor(v) else int(v) for v in values)
            r.counted[key] = r.counted.get(key, 0) + total
        r.counts.clear()
        out[name] = {"parent": r.parent, "calls": r.calls, "device_ms": list(r.device_ms),
                     "host_ms": r.host_ns / 1e6, "self_host_ms": r.self_ns / 1e6,
                     "syncs": r.syncs, "counters": dict(r.counted)}
    return out


def syncs_outside() -> int:
    """Syncs counted since the last reset() while spans were on and none
    was open."""
    return _outside


def reset() -> None:
    """Forget every record (spans open now record into dropped records)."""
    global _outside
    for r in _records.values():
        for pair in r.pairs:
            _pool.extend(pair)
    _records.clear()
    _outside = 0
