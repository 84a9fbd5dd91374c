"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the reference that decides `correct`.

A loop module (`loops/<kind>.py`) gives a `Loop(conf, traffic, seed,
device)` with:

- `warm_up(seconds)`: every shape of the window run once (the kernels
  built), and the ticks to check chosen over the window's expected length;
- `step(i)`: one unit of the window's work (a tick),
  enqueued on the device;
- `units_per_step`: worlds a tick;
- `spans()`: the `Span`s a traced run installs;
- `trace_steps`: how many steps the profiler sees, after the window;
- `record(run)`: adds what its metrics read (calls, FLOPs, and the kernel
  inputs its spans captured);
- `release()`: drops the program's state after the window;
- `check(control)`: {number: (value, limit)}, the comparison with the
  reference (with control, of the reference in the next lower precision).

The window runs `seconds` of the host's clock: steps are enqueued until
the time is up, then the device is drained, and the window ends when the
last step has completed. A stamp after each step gives each step's
completion on the device. A traced run then runs `trace_steps` more steps
under the profiler: its bookkeeping slows the host that launches the
kernels, for the rest of the process once it has run, so the window and
its spans come before it.
"""

from __future__ import annotations

import sys
import time

import torch

from port_bench import registry
from port_bench.clock import Stamp, sync
from port_bench.trace import breakdown, busy_seconds, read_profile


def device_line(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def window(loop, seconds: float, device: torch.device, trace: bool) -> dict:
    """Run the loop's steps for `seconds` -> the window's record, with the
    profiler's steps after it when traced."""
    sync(device)
    start = Stamp(device).record()
    t0 = time.perf_counter()
    stamps, i = [], 0
    while True:
        loop.step(i)
        stamps.append(Stamp(device).record())
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    step_ms = [b.ms_since(a) for a, b in zip([start] + stamps[:-1], stamps)]
    run = {"window_s": window_s, "steps": i, "units": i * loop.units_per_step,
           "step_ms": step_ms, "spans": {s.span: s.ms() for s in loop.installed}}
    loop.record(run)
    print(f"[window] {i} steps in {window_s:.3f} s", file=sys.stderr)
    if trace:
        run["trace"] = traced(loop, i, device)
        later: dict = {}
        loop.record(later)
        run.update({k: v for k, v in later.items() if k not in run})
    return run


def traced(loop, i: int, device: torch.device) -> dict:
    """The profiler's trace of `loop.trace_steps` steps from step i, with
    the spans capturing their calls' inputs."""
    n = loop.trace_steps
    for s in loop.installed:
        s.capturing = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for k in range(n):
            loop.step(i + k)
        sync(device)
        seconds = time.perf_counter() - t
    for s in loop.installed:
        s.capturing = False
    out = read_profile(prof, [s.span for s in loop.installed])
    out.update(window_s=seconds, steps=n)
    print(f"[trace] {n} steps in {seconds:.3f} s", file=sys.stderr)
    return out


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, traffic: dict | None = None, conf: dict | None = None,
             fault=None, control: bool = False) -> dict:
    """The result of one run (the contract's last line without the checks'
    order), with `checks` {number: [value, limit]}. traffic and conf replace
    the cell's traffic and configuration files, and fault(loop) breaks the
    timed path (tests, at small sizes). control puts the reference's lower
    precision in the program's place in the comparison (limit setting)."""
    device = torch.device(device)
    t_start = time.perf_counter()
    cell = registry.workload(bench, name)
    conf = conf or registry.config(bench, cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    loop = registry.loop(traffic["loop"]).Loop(conf, traffic, seed, device)
    t_built = time.perf_counter()
    if fault is not None:
        fault(loop)
    loop.installed = [s.install() for s in loop.spans()] if trace else []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop.warm_up(seconds)
    sync(device)
    setup_s = time.perf_counter() - t0
    print(f"[setup] {setup_s:.3f} s: process start to the harness {t_start - t0:.3f}, "
          f"loading, building and the program's set-up {t_built - t_start:.3f}, "
          f"warm-up {setup_s - (t_built - t0):.3f}", file=sys.stderr)
    for s in loop.installed:
        s.stamps.clear()
        s.calls.clear()
    try:
        run = window(loop, seconds, device, trace)
    finally:
        for s in loop.installed:
            s.remove()
    run["setup_s"] = setup_s
    dev = device_line(device, cell["chips"])
    metrics = {}
    for m in registry.metrics(bench, name, trace):
        value = registry.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": False, "attempted": run["steps"], "failed": 0, "metrics": metrics,
           "device": dev}
    if trace and "trace" in run:
        dev["busy_s"] = busy_seconds(run["trace"]["kernels"])
        dev["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = breakdown(run["trace"])
    del run
    loop.release()
    checks = loop.check(control)
    bad = [k for k, (v, lim) in checks.items() if not v <= lim]
    out["correct"] = not bad
    out["failed"] = len(bad)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out
