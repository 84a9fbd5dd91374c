"""Windowed PID controller of B worlds with an explicit carry (counterpart
of `thinktwice_tpu/agents/pid.py`).

The integral term is the mean of a length-n error window, the derivative
the difference of the last two errors; the window is a ring buffer.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PIDState:
    window: torch.Tensor   # (B, n) error history ring
    ptr: torch.Tensor      # (B,) i64 next write slot
    count: torch.Tensor    # (B,) i64 saturating fill counter


def pid_init(n: int, n_worlds: int, device) -> PIDState:
    return PIDState(
        window=torch.zeros((n_worlds, n), device=device),
        ptr=torch.zeros((n_worlds,), dtype=torch.int64, device=device),
        count=torch.zeros((n_worlds,), dtype=torch.int64, device=device),
    )


def pid_step(state: PIDState, error, kp: float, ki: float, kd: float):
    """error (B,) -> (control (B,), new state)."""
    n = state.window.shape[1]
    window = state.window.scatter(1, state.ptr[:, None], error[:, None])
    count = torch.clamp_max(state.count + 1, n)
    filled = count >= 2
    integral = torch.where(filled, window.sum(dim=1) / count, torch.zeros_like(error))
    prev = torch.gather(window, 1, torch.remainder(state.ptr - 1, n)[:, None])[:, 0]
    derivative = torch.where(filled, error - prev, torch.zeros_like(error))
    out = kp * error + ki * integral + kd * derivative
    return out, PIDState(window=window, ptr=torch.remainder(state.ptr + 1, n),
                         count=count)
