"""A frozen copy of the port's plain PyTorch code: the benchmark's reference.

It holds the port's modules as they were when the benchmark was written,
with the CUDA kernels left out (K1 and K2 run as their plain versions on
any device), and only the parts the benchmark's comparisons call. It imports
torch, numpy and the standard library only, and nothing of the port, so a
later change to the port cannot move what the benchmark compares it with.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. It defaults to the card and raises
    when no card is present: a CPU run must be asked for by name."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return device
