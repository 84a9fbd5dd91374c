"""PyTorch port of `thinktwice_tpu` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module names
(`sim/step.py` here is `thinktwice_tpu/sim/step.py` there) with an explicit
leading world axis in place of `vmap`. It imports torch, numpy and the
standard library only.
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
