"""Student weights made from the seed on the device, in one draw: the
benchmark hands the same weights to the program's model and to the
reference's."""

from __future__ import annotations

import math

import torch

TRUNC_STD = 0.87962566103423978   # std of a standard normal truncated to [-2, 2]


@torch.no_grad()
def seeded_params(model: torch.nn.Module, seed: int, device) -> None:
    """Set every parameter from one draw of truncated normals: weights of
    two or more axes lecun-normal (std 1 / sqrt(fan in)), other weights
    named `weight` (norm scales) 1, biases 0, anything else std 0.02."""
    params = list(model.named_parameters())
    scale, offset, counts = [], [], []
    for name, p in params:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            s, o = 0.0, 0.0
        elif leaf == "weight" and p.dim() == 1:
            s, o = 0.0, 1.0
        elif leaf == "weight":
            s, o = math.sqrt(1.0 / math.prod(p.shape[1:])) / TRUNC_STD, 0.0
        else:
            s, o = 0.02, 0.0
        scale.append(s)
        offset.append(o)
        counts.append(p.numel())
    g = torch.Generator(device=device).manual_seed(seed)
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(sum(counts), generator=g, device=device) * (hi - lo) + lo
    z = torch.clamp(math.sqrt(2) * torch.erfinv(u), -2.0, 2.0)
    n = torch.tensor(counts, device=device)
    flat = (z * torch.repeat_interleave(torch.tensor(scale, device=device), n)
            + torch.repeat_interleave(torch.tensor(offset, device=device), n))
    for (_, p), chunk in zip(params, torch.split(flat, counts)):
        p.copy_(chunk.view_as(p))
