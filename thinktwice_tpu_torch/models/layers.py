"""Shared building blocks of the student model (counterpart of
`thinktwice_tpu/models/layers.py`), NCHW.

The primitives keep the JAX package's numerics, which differ from PyTorch's
defaults in three places:
- "SAME" padding is XLA's: a stride-2 3x3 conv on an even input pads (0, 1),
  not (1, 1);
- GroupNorm and LayerNorm use epsilon 1e-6, with the statistics in float32;
- `dtype` is a compute dtype: parameters stay float32, and inputs and
  parameters are cast to it (bfloat16 in the trunks). With dtype None the
  input is promoted to float32.

Submodules carry the names of the flax modules they stand for (`Conv_0`,
`GroupNorm_0`, ...), so `weights.py` maps a flax parameter tree onto the
state_dict path for path.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6


def remat(fn, *args):
    """fn(*args), its activations recomputed in the backward instead of held
    (flax's nn.remat) while gradients are on; a plain call otherwise."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def compute_dtype(x, dtype):
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


def _same_pads(size: int, k: int, s: int, d: int):
    eff = (k - 1) * d + 1
    total = max((-(-size // s) - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax.linen.Conv on NCHW: weight (out, in, k, k), padding "SAME",
    "VALID" or an int for both sides."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding="SAME", dilation: int = 1, bias: bool = True, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.padding, self.dtype = padding, dtype

    def forward(self, x):
        dt = compute_dtype(x, self.dtype)
        x = x.to(dt)
        k, s, d = self.kernel, self.stride, self.dilation
        if self.padding == "SAME":
            (t, b), (l, r) = (_same_pads(x.shape[-2], k, s, d),
                              _same_pads(x.shape[-1], k, s, d))
            if t == b and l == r:
                pad = (t, l)
            else:
                x = F.pad(x, (l, r, t, b))
                pad = 0
        elif self.padding == "VALID":
            pad = 0
        else:
            pad = int(self.padding)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, s, pad, d)


class Dense(nn.Module):
    """flax.linen.Dense: y = x @ W^T + b in the compute dtype."""

    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.dtype = dtype

    def forward(self, x):
        dt = compute_dtype(x, self.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GroupNorm(nn.Module):
    """flax.linen.GroupNorm on NCHW: float32 statistics, epsilon 1e-6, the
    result in the compute dtype."""

    def __init__(self, num_groups: int, channels: int, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, EPS)
        return y.to(compute_dtype(x, self.dtype))


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis, epsilon 1e-6."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, EPS)
        return y.to(compute_dtype(x, self.dtype))


class ConvGN(nn.Module):
    """Conv -> GroupNorm -> optional ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, groups: int = 16, padding="SAME", dtype=None):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride, padding, bias=False,
                           dtype=dtype)
        self.GroupNorm_0 = GroupNorm(min(groups, features), features, dtype=dtype)
        self.act = act

    def forward(self, x):
        x = self.GroupNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


class SEModule(nn.Module):
    """Squeeze-excitation."""

    def __init__(self, channels: int, reduction: int = 16, dtype=None):
        super().__init__()
        mid = max(channels // reduction, 4)
        self.Conv_0 = Conv(channels, mid, 1, dtype=dtype)
        self.Conv_1 = Conv(mid, channels, 1, dtype=dtype)

    def forward(self, x):
        s = torch.mean(x, dim=(-2, -1), keepdim=True)
        s = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(s))))
        return x * s


class SEBasicBlock(nn.Module):
    """Residual block with squeeze-excitation (the shared BEV pyramid)."""

    def __init__(self, cin: int, features: int, dtype=None):
        super().__init__()
        self.ConvGN_0 = ConvGN(cin, features, dtype=dtype)
        self.ConvGN_1 = ConvGN(features, features, act=False, dtype=dtype)
        self.SEModule_0 = SEModule(features, dtype=dtype)
        if cin != features:
            self.Conv_0 = Conv(cin, features, 1, bias=False, dtype=dtype)

    def forward(self, x):
        h = self.SEModule_0(self.ConvGN_1(self.ConvGN_0(x)))
        if hasattr(self, "Conv_0"):
            x = self.Conv_0(x)
        return F.relu(x + h)


class MLP(nn.Module):
    """Dense stack with ReLU between layers (optionally after the last)."""

    def __init__(self, cin: int, features: Sequence[int], final_act: bool = False,
                 dtype=None):
        super().__init__()
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", Dense(cin, f, dtype=dtype))
            cin = f
        self.n, self.final_act = len(features), final_act

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1 or self.final_act:
                x = F.relu(x)
        return x


def resize_nearest(x, hw):
    """Nearest resize of NCHW x to (h, w) with half-pixel centres, as
    jax.image.resize(..., "nearest") does."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")
