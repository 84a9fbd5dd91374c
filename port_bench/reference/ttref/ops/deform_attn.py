"""Multi-scale deformable attention as gathers and bilinear interpolation
(counterpart of `thinktwice_tpu/ops/deform_attn.py`).

`value` is channel-fused (B, sum HW, C): head h samples at its own
locations and keeps its own channel block [h*C/H, (h+1)*C/H). The JAX
package gathers all C channels for every head and keeps each head's block
with a one-hot mixing product; here each head gathers its own block only
(an eighth of the gathered bytes at 8 heads), which gives the same numbers:
the product adds exact zeros to each kept channel. The interpolation runs
in value's dtype (bfloat16 in the model).
"""

from __future__ import annotations

from typing import Sequence

import torch


def ms_deform_attn(value, spatial_shapes: Sequence[tuple[int, int]],
                   sampling_locations, attention_weights):
    """value (B, sum_l H_l*W_l, C); sampling_locations (B, Q, heads, levels,
    points, 2) in [0, 1]; attention_weights (B, Q, heads, levels, points)
    -> (B, Q, C)."""
    B, _, C = value.shape
    Q, n_heads, n_points = (sampling_locations.shape[1], sampling_locations.shape[2],
                            sampling_locations.shape[4])
    head_dim = C // n_heads

    # the heads lead: (B, heads, Q * points, head_dim) stays contiguous
    out = torch.zeros((B, n_heads, Q, head_dim), dtype=value.dtype, device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = (value[:, start:start + H * W].reshape(B, H * W, n_heads, head_dim)
             .transpose(1, 2).contiguous())                        # (B, h, HW, d)
        start += H * W
        loc = sampling_locations[:, :, :, lvl].transpose(1, 2)     # (B, h, Q, P, 2)
        x = (loc[..., 0] * W - 0.5).reshape(B, n_heads, Q * n_points)
        y = (loc[..., 1] * H - 0.5).reshape(B, n_heads, Q * n_points)
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx = (x - x0).to(value.dtype)
        fy = (y - y0).to(value.dtype)

        def tap(xi, yi, v=v, H=H, W=W):
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)   # (B, h, QP)
            g = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, head_dim))
            return torch.where(inb[..., None], g, torch.zeros_like(g))

        sampled = (tap(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
                   + tap(x0 + 1, y0) * (fx * (1 - fy))[..., None]
                   + tap(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
                   + tap(x0 + 1, y0 + 1) * (fx * fy)[..., None])   # (B, h, QP, d)
        w = attention_weights[:, :, :, lvl].transpose(1, 2).reshape(B, n_heads, -1, 1)
        out = out + torch.sum((sampled * w).reshape(B, n_heads, Q, n_points, head_dim), dim=3)
    return out.transpose(1, 2).reshape(B, Q, C)
