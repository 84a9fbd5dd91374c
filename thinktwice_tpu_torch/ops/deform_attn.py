"""Multi-scale deformable attention as gathers and bilinear interpolation
(counterpart of `thinktwice_tpu/ops/deform_attn.py`).

`value` is channel-fused (B, sum HW, C): head h samples at its own
locations and keeps its own channel block [h*C/H, (h+1)*C/H). The
interpolation runs in value's dtype (bfloat16 in the model).
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
    head_mask = torch.eye(n_heads, dtype=value.dtype, device=value.device)
    head_mask = head_mask.repeat_interleave(head_dim, dim=1)       # (h, C)

    out = torch.zeros((B, Q, C), dtype=value.dtype, device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, start:start + H * W]                          # (B, HW, C)
        start += H * W
        loc = sampling_locations[:, :, :, lvl]                     # (B, Q, h, P, 2)
        x = loc[..., 0] * W - 0.5
        y = loc[..., 1] * H - 0.5
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx = (x - x0).to(value.dtype)
        fy = (y - y0).to(value.dtype)

        def tap(xi, yi, v=v, H=H, W=W):
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
            g = torch.gather(v, 1, idx.reshape(B, -1, 1).expand(-1, -1, C))
            g = g.reshape(B, Q, n_heads, n_points, C)
            return torch.where(inb[..., None], g, torch.zeros_like(g))

        sampled = (tap(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
                   + tap(x0 + 1, y0) * (fx * (1 - fy))[..., None]
                   + tap(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
                   + tap(x0 + 1, y0 + 1) * (fx * fy)[..., None])   # (B, Q, h, P, C)
        w = attention_weights[:, :, :, lvl, :, None]               # (B, Q, h, P, 1)
        per_head = torch.sum(sampled * w, dim=3)                   # (B, Q, h, C)
        out = out + torch.einsum("bqhc,hc->bqc", per_head, head_mask)
    return out
