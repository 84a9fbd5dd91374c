"""Bilinear grid sampling with zero padding, as gathers (counterpart of
`thinktwice_tpu/ops/grid_sample.py`); channels last, as there."""

from __future__ import annotations

import torch


def grid_sample_2d(img, coords):
    """img (B, H, W, C); coords (B, ..., 2) pixel units (x, y) -> (B, ..., C).
    Taps outside the image read zero. The taps keep img's dtype; the
    weighted sum is float32 (as the JAX package's promotion gives)."""
    B, H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    flat = img.reshape(B, H * W, C)
    lead = x.shape[1:]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)).reshape(B, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C)).reshape(B, *lead, C)
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    return (tap(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
            + tap(x0 + 1, y0) * (fx * (1 - fy))[..., None]
            + tap(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
            + tap(x0 + 1, y0 + 1) * (fx * fy)[..., None])


def grid_sample_norm(img, coords_norm):
    """coords in the [-1, 1] convention (align_corners=False)."""
    H, W = img.shape[1], img.shape[2]
    x = (coords_norm[..., 0] + 1.0) * 0.5 * W - 0.5
    y = (coords_norm[..., 1] + 1.0) * 0.5 * H - 0.5
    return grid_sample_2d(img, torch.stack([x, y], dim=-1))
