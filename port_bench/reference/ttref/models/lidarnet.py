"""Lidar BEV encoder: a dense pillar grid and a 2D conv stack (counterpart
of `thinktwice_tpu/models/lidarnet.py`), NCHW inside.

Points are averaged per pillar (plus occupancy and log count), encoded by a
bfloat16 conv trunk with SECOND-style blocks at strides 1 and 2, and merged
SECONDFPN-style into a 512-channel map at 4x the model's BEV grid.
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.reference.ttref.config import ModelConfig
from port_bench.reference.ttref.models.layers import ConvGN, resize_nearest

POINT_FEATS = 5            # x, y, z, intensity, dt
BF16 = torch.bfloat16


def pillarize(points, mask, cfg: ModelConfig, grid: int | None = None):
    """points (B, P, 5) ego frame, mask (B, P) -> (B, grid, grid, 7): the
    mean point features of each pillar, its occupancy and log1p(count)."""
    grid = grid or cfg.lidar_pillar_grid
    B = points.shape[0]
    cell_x = (cfg.bev_x_max - cfg.bev_x_min) / grid
    cell_y = (cfg.bev_y_max - cfg.bev_y_min) / grid
    xi = torch.floor((points[..., 0] - cfg.bev_x_min) / cell_x).to(torch.int64)
    yi = torch.floor((points[..., 1] - cfg.bev_y_min) / cell_y).to(torch.int64)
    inb = mask & (xi >= 0) & (xi < grid) & (yi >= 0) & (yi < grid)
    n = grid * grid
    pid = torch.where(inb, yi * grid + xi, torch.full_like(xi, n))
    feats = torch.where(inb[..., None], points, torch.zeros_like(points))
    sums = torch.zeros((B, n + 1, POINT_FEATS), dtype=points.dtype, device=points.device)
    sums.scatter_add_(1, pid[..., None].expand(-1, -1, POINT_FEATS), feats)
    cnt = torch.zeros((B, n + 1), dtype=points.dtype, device=points.device)
    cnt.scatter_add_(1, pid, inb.to(points.dtype))
    cnt = cnt[:, :n]
    mean = sums[:, :n] / torch.clamp_min(cnt[..., None], 1.0)
    out = torch.cat([mean, (cnt > 0).to(points.dtype)[..., None],
                     torch.log1p(cnt)[..., None]], dim=-1)
    return out.reshape(B, grid, grid, POINT_FEATS + 2)


class LidarNet(nn.Module):
    """(B, P, 5) points + (B, P) mask -> (B, 512, 4*bev, 4*bev) float32."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        specs = [  # (cin, features, kernel, stride)
            (POINT_FEATS + 2, 32, 3, 1), (32, 64, 3, 2), (64, 64, 3, 1),
            (64, 128, 3, 2), (128, 128, 3, 1), (128, 128, 3, 1), (128, 128, 3, 1),
            (128, 256, 3, 2), (256, 256, 3, 1), (256, 256, 3, 1), (256, 256, 3, 1),
            (256, 256, 1, 1), (128, 256, 1, 1),
        ]
        for i, (cin, f, k, s) in enumerate(specs):
            setattr(self, f"ConvGN_{i}", ConvGN(cin, f, kernel=k, stride=s, dtype=BF16))

    def forward(self, points, mask):
        c = [getattr(self, f"ConvGN_{i}") for i in range(13)]
        x = pillarize(points, mask, self.cfg).permute(0, 3, 1, 2).to(BF16)
        for i in range(4):
            x = c[i](x)                        # grid -> grid / 4
        a = c[6](c[5](c[4](x)))
        b = c[10](c[9](c[8](c[7](a))))         # grid / 8
        b_up = c[11](resize_nearest(b, a.shape[-2:]))
        out = torch.cat([c[12](a), b_up], dim=1)
        hr = 4 * self.cfg.bev_size
        return resize_nearest(out, (hr, hr)).float()
