"""The plain reference of the student's published LiDAR encoder: hard
voxelization, HardSimpleVFE, SparseEncoder, SECOND and SECONDFPN, in plain
PyTorch, written apart from the program's kernels and its plain versions.

- Voxelization is mmdet3d's sequential definition as a loop over each
  world's points in input order: a point outside the range or masked is
  dropped; a voxel takes the next id when its first point arrives, until
  the cap; a voxel keeps its first max_points points. The VFE is their
  mean, in float32.
- Each sparse convolution is a dense `conv3d` over the grid with the
  inactive sites zero, its result kept at the output's active sites: a
  submanifold convolution's are the input's, a strided one's the max-pool
  of the input's mask with the same kernel, stride and padding. That is
  exact sparse-convolution semantics by another route. It runs one world at
  a time over the columns (y, x) its voxels span, widened by 16 cells and
  aligned to the encoder's stride of 8 (the sites outside are inactive, so
  the crop changes no active output), about 1.2 GB a world at 16 channels
  on the full 41 x 672 x 672 grid.
- SECOND and SECONDFPN in bfloat16 (float32 parameters), batch norm in eval
  mode from the running statistics.

Precision: the sparse encoder in float32 (the caller turns TF32 off); with
the control on (`layers.lower_precision`) it computes in bfloat16 and the
dense stages on float8 operands, one precision lower each.

The settings are the configuration file's `sparse_lidar` entries (the port's
ModelConfig names); the module tree and parameter shapes follow the
program's, so the benchmark's seeded weights are the same on both sides.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from port_bench.reference.ttref.models import layers

BF16 = torch.bfloat16
EPS = 1e-3
STRIDE_XY = 8          # three stride-2 convolutions in y and x
MARGIN = 16            # crop margin, in cells of the input grid


def _triple(v) -> tuple:
    return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) else (int(v),) * 3


class BatchNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @torch.no_grad()
    def reset_running_stats(self) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, EPS)


class Conv3dBN(nn.Module):
    def __init__(self, cin, cout, kernel=3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *_triple(kernel)))
        self.bn = BatchNorm(cout)

    def forward(self, x, mask, stride=1, padding=1, residual=None):
        dt = BF16 if layers._Lower.on else torch.float32
        y = F.conv3d(x.to(dt), self.weight.to(dt), None, stride, padding).float()
        y = self.bn(y)
        if residual is not None:
            y = y + residual
        return torch.relu(y) * mask


class BasicBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv1 = Conv3dBN(channels, channels)
        self.conv2 = Conv3dBN(channels, channels)

    def forward(self, x, mask):
        return self.conv2(self.conv1(x, mask), mask, residual=x)


class Encoder(nn.Module):
    """mmdet3d's SparseEncoder (basic blocks) on a dense grid."""

    def __init__(self, s: dict, in_channels: int = 5):
        super().__init__()
        base = s["sparse_base_channels"]
        self.conv_input = Conv3dBN(in_channels, base)
        stages, cin, self.pads = [], base, {}
        chans = s["sparse_encoder_channels"]
        for i, blocks in enumerate(chans):
            mods = []
            for j, cout in enumerate(blocks):
                if j == len(blocks) - 1 and i != len(chans) - 1:
                    mods.append(Conv3dBN(cin, cout))
                    self.pads[i] = _triple(s["sparse_encoder_paddings"][i][j])
                else:
                    mods.append(BasicBlock(cout))
                cin = cout
            stages.append(nn.ModuleList(mods))
        self.encoder_layers = nn.ModuleList(stages)
        self.conv_out = Conv3dBN(cin, s["sparse_output_channels"], (3, 1, 1))

    def forward(self, x, mask):
        """x (1, C, D, h, w) with zeros at inactive sites, mask (1, 1, D, h,
        w) -> (1, C_out, D_out, h / 8, w / 8)."""
        x = self.conv_input(x, mask)
        for i, stage in enumerate(self.encoder_layers):
            for m in stage:
                if isinstance(m, BasicBlock):
                    x = m(x, mask)
                else:
                    mask = F.max_pool3d(mask, 3, 2, self.pads[i])
                    x = m(x, mask, 2, self.pads[i])
        mask = F.max_pool3d(mask, (3, 1, 1), (2, 1, 1), 0)
        return self.conv_out(x, mask, (2, 1, 1), 0)


class Conv2dBN(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bn = BatchNorm(cout)
        self.stride = stride

    def forward(self, x):
        x, w = layers._operands(x, self.weight, BF16)
        return torch.relu(self.bn(F.conv2d(x, w, None, self.stride, 1)))


class Deconv2dBN(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, stride, stride))
        self.bn = BatchNorm(cout)
        self.stride = stride

    def forward(self, x):
        x, w = layers._operands(x, self.weight, BF16)
        return torch.relu(self.bn(F.conv_transpose2d(x, w, None, self.stride)))


class Backbone(nn.Module):
    def __init__(self, s: dict, cin: int):
        super().__init__()
        blocks = []
        for cout, n, st in zip(s["second_out_channels"], s["second_layer_nums"],
                               s["second_layer_strides"]):
            blocks.append(nn.ModuleList([Conv2dBN(cin, cout, st)]
                                        + [Conv2dBN(cout, cout) for _ in range(n)]))
            cin = cout
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for block in self.blocks:
            for m in block:
                x = m(x)
            outs.append(x)
        return outs


class Neck(nn.Module):
    def __init__(self, s: dict):
        super().__init__()
        self.deblocks = nn.ModuleList([
            Deconv2dBN(cin, cout, st) for cin, cout, st in
            zip(s["second_out_channels"], s["fpn_out_channels"], s["fpn_upsample_strides"])])

    def forward(self, xs):
        return torch.cat([d(x) for d, x in zip(self.deblocks, xs)], dim=1)


def voxelize_world(points, mask, s: dict) -> dict:
    """One world's points (P, F) and mask (P,) -> {coords (V, 3) int64 (z,
    y, x), point_idx (V, M) int64 (-1 past the count), counts (V,), feats
    (V, F) float32}, voxels in the order their first points arrive."""
    points = points.detach().float().cpu()
    lo, size = s["sparse_point_range"][:3], s["sparse_voxel_size"]
    hi = s["sparse_point_range"][3:]
    cells = [int(round((hi[i] - lo[i]) / size[i])) for i in range(3)]
    c = torch.stack([torch.floor((points[:, i] - lo[i]) / size[i]) for i in range(3)], 1)
    c = c.to(torch.int64).tolist()
    keep = mask.detach().cpu().tolist()
    M, cap = s["sparse_max_points"], s["sparse_max_voxels"]
    table: dict = {}
    order = []
    for p, (x, y, z) in enumerate(c):
        if not keep[p] or not (0 <= x < cells[0] and 0 <= y < cells[1] and 0 <= z < cells[2]):
            continue
        key = (z, y, x)
        got = table.get(key)
        if got is None:
            if len(order) < cap:
                table[key] = [p]
                order.append(key)
        elif len(got) < M:
            got.append(p)
    V = len(order)
    idx = torch.tensor([table[key] + [-1] * (M - len(table[key])) for key in order],
                       dtype=torch.int64).reshape(V, M)
    counts = (idx >= 0).sum(1)
    kept = torch.where((idx >= 0)[..., None], points[idx.clamp_min(0)], 0.0)
    feats = kept.sum(1) / counts.clamp_min(1)[:, None].to(torch.float32)
    coords = torch.tensor(order, dtype=torch.int64).reshape(V, 3)
    return {"coords": coords, "point_idx": idx, "counts": counts, "feats": feats}


class RefSparseLidarNet(nn.Module):
    """(B, P, 5) points + (B, P) mask -> (B, 512, H / 8, W / 8) float32."""

    def __init__(self, settings: dict):
        super().__init__()
        self.s = dict(settings)
        self.middle_encoder = Encoder(self.s)
        depth = self.s["sparse_shape"][0]
        for i in range(len(self.middle_encoder.pads)):
            depth = (depth + 2 * self.middle_encoder.pads[i][0] - 3) // 2 + 1
        depth = (depth - 3) // 2 + 1
        self.backbone = Backbone(self.s, self.s["sparse_output_channels"] * depth)
        self.neck = Neck(self.s)

    def voxelize(self, points, mask) -> list:
        return [voxelize_world(points[b], mask[b], self.s) for b in range(points.shape[0])]

    def encode(self, voxels: list, device) -> torch.Tensor:
        """The sparse encoder's dense output (B, C_out * D_out, H / 8, W /
        8) float32, a world at a time."""
        D, H, W = self.s["sparse_shape"]
        outs = []
        for v in voxels:
            c = v["coords"].to(device)
            y0, x0, y1, x1 = 0, 0, STRIDE_XY, STRIDE_XY
            if len(c):
                y0 = max(0, int(c[:, 1].min()) // STRIDE_XY * STRIDE_XY - MARGIN)
                x0 = max(0, int(c[:, 2].min()) // STRIDE_XY * STRIDE_XY - MARGIN)
                y1 = min(H, (int(c[:, 1].max()) // STRIDE_XY + 1) * STRIDE_XY + MARGIN)
                x1 = min(W, (int(c[:, 2].max()) // STRIDE_XY + 1) * STRIDE_XY + MARGIN)
            F_ = v["feats"].shape[1]
            x = torch.zeros((1, F_, D, y1 - y0, x1 - x0), dtype=torch.float32, device=device)
            mask = torch.zeros((1, 1, D, y1 - y0, x1 - x0), dtype=torch.float32, device=device)
            z, y, xx = c[:, 0], c[:, 1] - y0, c[:, 2] - x0
            x[0, :, z, y, xx] = v["feats"].to(device).T           # (F, V)
            mask[0, 0, z, y, xx] = 1.0
            out = self.middle_encoder(x, mask)                    # (1, C, Do, h, w)
            full = torch.zeros((1, out.shape[1], out.shape[2], H // STRIDE_XY, W // STRIDE_XY),
                               dtype=torch.float32, device=device)
            full[..., y0 // STRIDE_XY:y1 // STRIDE_XY, x0 // STRIDE_XY:x1 // STRIDE_XY] = out
            outs.append(full.reshape(1, -1, H // STRIDE_XY, W // STRIDE_XY))
        return torch.cat(outs)

    def forward(self, points, mask):
        dense = self.encode(self.voxelize(points, mask), points.device)
        return self.neck(self.backbone(dense)).float()
