"""The published LiDAR encoder of the ThinkTwice student (mmdet3d's MVX
pipeline, ThinkTwice `code/model_code/backbones/lidarnet.py`): hard
voxelization, HardSimpleVFE, a float32 SparseEncoder, the SECOND backbone
and the SECONDFPN neck. No counterpart in the JAX package, whose LiDAR
branch is the dense pillar grid of `models/lidarnet.py`.

(B, P, 5) points + (B, P) mask -> (B, 512, H / 8, W / 8) float32, in the
layout `LidarNet` gives (channels, then y rows and x columns of the metric
BEV): 512 x 84 x 84 over the student's 41 x 672 x 672 grid.

- Voxelization and the VFE (`ops/voxelize.py`, K5 on the card): at most
  `sparse_max_points` points a voxel and `sparse_max_voxels` voxels a
  world, mmdet3d's order.
- SparseEncoder (mmdet3d `SparseEncoder`, block_type "basicblock", order
  conv, norm, act): `conv_input` a 3 x 3 x 3 submanifold convolution to
  the base channels; four stages of submanifold basic blocks, each stage
  but the last closed by a stride-2 convolution with the stage's padding;
  `conv_out` a (3, 1, 1) convolution of stride (2, 1, 1); the dense result
  (B, C, D, H, W) viewed as (B, C * D, H, W). Every convolution without
  bias, batch norm with eps 1e-3, in float32 (`ops/sparse_conv.py`, K6 and
  its rulebooks K7 on the card; the submanifold convolutions of one
  resolution share one rulebook, as spconv's `indice_key` does).
- SECOND (3 x 3 convolutions, padding 1, without bias) and SECONDFPN (a
  transposed convolution of kernel and stride the upsample stride, the 1 x 1
  one included), each followed by batch norm (eps 1e-3) and ReLU, in
  bfloat16 as `LidarNet`'s conv stack; the neck's outputs concatenated.

Batch norm runs in eval mode: a per-channel affine from its running
statistics (buffers; `reset_running_stats` sets them to 0 and 1 after the
model is allocated). The backward is out of scope: on the card a gradient
through the sparse convolution raises.

Spans inside `student_forward.lidar`: `.voxelize` (K5), `.sparse` (the
rulebooks, K6 and the dense scatter), `.dense` (SECOND and SECONDFPN); the
counters `voxels`, `voxels_dropped` (by the cap) and `rule_pairs` (active
pairs over every sparse convolution) are device tensors added while spans
are on.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from thinktwice_tpu_torch import tracing
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.ops import sparse_conv as sc
from thinktwice_tpu_torch.ops import voxelize as vx

POINT_FEATS = 5            # x, y, z, intensity, dt
BN_EPS = 1e-3
BF16 = torch.bfloat16


class BatchNorm(nn.Module):
    """Batch norm in eval mode over channel axis 1 (or the rows' last axis
    in the sparse convolutions)."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    @torch.no_grad()
    def reset_running_stats(self) -> None:
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def params(self) -> tuple:
        return self.weight, self.bias, self.running_mean, self.running_var, self.eps

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class SparseConvBN(nn.Module):
    """A sparse convolution without bias, its batch norm and (by default)
    ReLU, over a rulebook. weight (C_out, C_in, kz, ky, kx)."""

    def __init__(self, cin: int, cout: int, kernel=3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *sc.triple(kernel)))
        nn.init.kaiming_uniform_(self.weight)
        self.bn = BatchNorm(cout)

    def forward(self, x, rb, residual=None, relu: bool = True):
        tracing.count("rule_pairs", rb.pairs)
        return sc.sparse_conv(x, rb, self.weight, self.bn.params(), residual, relu)


class SparseBasicBlock(nn.Module):
    """mmdet3d's SparseBasicBlock: two submanifold 3 x 3 x 3 convolutions,
    the input added before the second ReLU."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SparseConvBN(channels, channels)
        self.conv2 = SparseConvBN(channels, channels)

    def forward(self, x, rb):
        return self.conv2(self.conv1(x, rb), rb, residual=x)


class SparseEncoder(nn.Module):
    """mmdet3d's SparseEncoder with basic blocks: voxel features (rows, C)
    -> (B, C_out * D_out, H_out, W_out) float32."""

    def __init__(self, cfg: ModelConfig, in_channels: int = POINT_FEATS):
        super().__init__()
        base = cfg.sparse_base_channels
        self.conv_input = SparseConvBN(in_channels, base)
        self.downs = []                       # (stage, padding) of each stride-2 convolution
        stages, cin = [], base
        last = len(cfg.sparse_encoder_channels) - 1
        for i, blocks in enumerate(cfg.sparse_encoder_channels):
            layers = []
            for j, cout in enumerate(blocks):
                if j == len(blocks) - 1 and i != last:
                    layers.append(SparseConvBN(cin, cout))
                    self.downs.append((i, sc.triple(cfg.sparse_encoder_paddings[i][j])))
                else:
                    layers.append(SparseBasicBlock(cout))
                cin = cout
            stages.append(nn.ModuleList(layers))
        self.encoder_layers = nn.ModuleList(stages)
        self.conv_out = SparseConvBN(cin, cfg.sparse_output_channels, (3, 1, 1))

    def forward(self, vox: vx.Voxels, shape, batch: int):
        level = sc.Level(vox.coords, vox.n[:1], tuple(shape), batch, vox.grid)
        rb = sc.subm_rulebook(level)
        x = self.conv_input(vox.feats, rb)
        downs = dict(self.downs)
        for i, stage in enumerate(self.encoder_layers):
            for layer in stage:
                if isinstance(layer, SparseBasicBlock):
                    x = layer(x, rb)
                else:
                    level, rb_down = sc.strided_level(level, 3, 2, downs[i])
                    x = layer(x, rb_down)
                    rb = sc.subm_rulebook(level)
        level, rb_out = sc.strided_level(level, (3, 1, 1), (2, 1, 1), 0)
        x = self.conv_out(x, rb_out)
        dense = sc.to_dense(x, level)                            # (B, C, D, H, W)
        B, C, D, H, W = dense.shape
        return dense.reshape(B, C * D, H, W)


class ConvBN2d(nn.Module):
    """A 3 x 3 convolution (padding 1, without bias), batch norm and ReLU in
    bfloat16 (float32 parameters)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        nn.init.kaiming_uniform_(self.weight)
        self.bn = BatchNorm(cout)
        self.stride = stride

    def forward(self, x):
        y = F.conv2d(x.to(BF16), self.weight.to(BF16), None, self.stride, 1)
        return F.relu(self.bn(y))


class DeconvBN2d(nn.Module):
    """SECONDFPN's upsampling: a transposed convolution of kernel and stride
    `stride` (without bias; weight (C_in, C_out, s, s)), batch norm and ReLU
    in bfloat16."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, stride, stride))
        nn.init.kaiming_uniform_(self.weight)
        self.bn = BatchNorm(cout)
        self.stride = stride

    def forward(self, x):
        y = F.conv_transpose2d(x.to(BF16), self.weight.to(BF16), None, self.stride)
        return F.relu(self.bn(y))


class SECOND(nn.Module):
    """mmdet3d's SECOND: per block a strided 3 x 3 convolution and
    layer_nums more; -> every block's output."""

    def __init__(self, cfg: ModelConfig, in_channels: int):
        super().__init__()
        blocks, cin = [], in_channels
        for cout, n, s in zip(cfg.second_out_channels, cfg.second_layer_nums,
                              cfg.second_layer_strides):
            blocks.append(nn.ModuleList([ConvBN2d(cin, cout, s)]
                                        + [ConvBN2d(cout, cout) for _ in range(n)]))
            cin = cout
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for block in self.blocks:
            for layer in block:
                x = layer(x)
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """mmdet3d's SECONDFPN: each input upsampled by its stride, the results
    concatenated."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.deblocks = nn.ModuleList([
            DeconvBN2d(cin, cout, s) for cin, cout, s in
            zip(cfg.second_out_channels, cfg.fpn_out_channels, cfg.fpn_upsample_strides)])

    def forward(self, xs):
        return torch.cat([d(x) for d, x in zip(self.deblocks, xs)], dim=1)


class SparseLidarNet(nn.Module):
    """(B, P, 5) points + (B, P) mask -> (B, 512, H / 8, W / 8) float32."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.spec = vx.VoxelSpec.from_config(cfg)
        self.middle_encoder = SparseEncoder(cfg)
        self.backbone = SECOND(cfg, cfg.sparse_output_channels * self.out_depth())
        self.neck = SECONDFPN(cfg)

    def out_depth(self) -> int:
        """The encoder's output z layers (2 at the published shape)."""
        shape = self.spec.shape
        for _, pad in self.middle_encoder.downs:
            shape = sc.conv_out_shape(shape, 3, 2, pad)
        return sc.conv_out_shape(shape, (3, 1, 1), (2, 1, 1), 0)[0]

    def voxelize(self, points, mask) -> vx.Voxels:
        with tracing.span("student_forward.lidar.voxelize"):
            vox = vx.voxelize(points.float().contiguous(), mask.contiguous(), self.spec)
            tracing.count("voxels", vox.n[:1])
            tracing.count("voxels_dropped", vox.n[1:])
        return vox

    def encode(self, vox: vx.Voxels, batch: int):
        """The sparse encoder's dense output (B, 256, 84, 84) float32."""
        with tracing.span("student_forward.lidar.sparse"):
            return self.middle_encoder(vox, self.spec.shape, batch)

    def forward(self, points, mask):
        dense = self.encode(self.voxelize(points, mask), points.shape[0])
        with tracing.span("student_forward.lidar.dense"):
            return self.neck(self.backbone(dense)).float()
