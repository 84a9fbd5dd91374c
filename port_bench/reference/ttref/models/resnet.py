"""ResNet backbone and PAFPN neck with GroupNorm (counterpart of
`thinktwice_tpu/models/resnet.py`), NCHW.

Depths 10 and 18 use BasicBlock, 50 uses Bottleneck (the student_rl6
archive). `blocks[k]` holds the flax module `Checkpoint<Block>_k` (the
backbone's blocks are rematerialized there, which prefixes their names).
"""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from port_bench.reference.ttref.models.layers import Conv, ConvGN, GroupNorm


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, dtype=None):
        super().__init__()
        self.ConvGN_0 = ConvGN(cin, features, stride=stride, dtype=dtype)
        self.ConvGN_1 = ConvGN(features, features, act=False, dtype=dtype)
        self.shortcut = stride != 1 or cin != features
        if self.shortcut:
            self.ConvGN_2 = ConvGN(cin, features, kernel=1, stride=stride,
                                   act=False, dtype=dtype)

    def forward(self, x):
        h = self.ConvGN_1(self.ConvGN_0(x))
        if self.shortcut:
            x = self.ConvGN_2(x)
        return F.relu(x + h)


class Bottleneck(nn.Module):
    """Output (expanded) width `features`, inner width features // 4."""

    def __init__(self, cin: int, features: int, stride: int = 1, dtype=None):
        super().__init__()
        inner = features // 4
        self.ConvGN_0 = ConvGN(cin, inner, kernel=1, dtype=dtype)
        self.ConvGN_1 = ConvGN(inner, inner, stride=stride, dtype=dtype)
        self.ConvGN_2 = ConvGN(inner, features, kernel=1, act=False, dtype=dtype)
        self.shortcut = stride != 1 or cin != features
        if self.shortcut:
            self.ConvGN_3 = ConvGN(cin, features, kernel=1, stride=stride,
                                   act=False, dtype=dtype)

    def forward(self, x):
        h = self.ConvGN_2(self.ConvGN_1(self.ConvGN_0(x)))
        if self.shortcut:
            x = self.ConvGN_3(x)
        return F.relu(x + h)


RESNET_SPECS = {
    10: (BasicBlock, (1, 1, 1, 1), (32, 64, 128, 256)),
    18: (BasicBlock, (2, 2, 2, 2), (64, 128, 256, 512)),
    34: (BasicBlock, (3, 4, 6, 3), (64, 128, 256, 512)),
    50: (Bottleneck, (3, 4, 6, 3), (256, 512, 1024, 2048)),
}


class ResNet(nn.Module):
    """-> list of 4 feature maps at strides 4, 8, 16, 32."""

    def __init__(self, depth: int = 50, dtype=None):
        super().__init__()
        block, layers, widths = RESNET_SPECS[depth]
        self.Conv_0 = Conv(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(16, 64, dtype=dtype)
        blocks, self.stage_ends, cin = [], [], 64
        for i, (n, w) in enumerate(zip(layers, widths)):
            for j in range(n):
                blocks.append(block(cin, w, stride=2 if (i > 0 and j == 0) else 1,
                                    dtype=dtype))
                cin = w
            self.stage_ends.append(len(blocks) - 1)
        self.blocks = nn.ModuleList(blocks)
        self.widths = widths

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for k, blk in enumerate(self.blocks):
            x = blk(x)
            if k in self.stage_ends:
                outs.append(x)
        return outs


def _upsample(x, hw):
    """Integer nearest upsampling (the only kind the FPN meets)."""
    h, w = x.shape[-2:]
    if hw[0] % h or hw[1] % w:
        return x
    return x.repeat_interleave(hw[0] // h, dim=-2).repeat_interleave(hw[1] // w, dim=-1)


class PAFPN(nn.Module):
    """Path-aggregation FPN: lateral 1x1, top-down sum, 3x3 smoothing,
    bottom-up stride-2 path, 3x3 outputs. -> 4 maps of `out_channels`."""

    def __init__(self, in_channels, out_channels: int = 256, dtype=None):
        super().__init__()
        n, c = len(in_channels), out_channels
        convs = [Conv(cin, c, 1, dtype=dtype) for cin in in_channels]
        convs += [Conv(c, c, 3, dtype=dtype) for _ in range(n)]
        convs += [Conv(c, c, 3, stride=2, dtype=dtype) for _ in range(n - 1)]
        convs += [Conv(c, c, 3, dtype=dtype) for _ in range(n)]
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
        self.n = n

    def forward(self, feats):
        n = self.n
        conv = [getattr(self, f"Conv_{i}") for i in range(4 * n - 1)]
        lats = [conv[i](f) for i, f in enumerate(feats)]
        td = [None] * n
        td[-1] = lats[-1]
        for i in range(n - 2, -1, -1):
            td[i] = lats[i] + _upsample(td[i + 1], lats[i].shape[-2:])
        td = [conv[n + i](f) for i, f in enumerate(td)]
        out = [td[0]]
        for i in range(1, n):
            out.append(td[i] + conv[2 * n + i - 1](out[i - 1]))
        return [conv[3 * n - 1 + i](f) for i, f in enumerate(out)]

