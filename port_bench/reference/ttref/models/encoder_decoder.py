"""The ThinkTwice student: cameras + lidar -> BEV -> cascaded decoder
(counterpart of `thinktwice_tpu/models/encoder_decoder.py`).

Inputs and outputs keep the JAX package's layout: images (B, T, N, H, W, 3)
normalized, depth (B*N, h, w, D) and seg (B*N, H/4, W/4, n_seg) logits, BEV
feature stacks channels last in the bird frame. Inside, maps are NCHW. The
sensor trunks, the fusion convs, MLP21, the BEV pyramid, the FPN projections
and the refine layers compute in bfloat16 with float32 parameters, as in the
JAX package; every output is float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from port_bench.reference.ttref.config import ModelConfig
from port_bench.reference.ttref.models.decoder import BEVPyramid, ThinkTwiceDecoder
from port_bench.reference.ttref.models.layers import MLP, Conv, ConvGN, SEBasicBlock
from port_bench.reference.ttref.models.lidarnet import LidarNet
from port_bench.reference.ttref.models.lss import MultiSweepLSS

BF16 = torch.bfloat16
FPN_CHANNELS = 256
LIDAR_CHANNELS = 512
BEV_STACKS = ("refine_BEV_feature", "refine_future_BEV_feature",
              "teacher_future_BEV_feature", "teacher_refine_BEV_feature")


def bev_to_bird(bev):
    """(.., C, ny, nx) metric BEV (x forward along columns, y right along
    rows) -> the bird orientation (row 0 farthest ahead, column = right)."""
    return torch.flip(bev.transpose(-1, -2), dims=(-2,))


class ThinkTwiceModel(nn.Module):
    """Camera and lidar fusion with the lidar look branch off, as every
    model the JAX package builds (its use_lidar=True, use_lidar_look=False)."""

    def __init__(self, cfg: ModelConfig, backbone_depth: int = 50, n_sweeps: int = 1,
                 n_cams: int = 4):
        super().__init__()
        self.cfg, self.n_sweeps = cfg, n_sweeps
        C = cfg.bev_channels
        self.img_encoder = MultiSweepLSS(cfg, backbone_depth, n_sweeps)
        self.measurements_encoder = MLP(1 + 2 + 6, [128, 128], final_act=True)
        self.ConvGN_0 = ConvGN(C, C, dtype=BF16)
        self.ConvGN_1 = ConvGN(C, C, act=False, dtype=BF16)
        self.lidar_encoder = LidarNet(cfg)
        self.ConvGN_2 = ConvGN(LIDAR_CHANNELS, C, stride=2, dtype=BF16)
        self.ConvGN_3 = ConvGN(C, C, stride=2, dtype=BF16)
        self.ConvGN_4 = ConvGN(C, C, act=False, dtype=BF16)
        self.ConvGN_5 = ConvGN(2 * C, C, dtype=BF16)
        self._256_to_32 = Conv(C, 32, 3, dtype=BF16)
        self.MLP21 = SEBasicBlock(32, 32, dtype=BF16)
        self.bev_pyramid = BEVPyramid(dtype=BF16)
        self.cams_embeds = nn.Parameter(torch.randn(n_cams, FPN_CHANNELS) * 0.02)
        self.level_embeds = nn.Parameter(torch.randn(4, FPN_CHANNELS) * 0.02)
        for lvl in range(4):
            setattr(self, f"fpn_linear{lvl}", Conv(FPN_CHANNELS, FPN_CHANNELS, 1,
                                                   dtype=BF16))
        self.decoder = ThinkTwiceDecoder(cfg, dtype=BF16)

    def forward(self, imgs, points, points_mask, speed, target_point, command,
                cam2ego, intrinsics, ego2img, teacher_wp=None, teacher_ctrl_sp=None,
                sweep2key=None, ida=None):
        """imgs (B, T, N, H, W, 3) normalized; points (B, P, 5); points_mask
        (B, P); speed (B,); target_point (B, 2); command (B, 6) one-hot;
        cam2ego (N, 4, 4); intrinsics (3, 3); ego2img (N, 4, 4); optional:
        teacher_wp (B, T, 2) and teacher_ctrl_sp (B, T, 4) (teacher forcing),
        sweep2key (B, T, 4, 4), ida (B, N, 4, 4). -> dict of float32
        outputs."""
        B, N = imgs.shape[0], cam2ego.shape[0]
        cam_out = self.img_encoder(imgs, cam2ego, intrinsics, sweep2key=sweep2key,
                                   ida=ida)
        cam_bev = bev_to_bird(cam_out["bev"]).to(BF16)         # (B, C, 21, 21)

        state = torch.cat([speed[:, None], target_point, command], dim=-1)
        measurement = self.measurements_encoder(state)

        cam_red = F.relu(self.ConvGN_1(self.ConvGN_0(cam_bev)) + cam_bev)
        lid = bev_to_bird(self.lidar_encoder(points, points_mask))  # (B, 512, 84, 84)
        pts_red = self.ConvGN_3(self.ConvGN_2(lid))
        f = self.ConvGN_4(self.ConvGN_5(torch.cat([cam_red, pts_red], dim=1)))
        bev_feats = F.relu(f + cam_red + pts_red)

        grid32 = self.MLP21(F.relu(self._256_to_32(bev_feats))).float()
        flat_feat, mids = self.bev_pyramid(grid32)
        flat_feat = flat_feat.float()

        fpn = cam_out["fpn_feats"]
        spatial_shapes = tuple(tuple(f.shape[-2:]) for f in fpn)
        maps, flat_vals = [], []
        for lvl, f in enumerate(fpn):
            f = getattr(self, f"fpn_linear{lvl}")(f)           # (B*N, 256, h, w) bf16
            h, w = f.shape[-2:]
            f = f.reshape(B, N, FPN_CHANNELS, h, w).permute(0, 1, 3, 4, 2)
            maps.append(f)                                     # (B, N, h, w, 256)
            fv = (f.reshape(B, N, h * w, FPN_CHANNELS)
                  + self.cams_embeds[None, :, None, :].to(BF16)
                  + self.level_embeds[None, None, None, lvl].to(BF16))
            flat_vals.append(fv)
        value_cams = torch.cat(flat_vals, dim=2).transpose(0, 1)   # (N, B, sumHW, 256)
        fpn_value = {"maps": maps, "flat": value_cams}

        outs = self.decoder(flat_feat, grid32, measurement, ego2img, fpn_value,
                            spatial_shapes, self.bev_pyramid, teacher_wp=teacher_wp,
                            teacher_ctrl_sp=teacher_ctrl_sp, ida=ida)
        # maps leave in the JAX package's channels-last layout
        outs["depth"] = cam_out["depth"].permute(0, 2, 3, 1)
        outs["seg"] = cam_out["seg"].permute(0, 2, 3, 1)
        for key in BEV_STACKS:
            if key in outs:
                outs[key] = outs[key].movedim(-3, -1)
        outs["mid_feature"] = tuple(m.float().permute(0, 2, 3, 1) for m in mids)
        outs["measurement"] = measurement
        return {k: (v.float() if torch.is_tensor(v) and v.dtype == BF16 else v)
                for k, v in outs.items()}


