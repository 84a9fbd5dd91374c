"""LSS camera encoder: lift-splat-shoot with camera-aware depth (counterpart
of `thinktwice_tpu/models/lss.py`), NCHW inside.

ResNet + PAFPN features, a DepthNet at stride 16 (camera-parameter SE
conditioning, residual blocks, ASPP) giving depth logits and context, a
UNet-style segmentation head whose features are re-injected at stride 16,
and the frustum pooled onto the BEV grid by `ops/voxel_pool.lift_splat_pool`.
The trunks compute in bfloat16 like the JAX package's; geometry, the depth
softmax and the pooling stay float32.

The history sweeps run without gradients, as the JAX package's
stop_gradient has them. An optional `ida`
(B, N, 4, 4), the augmented-from-raw pixel transforms of train/augment.py,
maps the frustum's pixels back before unprojection and conditions the
depth net.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from port_bench.reference.ttref.config import ModelConfig
from port_bench.reference.ttref.models.layers import Conv, ConvGN, Dense, resize_nearest
from port_bench.reference.ttref.models.resnet import PAFPN, ResNet
from port_bench.reference.ttref.ops.voxel_pool import lift_splat_pool

DOWNSAMPLE = 16  # DepthNet operates on the stride-16 FPN level
BF16 = torch.bfloat16
N_CAM_PARAMS = 27  # intrinsics 9 + ida 6 + extrinsics 12


class ASPP(nn.Module):
    """Atrous pyramid with dilations 1/2/3 and global pooling."""

    def __init__(self, cin: int, features: int = 256, dtype=None):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 1, dtype=dtype)
        self.Conv_1 = Conv(cin, features, 3, dilation=2, dtype=dtype)
        self.Conv_2 = Conv(cin, features, 3, dilation=3, dtype=dtype)
        self.Conv_3 = Conv(cin, features, 1, dtype=dtype)
        self.Conv_4 = Conv(4 * features, features, 1, dtype=dtype)

    def forward(self, x):
        branches = [self.Conv_0(x), self.Conv_1(x), self.Conv_2(x)]
        gp = self.Conv_3(torch.mean(x, dim=(-2, -1), keepdim=True))
        branches.append(gp.expand_as(branches[0]))
        return F.relu(self.Conv_4(torch.cat(branches, dim=1)))


class DepthNet(nn.Module):
    """Stride-16 feature -> (depth logits, context), SE-conditioned on the
    flattened camera parameters."""

    def __init__(self, cin: int, n_depth_bins: int, context_channels: int,
                 mid_channels: int = 256, dtype=None):
        super().__init__()
        m = mid_channels
        self.ConvGN_0 = ConvGN(cin, m, dtype=dtype)
        self.Dense_0 = Dense(N_CAM_PARAMS, m, dtype=dtype)
        self.Dense_1 = Dense(m, m, dtype=dtype)
        self.Conv_0 = Conv(m, context_channels, 1, dtype=dtype)
        for i in range(1, 7):
            setattr(self, f"ConvGN_{i}", ConvGN(m, m, act=i % 2 == 1, dtype=dtype))
        self.ASPP_0 = ASPP(m, m, dtype=dtype)
        self.Conv_1 = Conv(m, n_depth_bins, 1, dtype=dtype)

    def forward(self, x, cam_params):
        """x (B*N, Cin, h, w); cam_params (B*N, 27)."""
        x = self.ConvGN_0(x)
        se = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(cam_params))))
        x = x * se[:, :, None, None]
        context = self.Conv_0(x)
        d = x
        for i in (1, 3, 5):
            h = getattr(self, f"ConvGN_{i + 1}")(getattr(self, f"ConvGN_{i}")(d))
            d = F.relu(d + h)
        return self.Conv_1(self.ASPP_0(d)), context


class SegHead(nn.Module):
    """UNet-ish head over the 4 FPN levels -> logits at 1/4 input resolution
    and 64-channel re-injection features."""

    def __init__(self, n_classes: int, fpn_channels: int = 256, dtype=None):
        super().__init__()
        for i in range(3):   # the upsampled map (256) beside the skip level
            setattr(self, f"ConvGN_{i}", ConvGN(256 + fpn_channels, 256, dtype=dtype))
        self.Conv_0 = Conv(256, n_classes, 1, dtype=dtype)
        self.ConvGN_3 = ConvGN(256, 64, dtype=dtype)

    def forward(self, fpn_feats):
        x = fpn_feats[-1]
        for i, skip in enumerate(fpn_feats[-2::-1]):
            x = resize_nearest(x, skip.shape[-2:])
            x = getattr(self, f"ConvGN_{i}")(torch.cat([x, skip], dim=1))
        return self.Conv_0(x), self.ConvGN_3(x)


def make_frustum(cfg: ModelConfig, h: int, w: int, device=None):
    """(D, h, w, 3) of (u_px, v_px, depth_m) at feature-cell centres."""
    D = cfg.n_depth_bins
    ds = cfg.depth_min + cfg.depth_step * torch.arange(D, dtype=torch.float32,
                                                       device=device)
    us = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * DOWNSAMPLE
    vs = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * DOWNSAMPLE
    return torch.stack([us[None, None, :].expand(D, h, w),
                        vs[None, :, None].expand(D, h, w),
                        ds[:, None, None].expand(D, h, w)], dim=-1)


def frustum_to_ego(frustum, cam2ego, intrin_inv, ida=None):
    """frustum (D, h, w, 3); cam2ego (N, 4, 4); intrin_inv (3, 3) -> ego
    xyz (N, D, h, w, 3). With ida (B, N, 4, 4) the frustum's pixels live in
    augmented image space and go back through ida^-1 first -> (B, N, D, h,
    w, 3)."""
    u, v, d = frustum[..., 0], frustum[..., 1], frustum[..., 2]
    if ida is not None:
        a = ida[..., None, None, None, :, :]
        det = a[..., 0, 0] * a[..., 1, 1]
        u = (u - a[..., 0, 3]) * (a[..., 1, 1] / det)
        v = (v - a[..., 1, 3]) * (a[..., 0, 0] / det)
        d = d.expand_as(u)
    pix = torch.stack([u * d, v * d, d], dim=-1)
    cam = torch.einsum("ij,...j->...i", intrin_inv, pix)
    rot = (cam2ego[:, None, None, None, :3, :3] @ cam[..., None])[..., 0]
    return rot + cam2ego[:, None, None, None, :3, 3]


class LSS(nn.Module):
    """Multi-camera -> BEV."""

    def __init__(self, cfg: ModelConfig, backbone_depth: int = 50):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(backbone_depth, dtype=BF16)
        self.neck = PAFPN(self.backbone.widths, 256, dtype=BF16)
        self.seg_head = SegHead(cfg.n_seg_classes, 256, dtype=BF16)
        self.seg_reinject = Conv(64, 256, 1, dtype=BF16)
        self.depth_net = DepthNet(256, cfg.n_depth_bins, cfg.bev_channels,
                                  dtype=BF16)

    def forward(self, imgs, cam2ego, intrinsics, ego2key=None, ida=None):
        """imgs (B, N, H, W, 3) normalized; cam2ego (N, 4, 4); intrinsics
        (3, 3); ego2key (B, 4, 4) the optional transform from this sweep's
        ego frame into the key frame; ida (B, N, 4, 4) the optional pixel
        augmentation. -> dict bev (B, C, ny, nx) float32,
        fpn_feats list of (B*N, 256, h, w) float32, depth logits
        (B*N, D, h, w) and seg logits (B*N, n_seg, H/4, W/4) float32."""
        m = self.cfg
        B, N, H, W, _ = imgs.shape
        x = imgs.reshape(B * N, H, W, 3).permute(0, 3, 1, 2).to(BF16)
        fpn = self.neck(self.backbone(x))
        seg, seg_feat = self.seg_head(fpn)
        f16 = fpn[2]
        h, w = f16.shape[-2:]
        f16 = f16 + self.seg_reinject(F.avg_pool2d(seg_feat, 4, 4))

        dev = imgs.device
        if ida is None:
            ida_entries = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                                       device=dev).expand(B * N, 6)
        else:
            ida_entries = ida[..., [0, 0, 0, 1, 1, 1], [0, 1, 3, 0, 1, 3]].reshape(B * N, 6)
        cam_params = torch.cat([
            intrinsics.reshape(1, 9).expand(B * N, 9),
            ida_entries,
            cam2ego[:, :3, :].reshape(N, 12).repeat(B, 1),
        ], dim=-1)
        depth_logits, context = self.depth_net(f16, cam_params)
        depth_logits = depth_logits.float()
        context = context.float()
        depth_prob = torch.softmax(depth_logits, dim=1)          # (B*N, D, h, w)

        D = m.n_depth_bins
        frustum = make_frustum(m, h, w, dev)
        geom = frustum_to_ego(frustum, cam2ego, torch.linalg.inv(intrinsics), ida)
        geom = geom.reshape(-1, N, D, h * w, 3)
        if ego2key is not None:
            # frustum points move into the key frame before pooling, so a
            # history sweep's BEV lands on the key sweep's cells
            geom = (torch.einsum("bij,bndpj->bndpi", ego2key[:, :3, :3],
                                 geom.expand(B, -1, -1, -1, -1))
                    + ego2key[:, None, None, None, :3, 3])
        cell = (m.bev_x_max - m.bev_x_min) / m.bev_size
        bev = lift_splat_pool(
            geom, depth_prob.reshape(B, N, D, h * w),
            context.reshape(B, N, -1, h * w).transpose(-1, -2),
            x_min=m.bev_x_min, y_min=m.bev_y_min, cell=cell,
            nx=m.bev_size, ny=m.bev_size, z_min=-4.0, z_max=10.0,
        )
        return {
            "bev": bev.permute(0, 3, 1, 2),
            "fpn_feats": [f.float() for f in fpn],
            "depth": depth_logits,
            "seg": seg.float(),
        }


class MultiSweepLSS(nn.Module):
    """Key frame plus history sweeps through one LSS, their BEVs merged by a
    1x1 conv. The history sweeps carry no gradient."""

    def __init__(self, cfg: ModelConfig, backbone_depth: int = 50, n_sweeps: int = 1):
        super().__init__()
        self.lss = LSS(cfg, backbone_depth)
        self.n_sweeps = n_sweeps
        if n_sweeps > 1:
            self.sweep_merge = Conv(n_sweeps * cfg.bev_channels, cfg.bev_channels, 1)

    def forward(self, imgs_sweeps, cam2ego, intrinsics, sweep2key=None, ida=None):
        """imgs_sweeps (B, T, N, H, W, 3), the key sweep last; sweep2key
        (B, T, 4, 4) the optional per-sweep ego(t) -> ego(key) transforms;
        ida (B, N, 4, 4) the optional pixel augmentation of every sweep."""
        out = self.lss(imgs_sweeps[:, -1], cam2ego, intrinsics, ida=ida)
        if self.n_sweeps > 1:
            bevs = [out["bev"]]
            for t in range(self.n_sweeps - 1):
                e2k = None if sweep2key is None else sweep2key[:, t]
                with torch.no_grad():
                    bevs.append(self.lss(imgs_sweeps[:, t], cam2ego, intrinsics,
                                         ego2key=e2k, ida=ida)["bev"])
            out["bev"] = self.sweep_merge(torch.cat(bevs, dim=1))
        return out
