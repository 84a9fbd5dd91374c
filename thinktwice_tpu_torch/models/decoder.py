"""ThinkTwice cascaded look-and-predict decoder (counterpart of
`thinktwice_tpu/models/decoder.py`).

Coarse heads from the flattened BEV and the measurement feature give the
first waypoints and (alpha, beta) controls; `refine_num` cascaded layers
then each roll the 32-channel BEV forward (SpatialGRU), look into the
cameras at the waypoints (deformable attention over the FPN features) and
add offsets to waypoints and controls. Each layer sees its input waypoints
and controls detached, so no gradient flows from one layer's offsets into
the layers before it. With teacher waypoints and controls, a second
cascade through the same layers starts from them (teacher forcing) and
returns its offsets and features. BEV maps are NCHW, feature maps for the
look module NHWC (as `ops/grid_sample.py` takes them). The refine layers
compute in bfloat16 where the JAX package's do; the coarse heads and the
waypoint and control state stay float32.

The lidar look branch's output is zeros, as in the JAX package (which
computes the branch and then replaces it with zeros): its parameters are
held so that an archive loads, and nothing is computed with them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from thinktwice_tpu_torch import tracing
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.models.layers import (
    MLP,
    Conv,
    Dense,
    LayerNorm,
    SEBasicBlock,
)
from thinktwice_tpu_torch.ops.deform_attn import ms_deform_attn
from thinktwice_tpu_torch.ops.grid_sample import grid_sample_norm

LOOK_DIM = 256
LIDAR_HR_CHANNELS = 512
FLAT_DIM = 256          # BEVPyramid's flat feature
MEAS_DIM = 128          # the measurement encoder's output
EMB_DIM = 128           # temporal and static query embeddings


def inv_softplus(x):
    return torch.log(torch.expm1(torch.clamp(x, 1e-4, 20.0)))


class BEVPyramid(nn.Module):
    """Shared BEV flattening pyramid: 32x21x21 -> 64x10x10 -> 128x4x4 ->
    256x2x2 -> 256 features."""

    def __init__(self, dtype=None):
        super().__init__()
        self.conv21_10 = Conv(32, 64, 3, stride=2, padding="VALID", dtype=dtype)
        self.MLP10 = SEBasicBlock(64, 64, dtype=dtype)
        self.conv10_4 = Conv(64, 128, 3, stride=2, padding="VALID", dtype=dtype)
        self.MLP4 = SEBasicBlock(128, 128, dtype=dtype)
        self.conv4_2 = Conv(128, 256, 3, stride=1, padding="VALID", dtype=dtype)
        self.MLP2 = SEBasicBlock(256, 256, dtype=dtype)
        self.Dense_0 = Dense(1024, 512, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(512, dtype=dtype)
        self.Dense_1 = Dense(512, 256, dtype=dtype)

    def forward(self, grid32):
        """grid32 (B, 32, 21, 21) -> (flat (B, 256), mids)."""
        f10 = self.MLP10(F.relu(self.conv21_10(grid32)))
        f4 = self.MLP4(F.relu(self.conv10_4(f10)))
        f2 = self.MLP2(F.relu(self.conv4_2(f4)))
        flat = f2.permute(0, 2, 3, 1).reshape(f2.shape[0], -1)   # (H, W, C) order
        flat = self.LayerNorm_0(F.relu(self.Dense_0(flat)))
        return F.relu(self.Dense_1(flat)), (grid32, f10, f4, f2)


class SpatialGRU(nn.Module):
    """ConvGRU rolled over the future steps."""

    def __init__(self, cin: int, hidden: int = 32, dtype=None):
        super().__init__()
        self.zr = Conv(cin + hidden, 2 * hidden, 3, dtype=dtype)
        self.h = Conv(cin + hidden, hidden, 3, dtype=dtype)

    def forward(self, inputs, state):
        """inputs (B, T, Cin, H, W); state (B, hidden, H, W) ->
        (B, T, hidden, H, W)."""
        h = state
        outs = []
        for t in range(inputs.shape[1]):
            x = inputs[:, t]
            zr = torch.sigmoid(self.zr(torch.cat([x, h], dim=1)))
            z, r = torch.chunk(zr, 2, dim=1)
            cand = torch.tanh(self.h(torch.cat([x, r * h], dim=1)))
            h = (1 - z) * h + z * cand
            outs.append(h)
        return torch.stack(outs, dim=1)


class PredictionModule(nn.Module):
    def __init__(self, first: bool, dtype=None):
        super().__init__()
        self.SpatialGRU_0 = SpatialGRU(6, 32, dtype=dtype)
        self.first = first
        if not first:
            self.Conv_0 = Conv(32, 64, 1, dtype=dtype)
            self.Conv_1 = Conv(64, 32, 3, dtype=dtype)
            self.Conv_2 = Conv(32, 32, 1, dtype=dtype)

    def forward(self, bev32, wp, ctrl_sp, prev_future):
        """bev32 (B, 32, H, W); wp (B, T, 2); ctrl_sp (B, T, 4); prev_future
        (B, T, 32, H, W) or None -> future (B, T, 32, H, W)."""
        B, T = wp.shape[:2]
        Hh, Ww = bev32.shape[-2:]
        cmd = torch.cat([wp, ctrl_sp], dim=-1)[..., None, None].expand(B, T, 6, Hh, Ww)
        future = self.SpatialGRU_0(cmd, bev32)
        if prev_future is not None:
            x = future.reshape(B * T, 32, Hh, Ww)
            h = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
            future = self.Conv_2(h).reshape(B, T, 32, Hh, Ww) + prev_future
        return future


def project_to_cams(points3d, ego2img, img_hw, ida=None):
    """points3d (B, Q, 3) ego frame; ego2img (N, 4, 4) -> normalized camera
    coordinates (B, N, Q, 2) in [0, 1] and a validity mask (B, N, Q). With
    ida (B, N, 4, 4) the pixels map into augmented image space."""
    hom = torch.cat([points3d, torch.ones_like(points3d[..., :1])], dim=-1)
    proj = torch.einsum("nij,bqj->bnqi", ego2img, hom)
    eps = 1e-5
    z = proj[..., 2:3]
    xy = proj[..., 0:2] / torch.clamp_min(z, eps)
    if ida is not None:
        xy = (torch.einsum("bnij,bnqj->bnqi", ida[..., :2, :2], xy)
              + ida[..., None, :2, 3])
    u = xy[..., 0] / img_hw[1]
    v = xy[..., 1] / img_hw[0]
    valid = (z[..., 0] > eps) & (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
    return torch.stack([u, v], dim=-1), valid


class MSDeformAttn(nn.Module):
    """Deformable attention head: heads x levels x points offsets and
    weights predicted from the query."""

    def __init__(self, dim: int = 256, n_heads: int = 8, n_levels: int = 4,
                 n_points: int = 8, dtype=None):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        hlp = n_heads * n_levels * n_points
        self.sampling_offsets = Dense(dim, hlp * 2, dtype=dtype)
        self.attention_weights = Dense(dim, hlp, dtype=dtype)
        self.output_proj = Dense(dim, dim, dtype=dtype)

    def forward(self, query, ref_points, value, spatial_shapes):
        """query (B, Q, dim); ref_points (B, Q, 2) in [0, 1]; value
        (B, sum HW, dim) -> (B, Q, dim)."""
        B, Q, _ = query.shape
        h, lv, p = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).reshape(B, Q, h, lv, p, 2)
        weights = self.attention_weights(query).reshape(B, Q, h, lv * p)
        weights = torch.softmax(weights, dim=-1).reshape(B, Q, h, lv, p)
        # sampling locations stay float32: bfloat16 cannot hold sub-pixel
        # positions on a 128-wide map
        norm = torch.tensor([[wl, hl] for hl, wl in spatial_shapes],
                            dtype=torch.float32, device=query.device)
        locs = (ref_points[:, :, None, None, None, :].float()
                + offsets.float() / norm[None, None, None, :, None, :])
        out = ms_deform_attn(value, spatial_shapes, locs, weights.to(value.dtype))
        return self.output_proj(out)


class SpatialCrossAttention(nn.Module):
    """Per-camera deformable lookup, masked camera reduction and query
    pooling -> one look feature per sample."""

    def __init__(self, query_dim: int, dim: int = 256, n_heads: int = 8, dtype=None):
        super().__init__()
        self.query_proj = Dense(query_dim, dim, dtype=dtype)
        self.deform_attn = MSDeformAttn(dim, n_heads, dtype=dtype)
        self.Dense_0 = Dense(dim, dim, dtype=dtype)
        self.ffn_out = Dense(dim, dim, dtype=dtype)

    def forward(self, queries, ref_cam, valid, value_cams, spatial_shapes):
        """queries (B, N, Q, Dq); ref_cam (B, N, Q, 2); valid (B, N, Q)
        float; value_cams (N, B, sum HW, dim)."""
        N = queries.shape[1]
        q = self.query_proj(queries)
        out = torch.stack([self.deform_attn(q[:, c], ref_cam[:, c], value_cams[c],
                                            spatial_shapes) for c in range(N)], dim=1)
        out = out * valid[..., None].to(out.dtype)
        cnt = torch.clamp_min(valid.sum(dim=1), 1.0)             # (B, Q)
        per_query = out.sum(dim=1) / cnt[..., None].to(out.dtype)
        qv = (valid > 0).any(dim=1).to(out.dtype)                # (B, Q)
        pooled = (per_query * qv[..., None]).sum(dim=1) / torch.clamp_min(
            qv.sum(dim=1, keepdim=True), 1.0)
        return self.ffn_out(F.relu(self.Dense_0(pooled)))


class LookModule(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=None):
        super().__init__()
        self.cfg = cfg
        # the lidar look branch (held for the weights; its output is zeros)
        self.MLP_0 = MLP(2 + 4 + EMB_DIM, [256, LIDAR_HR_CHANNELS], dtype=dtype)
        self.Dense_0 = Dense(LIDAR_HR_CHANNELS, 128, dtype=dtype)
        self.MLP_1 = MLP(9 * 128, [256], final_act=True, dtype=dtype)
        # ctrl 4 + xyz 3 + embedding + measurement + flat feature, then
        # 4 levels of sampled FPN features
        query_dim = 4 + 3 + EMB_DIM + MEAS_DIM + FLAT_DIM + 4 * 256
        self.cam_look = SpatialCrossAttention(query_dim, LOOK_DIM, cfg.n_attn_heads,
                                              dtype=dtype)

    def forward(self, wp, ctrl_sp, measurement, flat_feat, ego2img, fpn_value,
                spatial_shapes, temporal_emb, static_emb, ida=None):
        m = self.cfg
        B, T, _ = wp.shape
        Z = m.n_z_anchors
        dev = wp.device
        static_pts = torch.tensor([[5.0, 0.0], [0.0, -5.0], [0.0, 5.0], [-5.0, 0.0]],
                                  device=dev)
        look_xy = torch.cat([wp, static_pts[None].expand(B, 4, 2)], dim=1)
        P = look_xy.shape[1]
        zs = torch.linspace(-4.0, 10.0, Z, device=dev)
        pts3d = torch.cat([look_xy[:, :, None, :].expand(B, P, Z, 2),
                           zs[None, None, :, None].expand(B, P, Z, 1)],
                          dim=-1).reshape(B, P * Z, 3)
        ctrl_q = torch.cat([ctrl_sp, torch.zeros((B, 4, 4), device=dev)], dim=1)
        emb_q = torch.cat([temporal_emb[None].expand(B, T, -1),
                           static_emb[None].expand(B, 4, -1)], dim=1)
        base_q = torch.cat([
            ctrl_q.repeat_interleave(Z, dim=1), pts3d,
            emb_q.repeat_interleave(Z, dim=1),
            measurement[:, None, :].expand(B, P * Z, -1),
            flat_feat[:, None, :].expand(B, P * Z, -1),
        ], dim=-1)
        ref_cam, valid = project_to_cams(pts3d, ego2img, (m.img_height, m.img_width),
                                         ida)
        N = ref_cam.shape[1]
        sampled = torch.stack([
            torch.cat([grid_sample_norm(fpn_value["maps"][lvl][:, c],
                                        ref_cam[:, c] * 2.0 - 1.0)
                       for lvl in range(len(spatial_shapes))], dim=-1)
            for c in range(N)], dim=1)                             # (B, N, PZ, 4C)
        queries = torch.cat([base_q[:, None].expand(B, N, -1, -1), sampled], dim=-1)
        img_look = self.cam_look(queries, ref_cam, valid.float(), fpn_value["flat"],
                                 spatial_shapes)
        img_look_t = img_look[:, None, :].expand(B, T, LOOK_DIM)
        return torch.cat([img_look_t, torch.zeros_like(img_look_t)], dim=-1)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, first: bool, dtype=None):
        super().__init__()
        T = cfg.pred_len
        self.prediction = PredictionModule(first, dtype=dtype)
        self.look = LookModule(cfg, dtype=dtype)
        width = FLAT_DIM + 2 * LOOK_DIM + EMB_DIM + MEAS_DIM
        self.LayerNorm_0 = LayerNorm(width, dtype=dtype)
        self.MLP_0 = MLP(width, [512, 512], final_act=True, dtype=dtype)
        self.MLP_1 = MLP(2 + 512, [256, 64, 2])
        self.MLP_2 = MLP(4 + 512, [256, 64, 4])
        self.Conv_0 = Conv(32 + T * 512, 128, 3, dtype=dtype)
        self.Conv_1 = Conv(128, 32, 3, dtype=dtype)
        self.MLP_3 = MLP(FLAT_DIM + T * 512, [512, 256], dtype=dtype)

    def forward(self, bev32, wp, ctrl, prev_future, measurement, flat_feat,
                ego2img, fpn_value, spatial_shapes, temporal_emb, static_emb,
                pyramid, ida=None):
        with tracing.span("student_forward.refine"):
            B, T = wp.shape[:2]
            ctrl_sp = F.softplus(ctrl)
            future = self.prediction(bev32, wp, ctrl_sp, prev_future)
            flat_future, _ = pyramid(future.reshape(B * T, *future.shape[2:]))
            flat_future = flat_future.reshape(B, T, -1)
            look = self.look(wp, ctrl_sp, measurement, flat_feat, ego2img, fpn_value,
                             spatial_shapes, temporal_emb, static_emb, ida)
            dt = flat_future.dtype
            x = torch.cat([flat_future, look.to(dt),
                           temporal_emb[None].expand(B, T, -1).to(dt),
                           measurement[:, None, :].expand(B, T, -1).to(dt)], dim=-1)
            x = self.MLP_0(self.LayerNorm_0(x))
            # offset heads in float32: small residuals on the float32 state
            traj_offset = self.MLP_1(torch.cat([wp, x.float()], dim=-1))
            ctrl_offset = self.MLP_2(torch.cat([ctrl, x.float()], dim=-1))

            xf = x.reshape(B, T * 512)
            Hh, Ww = bev32.shape[-2:]
            bev_in = torch.cat([bev32.to(xf.dtype),
                                xf[:, :, None, None].expand(B, T * 512, Hh, Ww)], dim=1)
            new_bev = self.Conv_1(F.relu(self.Conv_0(bev_in))) + bev32
            new_flat = self.MLP_3(torch.cat([flat_feat, xf.to(flat_feat.dtype)], dim=-1)) \
                + flat_feat
            return traj_offset, ctrl_offset, future, new_bev, new_flat


class ThinkTwiceDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=None):
        super().__init__()
        self.cfg = cfg
        T, F_, M = cfg.pred_len, FLAT_DIM, MEAS_DIM
        self.MLP_0 = MLP(F_, [256, 256, 1])                    # pred_speed
        self.join_traj = MLP(F_ + M, [512, 512, 256], final_act=True)
        self.value_traj = MLP(256, [256, 256, 1])
        self.output_traj = MLP(256, [512, T * 2])
        self.join_ctrl = MLP(F_ + M, [512, 512, 256], final_act=True)
        self.value_ctrl = MLP(256, [256, 256, 1])
        self.policy_head = MLP(256, [512, 512], final_act=True)
        self.dist_mu = MLP(512, [512, T * 2])
        self.dist_sigma = MLP(512, [512, T * 2])
        self.temporal_embedding = nn.Parameter(torch.randn(T, EMB_DIM) * 0.02)
        self.static_embedding = nn.Parameter(torch.randn(4, EMB_DIM) * 0.02)
        for i in range(cfg.refine_num):
            setattr(self, f"layer{i}", DecoderLayer(cfg, i == 0, dtype=dtype))

    def forward(self, flat_feat, bev32, measurement, ego2img, fpn_value,
                spatial_shapes: Sequence[tuple[int, int]], pyramid,
                teacher_wp=None, teacher_ctrl_sp=None, ida=None):
        """Returns the outputs (keys as in the JAX package's decoder); with
        teacher_wp (B, T, 2) and teacher_ctrl_sp (B, T, 4) also the teacher
        pass's `teacher_*` outputs."""
        m = self.cfg
        B, T = flat_feat.shape[0], m.pred_len
        outs = {"pred_speed": self.MLP_0(flat_feat)}
        jm = torch.cat([flat_feat, measurement], dim=-1)
        j_traj = self.join_traj(jm)
        outs["pred_value_traj"] = self.value_traj(j_traj)
        outs["pred_features_traj"] = j_traj
        wp = self.output_traj(j_traj).reshape(B, T, 2)
        j_ctrl = self.join_ctrl(jm)
        outs["pred_value_ctrl"] = self.value_ctrl(j_ctrl)
        outs["pred_features_ctrl"] = j_ctrl
        policy = self.policy_head(j_ctrl)
        ctrl = torch.cat([self.dist_mu(policy).reshape(B, T, 2),
                          self.dist_sigma(policy).reshape(B, T, 2)], dim=-1)

        def cascade(wp0, ctrl0):
            """-> (waypoints and controls of every stage, offsets, futures,
            BEVs and flat features of every layer)."""
            wps, ctrls, off_wp, off_ctrl = [wp0], [ctrl0], [], []
            bev, flat, future = bev32, flat_feat, None
            futures, bevs, flats = [], [], []
            for i in range(m.refine_num):
                wp_c, ct_c = wps[-1].detach(), ctrls[-1].detach()
                dwp, dct, future, bev, flat = getattr(self, f"layer{i}")(
                    bev, wp_c, ct_c, future, measurement, flat, ego2img, fpn_value,
                    spatial_shapes, self.temporal_embedding, self.static_embedding,
                    pyramid, ida,
                )
                wps.append(wp_c + dwp)
                ctrls.append(ct_c + dct)
                off_wp.append(dwp)
                off_ctrl.append(dct)
                futures.append(future)
                bevs.append(bev)
                flats.append(flat)
            return wps, ctrls, off_wp, off_ctrl, futures, bevs, flats

        wps, ctrls, _, _, futures, bevs, flats = cascade(wp, ctrl)
        pred_ctrl = torch.clamp_min(F.softplus(torch.stack(ctrls, dim=1)), 1e-3)
        outs["pred_wp"] = torch.stack(wps, dim=1)              # (B, R+1, T, 2)
        outs["mu_branches"] = pred_ctrl[:, :, 0, :2]
        outs["sigma_branches"] = pred_ctrl[:, :, 0, 2:]
        outs["future_mu"] = pred_ctrl[:, :, 1:, :2]
        outs["future_sigma"] = pred_ctrl[:, :, 1:, 2:]
        outs["refine_BEV_feature"] = torch.stack(bevs, dim=1)
        outs["refine_flat_feature"] = torch.stack(flats, dim=1)
        outs["refine_future_BEV_feature"] = torch.stack(futures, dim=1)

        if teacher_wp is not None:
            _, _, off_wp, off_ctrl, futures, bevs, flats = cascade(
                teacher_wp, inv_softplus(teacher_ctrl_sp))
            outs["teacher_pred_wp_offset"] = torch.stack(off_wp, dim=1)
            outs["teacher_pred_ctrl_offset"] = torch.stack(off_ctrl, dim=1)
            outs["teacher_future_BEV_feature"] = torch.stack(futures, dim=1)
            outs["teacher_refine_BEV_feature"] = torch.stack(bevs, dim=1)
            outs["teacher_refine_flat_feature"] = torch.stack(flats, dim=1)
        return outs
