"""The ThinkTwice student: cameras + lidar -> BEV -> cascaded decoder, and
its training losses (counterpart of `thinktwice_tpu/models/encoder_decoder.py`).

Inputs and outputs keep the JAX package's layout: images (B, T, N, H, W, 3)
normalized, depth (B*N, h, w, D) and seg (B*N, H/4, W/4, n_seg) logits, BEV
feature stacks channels last in the bird frame. Inside, maps are NCHW. The
sensor trunks, the fusion convs, MLP21, the BEV pyramid, the FPN projections
and the refine layers compute in bfloat16 with float32 parameters, as in the
JAX package; every output is float32, and so is every loss.

The losses: waypoint smooth-L1 over every refine stage, Beta KL of the
current (x15) and future (x3.75) actions, speed, value and feature
regressions, the Roach feature distillation at the 21/10/4/2 grids and of
every refine and teacher layer (smooth-L1 clamped at 5), the teacher
offsets pulled to zero, depth classification and segmentation focal loss.
`distil_weight` (a scalar or one per example) weights the distillation
terms; the `metric_*` entries are diagnostics outside the loss.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from thinktwice_tpu_torch import tracing
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.models.decoder import BEVPyramid, ThinkTwiceDecoder
from thinktwice_tpu_torch.models.layers import MLP, Conv, ConvGN, SEBasicBlock
from thinktwice_tpu_torch.models.lidarnet import LidarNet
from thinktwice_tpu_torch.models.lss import DOWNSAMPLE, MultiSweepLSS
from thinktwice_tpu_torch.models.sparse_lidarnet import SparseLidarNet

BF16 = torch.bfloat16
FPN_CHANNELS = 256
LIDAR_CHANNELS = 512
BEV_STACKS = ("refine_BEV_feature", "refine_future_BEV_feature",
              "teacher_future_BEV_feature", "teacher_refine_BEV_feature")


def bev_to_bird(bev):
    """(.., C, ny, nx) metric BEV (x forward along columns, y right along
    rows) -> the bird orientation (row 0 farthest ahead, column = right)."""
    return torch.flip(bev.transpose(-1, -2), dims=(-2,))


def lidar_encoder(cfg: ModelConfig) -> nn.Module:
    """The LiDAR encoder cfg.lidar_encoder names: "pillar" (LidarNet) or
    "sparse" (SparseLidarNet, the published one)."""
    if cfg.lidar_encoder == "pillar":
        return LidarNet(cfg)
    if cfg.lidar_encoder == "sparse":
        return SparseLidarNet(cfg)
    raise ValueError(f"unknown lidar_encoder {cfg.lidar_encoder!r}: 'pillar' or 'sparse'")


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
        self.lidar_encoder = lidar_encoder(cfg)
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
        with tracing.span("student_forward"):
            B, N = imgs.shape[0], cam2ego.shape[0]
            with tracing.span("student_forward.trunk"):
                cam_out = self.img_encoder(imgs, cam2ego, intrinsics, sweep2key=sweep2key,
                                           ida=ida)
            with tracing.span("student_forward.lidar"):
                lid = bev_to_bird(self.lidar_encoder(points, points_mask))  # (B, 512, 84, 84)
                pts_red = self.ConvGN_3(self.ConvGN_2(lid))

            with tracing.span("student_forward.fusion"):
                cam_bev = bev_to_bird(cam_out["bev"]).to(BF16)         # (B, C, 21, 21)
                state = torch.cat([speed[:, None], target_point, command], dim=-1)
                measurement = self.measurements_encoder(state)

                cam_red = F.relu(self.ConvGN_1(self.ConvGN_0(cam_bev)) + cam_bev)
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
                    # channels last in memory, once a forward: the look
                    # module's point sampler reads each tap's channels in a run
                    f = f.reshape(B, N, FPN_CHANNELS, h, w).permute(0, 1, 3, 4, 2).contiguous()
                    maps.append(f)                                     # (B, N, h, w, 256)
                    fv = (f.reshape(B, N, h * w, FPN_CHANNELS)
                          + self.cams_embeds[None, :, None, :].to(BF16)
                          + self.level_embeds[None, None, None, lvl].to(BF16))
                    flat_vals.append(fv)
                value_cams = torch.cat(flat_vals, dim=2).transpose(0, 1)   # (N, B, sumHW, 256)
                fpn_value = {"maps": maps, "flat": value_cams}

            with tracing.span("student_forward.decoder"):
                outs = self.decoder(flat_feat, grid32, measurement, ego2img, fpn_value,
                                    spatial_shapes, self.bev_pyramid, teacher_wp=teacher_wp,
                                    teacher_ctrl_sp=teacher_ctrl_sp, ida=ida)
            # the fusion's second call: maps leave in the JAX package's
            # channels-last layout, every output in float32
            with tracing.span("student_forward.fusion"):
                outs["depth"] = cam_out["depth"].permute(0, 2, 3, 1)
                outs["seg"] = cam_out["seg"].permute(0, 2, 3, 1)
                for key in BEV_STACKS:
                    if key in outs:
                        outs[key] = outs[key].movedim(-3, -1)
                outs["mid_feature"] = tuple(m.float().permute(0, 2, 3, 1) for m in mids)
                outs["measurement"] = measurement
                return {k: (v.float() if torch.is_tensor(v) and v.dtype == BF16 else v)
                        for k, v in outs.items()}


# --------------------------------------------------------------------------
# losses


def smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def clamped_sl1(x, cap: float = 5.0):
    """Elementwise smooth-L1 clamped at `cap` (the distillation terms)."""
    return torch.clamp_max(smooth_l1(x), cap)


def beta_kl(a1, b1, a2, b2):
    """KL( Beta(a1, b1) || Beta(a2, b2) ), elementwise."""
    lg, dg = torch.lgamma, torch.digamma
    lbeta = (lg(a2) + lg(b2) - lg(a2 + b2)) - (lg(a1) + lg(b1) - lg(a1 + b1))
    return (lbeta + (a1 - a2) * dg(a1) + (b1 - b2) * dg(b1)
            + (a2 - a1 + b2 - b1) * dg(a1 + b1))


def beta_mode_01(alpha, beta):
    """The mode of Beta(alpha, beta) on [0, 1] (the mean where no interior
    mode exists)."""
    mode = (alpha - 1) / torch.clamp_min(alpha + beta - 2, 1e-9)
    mean = alpha / torch.clamp_min(alpha + beta, 1e-5)
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.where(
        (alpha > 1) & (beta > 1), mode,
        torch.where((alpha <= 1) & (beta > 1), zero,
                    torch.where((alpha > 1) & (beta <= 1), one, mean)))


WP_LOSS_WEIGHT = 15.0
ACTION_LOSS_WEIGHT = 15.0
FUTURE_ACTION_WEIGHT = 15.0 / 4.0
SPEED_WEIGHT = 0.05
VALUE_WEIGHT = 0.001
FEATURES_WEIGHT = 0.05
DISTIL_WEIGHTS = (0.25, 1.0 / 3.0, 0.25, 1.0 / 11.0)  # per Roach grid 21/10/4/2
TEACHER_OFFSET_WEIGHT = 1.0
DEPTH_WEIGHT = 3.0
SEG_WEIGHT = 1.0


def _ranks_sum(x, group):
    """x summed over the ranks of group (x itself without one). Used on the
    denominators of the batch-normalized terms, which are data: no
    gradient flows through them."""
    return x if group is None else group.all_sum(x)


def decoder_loss(cfg: ModelConfig, outs: dict, batch: dict, group=None) -> dict:
    """batch keys: gt_waypoints (B, T, 2), action_alpha/beta (B, 2),
    future_action_alpha/beta (B, T-1, 2), gt_speed (B,), gt_value (B,),
    roach_features (B, 256), roach_cnn (4 grids, bird frame, channels
    last), future_roach_cnn21 (B, T, 21, 21, 32), distil_weight (scalar or
    (B,)), each optional where the JAX package's is. With a group the
    batch is this rank's rows, and each term is the rank's share of the
    global batch's term (see total_loss)."""
    losses = {}
    pred_wp = outs["pred_wp"]                                  # (B, R+1, T, 2)
    losses["wp_loss"] = WP_LOSS_WEIGHT * torch.mean(
        smooth_l1(pred_wp - batch["gt_waypoints"][:, None]))

    a_p, b_p = outs["mu_branches"], outs["sigma_branches"]    # (B, R+1, 2)
    a_g = torch.clamp_min(batch["action_alpha"], 1e-3)[:, None]
    b_g = torch.clamp_min(batch["action_beta"], 1e-3)[:, None]
    losses["action_loss"] = ACTION_LOSS_WEIGHT * torch.mean(beta_kl(a_g, b_g, a_p, b_p))

    if "future_action_alpha" in batch:
        fa_g = torch.clamp_min(batch["future_action_alpha"], 1e-3)[:, None]
        fb_g = torch.clamp_min(batch["future_action_beta"], 1e-3)[:, None]
        losses["future_action_loss"] = FUTURE_ACTION_WEIGHT * torch.mean(
            beta_kl(fa_g, fb_g, outs["future_mu"], outs["future_sigma"]))

    losses["speed_loss"] = SPEED_WEIGHT * torch.mean(
        torch.abs(outs["pred_speed"][:, 0] - batch["gt_speed"]))
    v = batch["gt_value"]
    losses["value_loss"] = VALUE_WEIGHT * (
        torch.mean((outs["pred_value_traj"][:, 0] - v) ** 2)
        + torch.mean((outs["pred_value_ctrl"][:, 0] - v) ** 2))

    # distil_weight gates the Roach-feature terms (a mirrored example has 0:
    # conv features are not mirror-equivariant); per example, the weighted
    # mean renormalizes by the examples that keep their weight
    dw = torch.as_tensor(batch.get("distil_weight", 1.0), dtype=torch.float32,
                         device=pred_wp.device)

    n_ranks = 1 if group is None else group.size
    if dw.dim() > 0:
        dw_sum = _ranks_sum(torch.sum(dw), group)

    def wmean(x):
        per_ex = torch.mean(x, dim=tuple(range(1, x.dim())))
        if dw.dim() == 0:
            return dw * torch.mean(per_ex)
        return torch.sum(dw * per_ex) * n_ranks / torch.clamp_min(dw_sum, 1e-6)

    if "roach_features" in batch:
        rf = batch["roach_features"]
        losses["features_loss"] = FEATURES_WEIGHT * (
            wmean((outs["pred_features_traj"] - rf) ** 2)
            + wmean((outs["pred_features_ctrl"] - rf) ** 2))
    if "roach_cnn" in batch:
        distil = 0.0
        for w, pred, gt in zip(DISTIL_WEIGHTS, outs["mid_feature"], batch["roach_cnn"]):
            distil = distil + w * wmean((pred - gt) ** 2)
        losses["distil_loss"] = distil
        cnn21 = batch["roach_cnn"][0]                          # (B, 21, 21, 32)
        if "refine_BEV_feature" in outs:
            losses["refine_BEV_feature_loss"] = DISTIL_WEIGHTS[0] * wmean(
                clamped_sl1(outs["refine_BEV_feature"] - cnn21[:, None]))
        if "roach_features" in batch and "refine_flat_feature" in outs:
            losses["refine_flattened_feature_loss"] = FEATURES_WEIGHT * 0.1 * wmean(
                clamped_sl1(outs["refine_flat_feature"] - batch["roach_features"][:, None]))

    if "teacher_pred_wp_offset" in outs:
        losses["teacher_offset_loss"] = TEACHER_OFFSET_WEIGHT * (
            torch.mean(outs["teacher_pred_wp_offset"] ** 2)
            + torch.mean(outs["teacher_pred_ctrl_offset"] ** 2))
        if "future_roach_cnn21" in batch and "teacher_future_BEV_feature" in outs:
            # (B, R, T, 21, 21, 32) against the future frames' grids
            losses["teacher_future_BEV_feature_loss"] = DISTIL_WEIGHTS[0] * wmean(
                clamped_sl1(outs["teacher_future_BEV_feature"]
                            - batch["future_roach_cnn21"][:, None]))
        if "roach_cnn" in batch and "teacher_refine_BEV_feature" in outs:
            losses["teacher_refine_BEV_feature_loss"] = DISTIL_WEIGHTS[0] * wmean(
                clamped_sl1(outs["teacher_refine_BEV_feature"]
                            - batch["roach_cnn"][0][:, None]))
        if "roach_features" in batch and "teacher_refine_flat_feature" in outs:
            losses["teacher_refine_flattened_feature_loss"] = FEATURES_WEIGHT * wmean(
                clamped_sl1(outs["teacher_refine_flat_feature"]
                            - batch["roach_features"][:, None]))

    # open-loop diagnostics, outside the loss
    with torch.no_grad():
        act = beta_mode_01(a_p[:, -1], b_p[:, -1]) * 2.0 - 1.0
        act_gt = beta_mode_01(a_g[:, 0], b_g[:, 0]) * 2.0 - 1.0
        wp_err = pred_wp[:, -1] - batch["gt_waypoints"]
        losses["metric_current_throttle_brake_offset"] = torch.mean(
            torch.abs(act[:, 0] - act_gt[:, 0]))
        losses["metric_steer_offset"] = torch.mean(torch.abs(act[:, 1] - act_gt[:, 1]))
        losses["metric_longitudinal_offset"] = torch.mean(torch.abs(wp_err[..., 0]))
        losses["metric_lateral_offset"] = torch.mean(torch.abs(wp_err[..., 1]))
    return losses


def depth_loss(cfg: ModelConfig, depth_logits, gt_depth, group=None):
    """Per-cell depth classification: the ground-truth depth (BN, H, W)
    meters, 0 invalid, min-pooled over each DOWNSAMPLE window, binned and
    scored by cross-entropy on the valid cells. depth_logits (BN, h, w, D).
    With a group: this rank's share of the mean over every rank's valid
    cells."""
    BN, h, w, D = depth_logits.shape
    ds = DOWNSAMPLE
    g = gt_depth[:, :h * ds, :w * ds].reshape(BN, h, ds, w, ds)
    g = torch.where(g > 0, g, torch.full_like(g, float("inf")))
    g = torch.amin(g, dim=(2, 4))
    valid = torch.isfinite(g) & (g >= cfg.depth_min)
    g = torch.where(valid, g, torch.full_like(g, cfg.depth_min))
    bins = torch.clamp(((g - cfg.depth_min) / cfg.depth_step).to(torch.int64), 0, D - 1)
    logp = torch.log_softmax(depth_logits, dim=-1)
    nll = -torch.gather(logp, -1, bins[..., None])[..., 0]
    n_ranks = 1 if group is None else group.size
    return (DEPTH_WEIGHT * torch.sum(nll * valid) * n_ranks
            / torch.clamp_min(_ranks_sum(valid.sum(), group), 1.0))


def seg_focal_loss(seg_logits, gt_seg, gamma: float = 2.0, alpha: float = 0.25):
    """Focal loss: seg_logits (BN, h, w, K), gt_seg (BN, h, w) int labels."""
    logp = torch.log_softmax(seg_logits, dim=-1)
    lp = torch.gather(logp, -1, gt_seg.to(torch.int64)[..., None])[..., 0]
    p = torch.exp(lp)
    return SEG_WEIGHT * torch.mean(-alpha * (1 - p) ** gamma * lp)


def total_loss(cfg: ModelConfig, outs: dict, batch: dict, group=None):
    """-> (loss, dict of every term, the metrics and `loss`).

    group: a `parallel.launch.Group` when batch is this rank's shard of a
    global batch (`train_step.shard_batch`). Two terms divide by a sum that
    depends on the batch: the distillation terms' weighted mean (by
    distil_weight, 0 on a mirrored example) and the depth NLL's mean over
    the valid cells. Their denominators are summed over the ranks, so each
    rank returns its share of the global term and the mean over the ranks
    is the global batch's loss, as the JAX package computes it on its
    mesh. Every other term is a plain mean over equal shards."""
    losses = decoder_loss(cfg, outs, batch, group)
    if "gt_depth" in batch:
        losses["depth_loss"] = depth_loss(cfg, outs["depth"], batch["gt_depth"], group)
    if "gt_seg" in batch:
        losses["seg_loss"] = seg_focal_loss(outs["seg"], batch["gt_seg"])
    total = sum(v for k, v in losses.items() if not k.startswith("metric_"))
    losses["loss"] = total
    return total, losses
