"""The comparison that decides `correct` in the student's closed loop with
its published sparse LiDAR encoder.

It is the student loop's comparison (`student_check.py`: `camera_gap`,
`lidar_gap`, `sensor_flips`, `model_gap`, `fusion_gap`, `world_gap`,
`world_flips`), the reference's model carrying the plain reference encoder
(`ttref/models/sparse_lidarnet.py`) in its LiDAR slot: ttref's frozen
ModelConfig has no encoder fields, so the encoder takes the configuration
file's `sparse_lidar` settings itself. Two numbers judge the encoder alone,
at each checked tick, on the program's own points (the points and mask its
encoder took):

- `voxel_flips`: the program's voxels against the reference's sequential
  voxelization of those points, as sets keyed by (world, z, y, x): a voxel
  on one side only, or a voxel whose kept point indices or count differ,
  counts one;
- `encoder_gap`: the program's dense encoder output (B, 256, 84, 84)
  against the reference encoder's on those points, the largest absolute
  difference over the reference's largest magnitude. Both are float32 and
  differ by their sums' order alone.

The control (`control=True`) puts the reference one precision lower in the
program's place, as in the student loop: float8 operands for the bfloat16
matrix work, and the sparse encoder in bfloat16.
"""

from __future__ import annotations

import torch

from port_bench.reference.configs import make_config
from port_bench.reference.roach_check import convert, tf32, to_bf16, tree_gap
from port_bench.reference.seeded import seeded_params
from port_bench.reference.student_check import _call, _gap, _lidar_gap
from port_bench.reference.ttref import config as ref_config
from port_bench.reference.ttref.agents import thinktwice_driver as ref_ttd
from port_bench.reference.ttref.agents.expert import _target_point
from port_bench.reference.ttref.models import layers
from port_bench.reference.ttref.models import rig as ref_rig
from port_bench.reference.ttref.models.encoder_decoder import ThinkTwiceModel
from port_bench.reference.ttref.models.layers import lower_precision
from port_bench.reference.ttref.models.sparse_lidarnet import RefSparseLidarNet
from port_bench.reference.ttref.rollout import grid_world
from port_bench.reference.ttref.sim import step as ref_step


def reference_config(conf: dict, traffic: dict):
    return make_config(conf, traffic, ref_config)


def reference_model(conf: dict, cfg, seed: int, device) -> ThinkTwiceModel:
    """ttref's student with the reference sparse encoder in its LiDAR slot
    (the same place in the parameters' order as the program's)."""
    with torch.device("meta"):
        model = ThinkTwiceModel(cfg.model, backbone_depth=conf["backbone_depth"],
                                n_sweeps=conf["n_sweeps"], n_cams=cfg.camera.n_cams)
    model = model.to_empty(device=device).eval()
    with torch.device(device):
        model.lidar_encoder = RefSparseLidarNet(conf["sparse_lidar"]).eval()
    seeded_params(model, seed, device)
    return model


class _DenseStages(torch.nn.Module):
    """The LiDAR slot for counting FLOPs: SECOND and SECONDFPN on a zero
    dense map of the encoder's output shape, no sparse stage."""

    def __init__(self, enc: RefSparseLidarNet):
        super().__init__()
        self.enc = enc

    def forward(self, points, mask):
        s = self.enc.s
        D, H, W = s["sparse_shape"]
        C = self.enc.backbone.blocks[0][0].weight.shape[1]
        dense = torch.zeros((points.shape[0], C, H // 8, W // 8), device=points.device)
        return self.enc.neck(self.enc.backbone(dense)).float()


def reference_forward(conf: dict, cfg, B: int, device):
    """-> fn() running the reference model's forward once on zero inputs of
    the driver's shapes at B worlds, its LiDAR slot the dense stages alone
    (for counting FLOPs: the sparse convolutions are counted from their
    rulebooks' pairs, never as the reference's dense conv3d)."""
    model = reference_model(conf, cfg, 0, device)
    model.lidar_encoder = _DenseStages(model.lidar_encoder)
    cam, lid = cfg.camera, cfg.lidar
    T, P = conf["n_sweeps"], lid.n_beams * lid.n_azimuth
    z = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    args = (z(B, T, cam.n_cams, cam.height, cam.width, 3), z(B, T * P, 5),
            z(B, T * P, dtype=torch.bool), z(B), z(B, 2), z(B, 6),
            torch.as_tensor(ref_rig.cam_to_ego(cam), device=device),
            torch.as_tensor(ref_rig.intrinsics(cam), device=device),
            torch.as_tensor(ref_rig.ego_to_img(cam), device=device))
    s2k = torch.eye(4, device=device).expand(B, T, 4, 4).contiguous() if T > 1 else None

    @torch.no_grad()
    def fn():
        model(*args, sweep2key=s2k)

    return fn


def _voxel_sets(judged, ref: list, shape) -> int:
    """Voxels on one side only, or with other kept points or count: the
    program's Voxels (capacity rows, the count on the device) against the
    reference's per-world voxels."""
    D, H, W = shape
    n = int(judged.n[0])
    c = judged.coords[:n].long().cpu()
    idx, cnt = judged.point_idx[:n].long().cpu(), judged.counts[:n].long().cpu()
    flips = 0
    for b, r in enumerate(ref):
        mine = c[:, 0] == b
        k1 = ((c[mine, 1] * H + c[mine, 2]) * W + c[mine, 3])
        k2 = ((r["coords"][:, 0] * H + r["coords"][:, 1]) * W + r["coords"][:, 2])
        s1, p1 = torch.sort(k1)
        s2, p2 = torch.sort(k2)
        in2 = torch.isin(s1, s2)
        in1 = torch.isin(s2, s1)
        flips += int((~in2).sum()) + int((~in1).sum())
        a = torch.cat([idx[mine][p1][in2], cnt[mine][p1][in2, None]], 1)
        b_ = torch.cat([r["point_idx"][p2][in1], r["counts"][p2][in1, None]], 1)
        flips += int((a != b_).any(1).sum())
    return flips


def _memo(enc: RefSparseLidarNet):
    """Let the reference encoder reuse its voxels and dense output for the
    same points and mask (the driver's calls read the points the encoder
    checks already took): the same inputs give the same result."""
    real_vox, real_enc = enc.voxelize, enc.encode
    voxels, dense = [], []

    def voxelize(points, mask):
        for p, m, out in voxels:
            if p.shape == points.shape and torch.equal(p, points) and torch.equal(m, mask):
                return out
        out = real_vox(points, mask)
        voxels.append((points, mask, out))
        return out

    def encode(vox, device):
        for v, lower, out in dense:
            if v is vox and lower == layers._Lower.on:
                return out
        out = real_enc(vox, device)
        dense.append((vox, layers._Lower.on, out))
        return out

    enc.voxelize, enc.encode = voxelize, encode


@torch.no_grad()
def check(conf: dict, traffic: dict, seed: int, device, state0, captures, lidar_captures,
          control: bool = False) -> dict:
    """{number: (value, limit)} over the captured calls (as the student
    loop's) and the encoder's captures, each (points, mask, voxels, dense
    output)."""
    device = torch.device(device)
    limits = traffic["limits"]
    with tf32(False):
        cfg = reference_config(conf, traffic)
        model = reference_model(conf, cfg, seed, device)
        enc = model.lidar_encoder
        _memo(enc)
        voxel_flips, encoder_gap = 0, 0.0
        for points, mask, vox, dense in lidar_captures:
            ref_vox = enc.voxelize(points, mask)
            ref_dense = enc.encode(ref_vox, device)
            if control:
                lower_precision(True)
                try:
                    dense = enc.encode(ref_vox, device)
                finally:
                    lower_precision(False)
            else:
                voxel_flips += _voxel_sets(vox, ref_vox, conf["sparse_lidar"]["sparse_shape"])
            scale = max(float(ref_dense.abs().max()), 1e-30)
            encoder_gap = max(encoder_gap, float((dense - ref_dense).abs().max()) / scale)
        g = torch.Generator(device=device).manual_seed(seed)
        if traffic["town"]["kind"] != "grid":
            raise ValueError(f"unknown town kind {traffic['town']['kind']!r}")
        town, ref0 = grid_world(cfg, traffic["worlds"], traffic["vehicles"], device=device,
                                generator=g)
        policy = ref_ttd.make_thinktwice_driver(cfg, model)
        world_gap, world_flips = tree_gap(state0, ref0)
        cam_gap = lidar_gap = model_gap = fusion_gap = 0.0
        flips = 0
        for (state, agent, tick, hist, sdraws, cams, lidar, outs, ctrl, draws,
             after) in captures:
            s, sd, ag = convert(state), convert(sdraws), convert(agent)
            r_cams, r_lidar, r_outs, _ = _call(policy, model, town, s, ag, tick, hist, sd)
            if control:
                lower_precision(True)
                try:
                    _, _, outs, ctrl = _call(policy, model, town, s, ag, tick, hist, sd)
                finally:
                    lower_precision(False)
                cams = {k: to_bf16(v) for k, v in r_cams.items()}
                lidar = (to_bf16(r_lidar[0]), r_lidar[1])
            gap, n = _gap(cams, r_cams)
            cam_gap, flips = max(cam_gap, gap), flips + n
            gap, n = _lidar_gap(lidar, r_lidar)
            lidar_gap, flips = max(lidar_gap, gap), flips + n
            gap, n = _gap(outs, r_outs)
            model_gap, flips = max(model_gap, gap), flips + n
            fused, _ = ref_ttd.controls_from_outputs(outs, ag, s.ego.speed, _target_point(s))
            if control:
                ctrl = to_bf16(fused)
            fusion_gap = max(fusion_gap, float((ctrl - fused).abs().max()))
            ref_after, _ = ref_step.step_world(cfg, town, s, ctrl, draws=convert(draws))
            gap, n = tree_gap(to_bf16(ref_after) if control else after, ref_after)
            world_gap, world_flips = max(world_gap, gap), world_flips + n
    numbers = {"camera_gap": cam_gap, "lidar_gap": lidar_gap, "sensor_flips": flips,
               "model_gap": model_gap, "fusion_gap": fusion_gap, "world_gap": world_gap,
               "world_flips": world_flips, "voxel_flips": voxel_flips,
               "encoder_gap": encoder_gap}
    return {k: (v, limits[k]) for k, v in numbers.items()}
