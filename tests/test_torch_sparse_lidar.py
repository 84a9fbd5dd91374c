"""The student's published LiDAR encoder on the CPU: the plain versions of
K5 (hard voxelization and the VFE) and K6 (sparse convolution over
rulebooks), `SparseLidarNet` and the whole student forward with it, each
against an independent definition: a per-point loop of mmdet3d's
sequential voxelization, dense masked `conv3d`, and the benchmark's plain
reference (`port_bench/reference/ttref/models/sparse_lidarnet.py`) on
seeded weights. And `student_rl6`'s model, whose default LiDAR encoder is
the pillar grid, keeps its module tree and parameters.
"""

import dataclasses

import pytest
import torch
from torch.nn import functional as F

from port_bench.reference import seeded
from port_bench.reference.ttref import config as ref_config
from port_bench.reference.ttref.models import encoder_decoder as ref_ed
from port_bench.reference.ttref.models.sparse_lidarnet import RefSparseLidarNet
from thinktwice_tpu_torch.config import SPARSE_LIDAR_FIELDS, CameraConfig, ModelConfig
from thinktwice_tpu_torch.models import rig
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel
from thinktwice_tpu_torch.models.lidarnet import LidarNet
from thinktwice_tpu_torch.models.sparse_lidarnet import SparseLidarNet
from thinktwice_tpu_torch.ops import sparse_conv as sc
from thinktwice_tpu_torch.ops import voxelize as vx

torch.set_num_threads(1)

# a 41 x 64 x 64 grid over 38.4 m at the published channel widths
GRID = dict(lidar_encoder="sparse", sparse_voxel_size=(0.6, 0.6, 0.2), sparse_shape=(41, 64, 64))
SMALL = dict(img_height=32, img_width=64, refine_num=1, pred_len=2, bev_channels=64,
             n_depth_bins=16, lidar_pillar_grid=84, n_z_anchors=5, n_attn_heads=4)


def settings(cfg: ModelConfig) -> dict:
    """The encoder's settings, as the configuration file's `sparse_lidar`."""
    return {k: getattr(cfg, k) for k in SPARSE_LIDAR_FIELDS if k != "lidar_encoder"}


def cloud(B, P, seed, spread=6.0, x0=2.0, dup=300):
    """Points (B, P, 5) in a box ahead of the car, the first `dup` of each
    world packed into one voxel (past the 10-point cap), and a mask."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(B, P, 3, generator=g) * torch.tensor([spread, spread, 4.0]) \
        + torch.tensor([x0, -spread / 2, -1.5])
    pts = torch.cat([xyz, torch.rand(B, P, 2, generator=g)], -1)
    pts[:, :dup, :3] = pts[:, :1, :3] + 0.01 * torch.rand(B, dup, 3, generator=g)
    pts[:, -50:, 0] = 100.0                                     # outside the range
    return pts, torch.rand(B, P, generator=g) > 0.1


def sequential(points, mask, spec: vx.VoxelSpec):
    """mmdet3d's definition as a loop over the points of one world ->
    [(z, y, x), [kept point indices]] in voxel id order."""
    voxels, ids = [], {}
    for p in range(points.shape[0]):
        if not bool(mask[p]):
            continue
        c = [int(torch.floor((points[p, i] - spec.lo[i]) / spec.size[i])) for i in range(3)]
        if not all(0 <= c[i] < spec.cells[i] for i in range(3)):
            continue
        key = (c[2], c[1], c[0])
        if key not in ids:
            if len(voxels) == spec.max_voxels:
                continue
            ids[key] = len(voxels)
            voxels.append((key, []))
        kept = voxels[ids[key]][1]
        if len(kept) < spec.max_points:
            kept.append(p)
    return voxels


@pytest.mark.parametrize("max_voxels", [160_000, 150])
def test_plain_voxelize_matches_the_sequential_definition(max_voxels):
    cfg = ModelConfig(**GRID, sparse_max_voxels=max_voxels)
    spec = vx.VoxelSpec.from_config(cfg)
    pts, mask = cloud(2, 1500, seed=1)
    vox = vx.voxelize_plain(pts, mask, spec)
    row, dropped = 0, 0
    for b in range(2):
        want = sequential(pts[b], mask[b], spec)
        for key, kept in want:
            assert tuple(vox.coords[row].tolist()) == (b, *key)
            assert vox.counts[row] == len(kept)
            assert vox.point_idx[row, :len(kept)].tolist() == kept
            assert (vox.point_idx[row, len(kept):] == -1).all()
            mean = pts[b, kept].sum(0) / len(kept)
            assert torch.allclose(vox.feats[row], mean, rtol=0, atol=1e-6)
            row += 1
        all_voxels = sequential(pts[b], mask[b], dataclasses.replace(spec, max_voxels=10**9))
        dropped += len(all_voxels) - len(want)
    assert vox.n.tolist() == [row, dropped] and vox.coords.shape[0] == row
    assert vox.counts.max() == 10                               # the point cap bit
    if max_voxels == 150:
        assert dropped > 0 and row == 300                       # the voxel cap bit


def _dense_conv(x, level, weight, kernel, stride, padding, out_level, bn, residual, relu):
    """The convolution as dense conv3d over the grid, read at out_level's sites."""
    dense = sc.to_dense_plain(x, level)
    y = F.conv3d(dense, weight, None, stride, padding)
    c = out_level.coords.long()
    y = y[c[:, 0], :, c[:, 1], c[:, 2], c[:, 3]]
    bw, bb, mean, var, eps = bn
    y = (y - mean) / torch.sqrt(var + eps) * bw + bb
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("kind,kernel,stride,padding", [
    ("subm", 3, 1, 1), ("down", 3, 2, 1), ("down", 3, 2, (0, 1, 1)),
    ("down", (3, 1, 1), (2, 1, 1), 0)])
def test_plain_sparse_conv_matches_dense_conv3d(kind, kernel, stride, padding):
    cfg = ModelConfig(**GRID)
    vox = vx.voxelize_plain(*cloud(2, 1500, seed=2), vx.VoxelSpec.from_config(cfg))
    level = sc.Level(vox.coords, vox.n[:1], cfg.sparse_shape, 2)
    g = torch.Generator().manual_seed(3)
    cin, cout = 16, 32
    x = torch.randn(level.coords.shape[0], cin, generator=g)
    k = kernel if isinstance(kernel, tuple) else (kernel,) * 3
    weight = torch.randn(cout, cin, *k, generator=g) / 10
    bn = (torch.rand(cout, generator=g) + 0.5, torch.randn(cout, generator=g),
          torch.randn(cout, generator=g), torch.rand(cout, generator=g) + 0.5, 1e-3)
    if kind == "subm":
        out_level, rb = level, sc.subm_rulebook(level)
        residual = torch.randn(level.coords.shape[0], cout, generator=g)
    else:
        out_level, rb = sc.strided_level(level, kernel, stride, padding)
        residual = None
        mask = F.max_pool3d(sc.to_dense_plain(torch.ones(len(level.coords), 1), level),
                            kernel, stride, padding)[:, 0]
        assert out_level.coords.shape[0] == int(mask.sum())
        keys = sc._keys(out_level.coords, out_level.shape)
        assert (keys[1:] > keys[:-1]).all()                     # linear order
    assert int(rb.pairs) == int((rb.nbr >= 0).sum())
    got = sc.sparse_conv_plain(x, rb, weight, bn, residual, relu=True)
    want = _dense_conv(x, level, weight, kernel, stride, padding, out_level, bn, residual, True)
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_sparse_lidarnet_matches_the_reference():
    cfg = ModelConfig(**GRID)
    net = SparseLidarNet(cfg).eval()
    ref = RefSparseLidarNet(settings(cfg)).eval()
    assert [p.shape for p in net.parameters()] == [p.shape for p in ref.parameters()]
    seeded.seeded_params(net, 11, "cpu")
    seeded.seeded_params(ref, 11, "cpu")
    pts, mask = cloud(2, 2500, seed=4)
    with torch.no_grad():
        enc = net.encode(net.voxelize(pts, mask), 2)
        ref_enc = ref.encode(ref.voxelize(pts, mask), "cpu")
        out, ref_out = net(pts, mask), ref(pts, mask)
    assert enc.shape == (2, 256, 8, 8) and out.shape == (2, 512, 8, 8)
    assert float(ref_enc.abs().max()) > 0
    assert float((enc - ref_enc).abs().max()) <= 1e-5 * float(ref_enc.abs().max())
    assert float((out - ref_out).abs().max()) <= 2e-2 * float(ref_out.abs().max())


def _inputs(B, P, seed):
    cam = CameraConfig(height=32, width=64)
    g = torch.Generator().manual_seed(seed)
    pts, mask = cloud(B, P, seed, spread=3.0, x0=4.0)
    return (torch.randn(B, 1, 4, 32, 64, 3, generator=g), pts, mask,
            torch.rand(B, generator=g) * 5, torch.rand(B, 2, generator=g) * 20,
            torch.eye(6)[[3, 1]][:B], torch.as_tensor(rig.cam_to_ego(cam)),
            torch.as_tensor(rig.intrinsics(cam)), torch.as_tensor(rig.ego_to_img(cam)))


def test_student_forward_with_the_sparse_encoder_matches_the_reference():
    """The whole student at small widths with the published LiDAR encoder
    (the 41 x 672 x 672 grid) against the reference's model with the
    reference encoder in its place, on the same seeded weights. The
    encoders' float32 sums round in another order, and the bfloat16 stages
    after them carry that to every output (up to ~8% of an output's scale
    here); given the port's LiDAR features, the rest of the forward is the
    reference's bit for bit."""
    cfg = ModelConfig(**SMALL, lidar_encoder="sparse")
    model = ThinkTwiceModel(cfg, backbone_depth=10, n_sweeps=1).eval()
    assert isinstance(model.lidar_encoder, SparseLidarNet)
    ref = ref_ed.ThinkTwiceModel(ref_config.ModelConfig(**SMALL), backbone_depth=10,
                                 n_sweeps=1).eval()
    ref.lidar_encoder = RefSparseLidarNet(settings(cfg)).eval()
    names = [n for n, _ in model.named_parameters()]
    assert names == [n for n, _ in ref.named_parameters()]
    seeded.seeded_params(model, 5, "cpu")
    seeded.seeded_params(ref, 5, "cpu")
    inputs = _inputs(2, 2000, seed=6)
    with torch.no_grad():
        lid = model.lidar_encoder(inputs[1], inputs[2])
        ref_lid = ref.lidar_encoder(inputs[1], inputs[2])
        outs, ref_outs = model(*inputs), ref(*inputs)
        ref.lidar_encoder = model.lidar_encoder
        shared = ref(*inputs)
    assert lid.shape == (2, 512, 84, 84) and float(ref_lid.abs().max()) > 0
    assert float((lid - ref_lid).abs().max()) <= 2e-2 * float(ref_lid.abs().max())
    for k, v in ref_outs.items():
        if torch.is_tensor(v) and v.is_floating_point():
            scale = max(float(v.abs().max()), 1e-3)
            assert float((outs[k] - v).abs().max()) <= 0.15 * scale, k
            assert torch.equal(outs[k], shared[k]), k


def test_student_rl6_keeps_its_module_tree():
    """The default LiDAR encoder is the pillar grid: the model's parameter
    names, shapes and order are the reference's frozen copy's, and
    student_rl6's widths build LidarNet."""
    model = ThinkTwiceModel(ModelConfig(**SMALL), backbone_depth=10, n_sweeps=2)
    ref = ref_ed.ThinkTwiceModel(ref_config.ModelConfig(**SMALL), backbone_depth=10,
                                 n_sweeps=2)
    assert isinstance(model.lidar_encoder, LidarNet)
    assert [(n, p.shape) for n, p in model.named_parameters()] == \
        [(n, p.shape) for n, p in ref.named_parameters()]
    assert not list(model.buffers())
    with pytest.raises(ValueError, match="lidar_encoder"):
        ThinkTwiceModel(ModelConfig(**SMALL, lidar_encoder="dense"), backbone_depth=10)


def test_the_sparse_student_drives_the_closed_loop_and_the_evaluator():
    """`make_model`, `rollout_thinktwice` and the student evaluator take the
    configuration with lidar_encoder "sparse" and nothing else changed: a
    tiny two-sweep student over 2 grid worlds."""
    import numpy as np

    from thinktwice_tpu_torch.agents.thinktwice_driver import (
        make_student_policy, rollout_thinktwice)
    from thinktwice_tpu_torch.config import Config, LidarConfig, SimConfig
    from thinktwice_tpu_torch.harness.evaluator import evaluate_routes
    from thinktwice_tpu_torch.maps.procedural import make_grid_town
    from thinktwice_tpu_torch.rollout import grid_routes, grid_world
    from thinktwice_tpu_torch.train.loop import make_model

    cfg = Config(sim=SimConfig(max_vehicles=8, max_walkers=4, max_route_len=256,
                               max_scenarios=4),
                 camera=CameraConfig(height=32, width=64),
                 lidar=LidarConfig(n_beams=4, n_azimuth=64),
                 model=ModelConfig(**SMALL, lidar_encoder="sparse"))
    model = make_model(cfg, backbone_depth=10, n_sweeps=2, device="cpu").eval()
    assert isinstance(model.lidar_encoder, SparseLidarNet)
    bn = model.lidar_encoder.middle_encoder.conv_input.bn
    assert torch.equal(bn.running_var, torch.ones(16)) and not bn.running_mean.any()
    seeded.seeded_params(model, 9, "cpu")
    g = torch.Generator().manual_seed(9)
    town, state = grid_world(cfg, 2, 4, device="cpu", generator=g)
    final, _, controls = rollout_thinktwice(cfg, town, model, state, 2, generator=g,
                                            hist_len=2)
    assert len(controls) == 2 and all(bool(torch.isfinite(c).all()) for c in controls)
    assert int(final.tick[0]) == 2
    policy_fn, policy_init = make_student_policy(cfg, model, policy_every=1)
    town = make_grid_town(n_blocks=2, block=100.0, device="cpu")
    routes = list(grid_routes(2, cfg.sim.max_route_len))
    log = []
    record = evaluate_routes(cfg, town, routes, ["a", "b"], policy_fn, policy_init=policy_init,
                             n_vehicles=4, max_steps=2, worlds_per_batch=2, segment_steps=2,
                             batch_log=log)
    assert [b["ticks"] for b in log] == [2]
    assert all(np.isfinite(v) for v in record["scores"].values())
