"""PyTorch port on the card: each CUDA kernel against its plain version (K1
the birdview rasterizer, K2 the ray-vs-box intersector), also on a frame
collected for training, on a table of an imported town's size and on one
at the Longest6 evaluation's 508 vehicle slots, the
card's world step against the CPU's, one train step of a tiny student,
and one small PPO and BC iterate of the
Roach expert (K1 on their rollouts), on the card against the CPU, a
data-parallel step over a 1-rank NCCL and a 2-rank gloo group on the card
against the one-process step, and the sparse LiDAR encoder's kernels (K5
the voxelizer, K6 the sparse convolution and K7 its rulebooks) against
their plain versions at the closed loop's size. These tests need an NVIDIA card and skip
without one; they import no JAX, so on a machine with a card and no JAX
they run with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, ModelConfig, SimConfig
from thinktwice_tpu_torch.ops import birdview_cuda as k1
from thinktwice_tpu_torch.ops import raycast_cuda as k2
from thinktwice_tpu_torch.rollout import grid_world
from thinktwice_tpu_torch.sensors.birdview import birdview_inputs
from thinktwice_tpu_torch.sim.state import tree_map
from thinktwice_tpu_torch.sim.step import sample_step_draws, step_world

torch.set_num_threads(1)

CFG = Config(sim=SimConfig(max_vehicles=16, max_walkers=8, max_lights=64,
                           max_stop_signs=8, max_route_len=256, max_scenarios=8))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _on(x, device):
    return tree_map(lambda t: t.to(device), x)


@pytest.mark.cuda
def test_k1_matches_plain_on_card(card):
    g = torch.Generator().manual_seed(0)
    town, state = grid_world(CFG, 4, 12, device="cpu", generator=g)
    for _ in range(6):
        state, _ = step_world(CFG, town, state, torch.tensor([[0.0, 0.5, 0.0]] * 4),
                              generator=g)
    prims, ego = birdview_inputs(CFG.birdview, town, state)
    prims, ego = prims.to(card), ego.to(card)
    before = k1.K1.launches
    bits = k1.birdview_bits(CFG.birdview, prims, ego)
    torch.cuda.synchronize()
    assert k1.K1.launches == before + 1
    assert torch.equal(bits, k1.birdview_bits_plain(CFG.birdview, prims, ego))
    assert torch.equal(bits.cpu(), k1.birdview_bits_plain(CFG.birdview, prims.cpu(), ego.cpu()))


@pytest.mark.cuda
def test_k1_pixel_on_a_box_edge_matches_plain_on_card(card):
    """One world for each birdview row whose distance ahead of the ego,
    (W - ev_bottom - r) / ppm, rounds differently when taken as a product
    with 1 / ppm: the ego at the origin facing +x, and a box whose front
    edge lies at the smaller of the two values. Row r is covered or not by
    that rounding alone, so K1, its plain version on the card and on the
    CPU agree only if all three divide."""
    cfg = CFG.birdview
    W = cfg.width
    ahead = float(W) - float(cfg.pixels_ev_to_bottom) - torch.arange(W, dtype=torch.float32)
    exact = ahead / torch.tensor(cfg.pixels_per_meter)
    by_inverse = ahead * torch.tensor(1.0 / cfg.pixels_per_meter, dtype=torch.float32)
    rows = torch.nonzero((exact != by_inverse) & (ahead > 0))[:, 0]
    assert len(rows) > 0
    n = len(rows)
    prims = torch.zeros((n, 1, 8))
    prims[:, 0, 0] = 1.0                                   # a box, bit 0
    prims[:, 0, 4] = 1.0                                   # cos 1, sin 0
    prims[:, 0, 6] = torch.minimum(exact, by_inverse)[rows]
    prims[:, 0, 7] = 100.0
    ego = torch.tensor([[0.0, 0.0, 1.0, 0.0]]).expand(n, 4).contiguous()
    on_cpu = k1.birdview_bits_plain(cfg, prims, ego)
    bits = k1.birdview_bits(cfg, prims.to(card), ego.to(card))
    torch.cuda.synchronize()
    assert torch.equal(bits.cpu(), on_cpu)
    assert torch.equal(k1.birdview_bits_plain(cfg, prims.to(card), ego.to(card)).cpu(), on_cpu)
    covered = on_cpu[torch.arange(n), rows].bool().all(dim=-1)
    assert torch.equal(covered, exact[rows] <= by_inverse[rows])


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(card):
    g = torch.Generator().manual_seed(0)
    town, state = grid_world(CFG, 2, 4, device="cpu", generator=g)
    prims, ego = birdview_inputs(CFG.birdview, town, state)
    prims, ego = prims.to(card), ego.to(card)
    with pytest.raises(ValueError, match="float32"):
        k1.birdview_bits(CFG.birdview, prims.double(), ego)
    with pytest.raises(ValueError, match="contiguous"):
        k1.birdview_bits(CFG.birdview, prims.transpose(0, 1).contiguous().transpose(0, 1), ego)


@pytest.mark.cuda
def test_step_world_on_card_matches_cpu(card):
    g = torch.Generator().manual_seed(1)
    town, state = grid_world(CFG, 4, 12, device="cpu", generator=g)
    town_d, state_d = town.to(card), _on(state, card)
    ctrl = torch.tensor([[0.05, 0.7, 0.0]] * 4)
    for _ in range(10):
        draws = sample_step_draws(town, state, g)
        state, _ = step_world(CFG, town, state, ctrl, draws=draws)
        state_d, _ = step_world(CFG, town_d, state_d, ctrl.to(card), draws=_on(draws, card))
    torch.testing.assert_close(state_d.traffic.pos.cpu(), state.traffic.pos, rtol=0, atol=1e-3)
    torch.testing.assert_close(state_d.ego.pos.cpu(), state.ego.pos, rtol=0, atol=1e-3)
    assert torch.equal(state_d.traffic.wp_idx.cpu(), state.traffic.wp_idx)


def _ray_scene(R, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((3, R, 3), generator=g) * torch.tensor([60.0, 60.0, 3.0])
    d = torch.randn((3, R, 3), generator=g)
    d[:, : R // 8, 0] = 0.0
    d[:, R // 8: R // 4, 2] = 1e-12
    d = d / d.norm(dim=-1, keepdim=True)
    pose = torch.cat([torch.rand((3, N, 2), generator=g) * 60,
                      torch.rand((3, N, 1), generator=g) * 6,
                      torch.rand((3, N, 2), generator=g) * 2 + 0.2,
                      torch.rand((3, N, 1), generator=g) * 2 + 1,
                      torch.rand((3, N, 1), generator=g) * 0.5], dim=-1)
    pose[:, 1] = pose[:, 0]                       # a tie on every ray
    # a quarter of the rays aim at box 0's centre, so every scene has hits
    aim = torch.cat([pose[:, :1, :2], pose[:, :1, 5:6] * 0.5], dim=-1) - o[:, : R // 4]
    d[:, : R // 4] = aim / aim.norm(dim=-1, keepdim=True)
    active = torch.rand((3, N), generator=g) > 0.2
    active[:, 0] = True
    return o, d, k2.box_table(pose, active)


@pytest.mark.cuda
@pytest.mark.parametrize("R,N", [(5000, 40), (256 * 7 + 77, 300), (33, 2)])
def test_k2_matches_plain_on_card(card, R, N):
    o, d, table = _ray_scene(R, N)
    o, d, table = o.to(card), d.to(card), table.to(card)
    before = k2.K2.launches
    t, idx = k2.ray_boxes_table(o, d, table)
    torch.cuda.synchronize()
    assert k2.K2.launches == before + 1
    t_p, idx_p = k2.ray_boxes_plain(o, d, table)
    assert torch.equal(idx, idx_p)
    assert torch.equal(t, t_p)
    assert bool((idx >= 0).any())
    t_c, idx_c = k2.ray_boxes_plain(o.cpu(), d.cpu(), table.cpu())
    assert torch.equal(idx.cpu(), idx_c)
    torch.testing.assert_close(t.cpu(), t_c, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_k2_rejects_what_it_does_not_take(card):
    o, d, table = (x.to(card) for x in _ray_scene(100, 4))
    with pytest.raises(ValueError, match="float32"):
        k2.ray_boxes_table(o.double(), d, table)
    with pytest.raises(ValueError, match="contiguous"):
        k2.ray_boxes_table(o.transpose(0, 1).contiguous().transpose(0, 1), d, table)
    with pytest.raises(ValueError, match="shape"):
        k2.ray_boxes_table(o, d, table[..., :8])


def _camera_scene(n_worlds, H, W, N, seed=0):
    """Camera-like rays (4 views of H x W pixels from one origin a world,
    row-major) and N boxes within 40 m of the origins: ~20% inactive, box 1
    a copy of box 0 (a tie wherever box 0 is hit), a few boxes behind and
    around the origin, and one tiny box."""
    from thinktwice_tpu_torch.config import CameraConfig
    from thinktwice_tpu_torch.sensors.camera import camera_rays

    g = torch.Generator().manual_seed(seed)
    ego_pos = torch.rand((n_worlds, 2), generator=g) * 100
    ego_yaw = (torch.rand((n_worlds,), generator=g) - 0.5) * 6.28
    o, d, _ = camera_rays(CameraConfig(height=H, width=W), ego_pos, ego_yaw)
    pose = torch.cat([ego_pos[:, None] + (torch.rand((n_worlds, N, 2), generator=g) - 0.5) * 80,
                      torch.rand((n_worlds, N, 1), generator=g) * 6,
                      torch.rand((n_worlds, N, 2), generator=g) * 2 + 0.2,
                      torch.rand((n_worlds, N, 1), generator=g) * 2 + 1,
                      torch.rand((n_worlds, N, 1), generator=g) * 0.5], dim=-1)
    pose[:, 0, :2] = ego_pos + 6.0                # near enough to be seen
    pose[:, 1] = pose[:, 0]                       # a tie on every ray that hits it
    pose[:, 2, :2] = ego_pos                      # around the origins
    pose[:, 3, 3:5] = 1e-3                        # tiny
    active = torch.rand((n_worlds, N), generator=g) > 0.2
    active[:, :4] = True
    return o.contiguous(), d.contiguous(), k2.box_table(pose, active)


def _k2_equal(card, o, d, table, grid):
    o, d, table = o.to(card), d.to(card), table.to(card)
    t, idx = k2.ray_boxes_cuda(o, d, table, grid)
    torch.cuda.synchronize()
    t_p, idx_p = k2.ray_boxes_plain(o, d, table)
    assert torch.equal(idx, idx_p)
    assert torch.equal(t, t_p)
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(32, 64), (8, 256), None])
def test_k2_tile_cull_matches_plain_on_card(card, grid):
    o, d, table = _camera_scene(3, 32, 64, 300)
    idx = _k2_equal(card, o, d, table, grid)
    assert bool((idx >= 0).any()) and not bool((idx == 1).any())   # lowest index wins
    keep, _ = k2.k2_tile_cull_plain(o, d, table, grid)
    assert float(keep.float().mean()) < 0.5 or grid is None        # the cull drops boxes


def adversarial_rays():
    """K2's hard cases for its cull, in plain torch: one world of 6 groups
    of 256 rays (grid (96, 16) puts each group in one tile) and 9 boxes.
    Rays from inside box 0, rays that graze box 1's faces and edges, rays
    with a box (2) behind them, rays at a 2 mm box (3) 35 m away, rays
    along the axes (exactly zero components) and diagonals from (100, 100,
    1), the axes at boxes 4-7, and a narrow fan from one origin tangent to
    box 8's bounding sphere at a corner, turning into the box by up to 0.5
    mrad (6 mm at the corner): the cull's own boundary, which it keeps only
    with its slack (a sphere shrunk by 1 cm with no slack drops it)."""
    g = torch.Generator().manual_seed(5)
    n = 256
    pose = torch.tensor([
        [0.0, 0.0, 0.4, 2.0, 1.0, 1.5, 0.0],       # 0: holds the first origins
        [20.0, 0.0, 0.0, 2.0, 1.0, 1.5, 0.0],      # 1: axis-aligned, grazed
        [-15.0, 5.0, 0.0, 2.0, 1.0, 1.5, 0.0],     # 2: behind the third tile
        [40.0, 10.0, 0.7, 1e-3, 1e-3, 1.001, 0.999],  # 3: tiny
        [130.0, 100.0, 0.0, 1.0, 1.0, 2.0, 0.0],   # 4-7: on the axes from (100, 100)
        [100.0, 130.0, 0.0, 1.0, 1.0, 2.0, 0.0],
        [70.0, 100.0, 0.0, 1.0, 1.0, 2.0, 0.0],
        [100.0, 70.0, 0.0, 1.0, 1.0, 2.0, 0.0],
        [60.0, -20.0, 0.3, 1.5, 0.8, 1.7, 0.2],    # 8: a corner on the tile's edge
    ])
    o = torch.zeros((6, n, 3))
    d = torch.zeros((6, n, 3))
    # inside box 0, every direction
    o[0] = torch.rand((n, 3), generator=g) * torch.tensor([1.0, 0.5, 1.0]) \
        + torch.tensor([-0.5, -0.25, 0.2])
    d[0] = torch.randn((n, 3), generator=g)
    # grazing box 1: along its faces y = +-1 and z = 1.5, and through its edges
    s = torch.linspace(-1.0, 1.0, n)
    o[1, :, 0] = 5.0
    o[1, :, 1] = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0)
    o[1, :, 2] = 0.75 + 0.75 * s
    d[1, :, 0] = 1.0
    o[1, ::3, 2] = 1.5
    d[1, ::3, 1] = 1e-12
    # box 2 behind the rays, box 1 ahead of some
    o[2] = torch.tensor([-12.0, 5.0, 0.8]) + torch.rand((n, 3), generator=g) * 0.1
    d[2] = torch.tensor([1.0, -0.25, 0.0]) + torch.randn((n, 3), generator=g) * 0.02
    # a tiny box 40 m away: rays aimed at points of its faces
    target = torch.tensor([40.0, 10.0, 1.0]) + (torch.rand((n, 3), generator=g) - 0.5) * 2e-3
    o[3] = torch.tensor([5.0, 5.0, 1.0])
    d[3] = target - o[3]
    # the axes and their diagonals, with exact zeros
    axes = torch.tensor([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, -1],
                         [1, 1, 0], [1, -1, 0], [-1, 1, 0], [-1, -1, 0]])
    o[4] = torch.tensor([100.0, 100.0, 1.0])
    d[4] = axes[torch.arange(n) % len(axes)]
    # box 8's corner C: rays from 12 m away along the sphere's tangent at C,
    # turned towards the centre by 0-0.5 mrad
    x, y, yaw, ex, ey, top, base = pose[8].tolist()
    rot = torch.tensor([[math.cos(yaw), -math.sin(yaw)], [math.sin(yaw), math.cos(yaw)]])
    corner = torch.cat([torch.tensor([x, y]) + rot @ torch.tensor([ex, ey]),
                        torch.tensor([top])])
    radial = corner - torch.tensor([x, y, 0.5 * (top + base)])
    tangent = torch.linalg.cross(radial, torch.tensor([0.0, 0.0, 1.0]))
    tangent = tangent / tangent.norm()
    o[5] = corner - 12.0 * tangent
    turn = torch.linspace(0.0, 5e-4, n)[:, None]
    d[5] = tangent - turn * radial / radial.norm()
    d = d / d.norm(dim=-1, keepdim=True)
    act = torch.ones((1, len(pose)), dtype=torch.bool)
    return o.reshape(1, -1, 3), d.reshape(1, -1, 3), k2.box_table(pose[None], act)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(96, 16), (192, 8), (48, 32), None])
def test_k2_adversarial_rays_match_plain_on_card(card, grid):
    """The cull's hard cases (tests/test_torch_raycast.py holds the plain
    cull to them) on the kernel: t and idx bit-equal to the plain version."""
    o, d, table = adversarial_rays()
    idx = _k2_equal(card, o, d, table, grid).cpu()
    assert bool((idx[0, :256] == 0).all())                # the origins inside box 0
    assert 100 < int((idx[0, 5 * 256:] == 8).sum()) < 256  # the fan at the corner


@pytest.mark.cuda
def test_k2_all_rows_inactive_and_ragged_grid_on_card(card):
    o, d, table = _camera_scene(2, 37, 45, 40, seed=1)     # no multiple of a tile
    _k2_equal(card, o, d, table, (37, 45))
    _k2_equal(card, o[:, :-77].contiguous(), d[:, :-77].contiguous(), table, None)
    table[..., 7] = 0.0
    idx = _k2_equal(card, o, d, table, (37, 45))
    assert bool((idx == -1).all())


def _prim_rows(n_worlds, n, centre, spread, seed):
    """n random primitives a world (thick segments and oriented boxes, every
    bit of the birdview) within spread metres of centre (B, 2)."""
    g = torch.Generator().manual_seed(seed)
    a = centre[:, None] + (torch.rand((n_worlds, n, 2), generator=g) - 0.5) * spread
    b = a + (torch.rand((n_worlds, n, 2), generator=g) - 0.5) * 6
    bits = torch.randint(0, k1.n_bits(CFG.birdview), (n_worlds, n), generator=g).float()
    hw = torch.rand((n_worlds, n), generator=g) * 0.5 + 0.05
    valid = torch.rand((n_worlds, n), generator=g) > 0.1
    segs = k1._seg_rows(a, b, hw, bits, valid)
    yaw = (torch.rand((n_worlds, n), generator=g) - 0.5) * 6.28
    ext = torch.rand((n_worlds, n, 2), generator=g) * 2 + 0.1
    boxes = torch.stack([torch.ones_like(yaw), bits, a[..., 0], a[..., 1], torch.cos(yaw),
                         torch.sin(yaw), ext[..., 0], ext[..., 1]], dim=-1)
    boxes = torch.where(valid[..., None], boxes, segs)   # an unused row either way
    kind = torch.rand((n_worlds, n, 1), generator=g) > 0.5
    return torch.where(kind, segs, boxes).contiguous()


def _k1_equal(card, prims, ego):
    prims, ego = prims.to(card), ego.to(card)
    plain = k1.birdview_bits_plain(CFG.birdview, prims, ego)
    bits = k1.birdview_bits_cuda(CFG.birdview, prims, ego)
    torch.cuda.synchronize()
    assert torch.equal(bits, plain)
    assert bool((plain != 0).any())


@pytest.mark.cuda
def test_k1_every_primitive_in_one_super_tile_on_card(card):
    ego = k1.ego_table(torch.tensor([[10.0, -4.0], [-30.0, 50.0]]), torch.tensor([0.3, -2.0]))
    wx, wy = k1.pixel_world_coords(CFG.birdview, ego)
    W = CFG.birdview.width
    corner = (20 * W + 20)                    # a pixel inside the first super-tile
    centre = torch.stack([wx[:, corner], wy[:, corner]], dim=-1)
    _k1_equal(card, _prim_rows(2, 700, centre, 3.0, seed=0), ego)


@pytest.mark.cuda
def test_k1_table_over_the_shared_budget_on_card(card):
    ego = k1.ego_table(torch.tensor([[0.0, 0.0], [5.0, 7.0]]), torch.tensor([1.0, 0.0]))
    wx, wy = k1.pixel_world_coords(CFG.birdview, ego)
    centre = torch.stack([wx.mean(1), wy.mean(1)], dim=-1)
    _k1_equal(card, _prim_rows(2, 4096 + 300, centre, 45.0, seed=1), ego)


@pytest.mark.cuda
def test_k1_on_an_imported_town_table_matches_plain_on_card(card):
    """A town compiled from planned routes at the bench's Town05 capacities:
    every world's table holds ~25,000 rows (7 chunks of K1's 4096), of which
    the town's road and lane segments are in use in every world."""
    import numpy as np

    from thinktwice_tpu_torch.bench import TOWN05_CAPS, scenario_batch
    from thinktwice_tpu_torch.harness.route_parser import RouteSpec
    from thinktwice_tpu_torch.maps.compile_h5 import compile_town_arrays
    from thinktwice_tpu_torch.maps.procedural import grid_town_rasters, make_grid_town
    from thinktwice_tpu_torch.maps.router import RasterPlanner, generate_random_routes
    from thinktwice_tpu_torch.sim.reset import reset_world

    grid = make_grid_town(n_blocks=2, block=100.0, device="cpu")
    rasters = grid_town_rasters(grid)
    planner = RasterPlanner(rasters["road"], rasters["world_offset"], rasters["pixels_per_meter"])
    routes = generate_random_routes(grid, 12, min_length=100.0, seed=0)
    specs = [RouteSpec(str(i), "grid", r[::12, :2].astype(np.float64),
                       np.rad2deg(r[::12, 2]).astype(np.float64)) for i, r in enumerate(routes)]
    dense = np.stack([s.dense(spacing=1.0, max_len=CFG.sim.max_route_len, planner=planner)
                      for s in specs])
    town = compile_town_arrays(rasters, [s.dense(spacing=2.0, planner=planner) for s in specs],
                               device=card, **dict(TOWN05_CAPS, max_lights=64, max_stops=8))
    g = torch.Generator(device=card).manual_seed(0)
    state = reset_world(CFG, town, torch.as_tensor(dense, device=card), n_vehicles=12,
                        scenario=scenario_batch(CFG, dense, card), generator=g)
    prims, ego = birdview_inputs(CFG.birdview, town, state)
    assert prims.shape[1] > 3 * 4096
    assert int((prims[..., 1] >= 0).sum(dim=1).min()) > 600
    _k1_equal(card, prims, ego)



def _longest6_table(device):
    """K1's inputs at the Longest6 evaluation's capacities
    (scripts/eval_longest6.py with 500 background vehicles: 508 vehicle
    slots, 16 walkers, 256 lights, 32 stop signs, 3,584-point routes) on
    the 6 x 6-block grid town: 6 worlds with Town05's 302 vehicles after
    20 ticks, so that the history ring holds their boxes."""
    from thinktwice_tpu_torch.maps.procedural import make_grid_town
    from thinktwice_tpu_torch.rollout import grid_routes
    from thinktwice_tpu_torch.sim.reset import reset_world

    cfg = Config(sim=SimConfig(max_vehicles=508, max_walkers=16, max_lights=256,
                               max_stop_signs=32, max_route_len=3584, max_scenarios=8))
    town = make_grid_town(n_blocks=6, block=100.0, max_lane_pts=16384, max_lights=256,
                          max_spawn=2048, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    state = reset_world(cfg, town, torch.as_tensor(grid_routes(6, 3584), device=device),
                        n_vehicles=302, generator=g)
    ctrl = torch.tensor([[0.0, 0.5, 0.0]] * 6, device=device)
    for _ in range(20):
        state, _ = step_world(cfg, town, state, ctrl, generator=g)
    assert state.traffic.active.shape[1] == 508
    assert int(state.traffic.active.sum(dim=1).min()) == 302
    return (cfg, *birdview_inputs(cfg.birdview, town, state))


@pytest.mark.cuda
def test_k1_on_a_longest6_table_matches_plain_on_card(card):
    cfg, prims, ego = _longest6_table(card)
    boxes = (prims[..., 0] > 0.5) & (prims[..., 1] >= 0)
    assert int(boxes.sum(dim=1).min()) >= 302 * len(cfg.birdview.history_idx)   # every vehicle drawn
    _k1_equal(card, prims, ego)

TINY = Config(
    sim=SimConfig(max_vehicles=8, max_walkers=4, max_route_len=256, max_scenarios=4),
    camera=CameraConfig(height=32, width=64), lidar=LidarConfig(n_beams=4, n_azimuth=64),
    model=ModelConfig(img_height=32, img_width=64, refine_num=1, bev_channels=64,
                      n_depth_bins=16, lidar_pillar_grid=84))


def _tiny_collect(device, n_frames):
    """One world of the tiny config collected on `device` by a Roach with
    flax-style weights from seed 0 -> (two-sweep batch, or None with fewer
    than 6 frames; K1's last inputs and K2's last two calls)."""
    from thinktwice_tpu_torch.agents.roach import RoachPolicy
    from thinktwice_tpu_torch.sensors import birdview, raycast
    from thinktwice_tpu_torch.train import collect, loop

    policy = RoachPolicy.from_config(TINY).to(device)
    loop.init_model_params(TINY, policy, torch.Generator(device=device).manual_seed(0))
    g = torch.Generator(device=device).manual_seed(3)
    town, state = grid_world(TINY, 1, 4, device=device, generator=g)
    seen = {"k1": None, "k2": []}
    real_k1, real_k2 = birdview.birdview_bits, raycast.ray_boxes_table

    def k1_spy(cfg, prims, ego):
        seen["k1"] = (prims, ego)
        return real_k1(cfg, prims, ego)

    def k2_spy(o, d, table, grid=None):
        seen["k2"] = (seen["k2"] + [(o, d, table, grid)])[-2:]
        return real_k2(o, d, table, grid=grid)

    birdview.birdview_bits, raycast.ray_boxes_table = k1_spy, k2_spy
    try:
        _, frames, sensors = collect.collect_batch(TINY, policy.eval(), town, state, n_frames,
                                                   generator=g)
    finally:
        birdview.birdview_bits, raycast.ray_boxes_table = real_k1, real_k2
    batch = collect.frames_to_batch(TINY, frames, sensors, n_sweeps=2) if n_frames > 5 else None
    return batch, seen


@pytest.mark.cuda
def test_collected_frame_kernels_match_plain_on_card(card):
    k1_before, k2_before = k1.K1.launches, k2.K2.launches
    batch, seen = _tiny_collect(card, 2)
    torch.cuda.synchronize()
    assert (k1.K1.launches - k1_before, k2.K2.launches - k2_before) == (12, 4)
    prims, ego = seen["k1"]
    assert torch.equal(k1.birdview_bits(TINY.birdview, prims, ego),
                       k1.birdview_bits_plain(TINY.birdview, prims, ego))
    for o, d, table, grid in seen["k2"]:
        t, idx = k2.ray_boxes_table(o, d, table, grid=grid)
        t_p, idx_p = k2.ray_boxes_plain(o, d, table)
        assert torch.equal(idx, idx_p) and torch.equal(t, t_p)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(card, monkeypatch):
    """In float32 compute (the student's bfloat16 and the card's TF32
    switched off, so no reduced-precision rounding enters), from a
    flax-style init whose zero leaves (the biases) get seeded noise of
    1e-3, so that every leaf has a scale: the loss terms and grad_norm to
    1e-3 of their value; the gradient to 1e-2 of its norm and each leaf at
    a cosine of at least 0.99 (the float32 backward moves by some 1e-3 of
    its norm with the order of its sums: this config's CPU gradients with
    1 and with 8 threads differ so); and the card's updated parameters to 1e-3
    of each leaf's change with the CPU's optimizer on the card's
    gradients."""
    from thinktwice_tpu_torch.config import TrainConfig
    from thinktwice_tpu_torch.models import encoder_decoder, lidarnet, lss
    from thinktwice_tpu_torch.train import loop
    from thinktwice_tpu_torch.train.train_step import (
        create_train_state, make_optimizer, make_train_step)

    # lr 1e-3 from the first step: the update lies far above the float32
    # spacing of the parameters (the default schedule's first lr is 1e-7)
    cfg = TINY.replace(train=TrainConfig(lr=1e-3, warmup_steps=0))
    for mod in (encoder_decoder, lidarnet, lss):
        monkeypatch.setattr(mod, "BF16", torch.float32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    batch, _ = _tiny_collect(torch.device("cpu"), 7)               # 2 examples, 2 sweeps
    init = loop.make_model(cfg, backbone_depth=10, n_sweeps=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    loop.init_model_params(cfg, init, gen)
    start = {k: v + 1e-3 * torch.randn(v.shape, generator=gen) if not v.any() else v
             for k, v in init.state_dict().items()}
    out = {}
    for dev in (torch.device("cpu"), card):
        model = loop.make_model(cfg, backbone_depth=10, n_sweeps=2, device=dev)
        model.load_state_dict(start)
        state = create_train_state(cfg, dict(model.named_parameters()))
        on = {k: tuple(x.to(dev) for x in v) if isinstance(v, tuple) else v.to(dev)
              for k, v in batch.items()}
        grads = {}

        def probe(stage, value, grads=grads):
            if stage == "backward":
                grads.update({k: g.detach().cpu().double() for k, g in value.items()})

        _, metrics = make_train_step(cfg, loop.model_loss_fn(cfg, model), probe)(state, on)
        out[dev.type] = ({k: float(v) for k, v in metrics.items()}, grads,
                         {k: v.detach().cpu() for k, v in model.named_parameters()})
    (m_c, g_c, _), (m_d, g_d, p_d) = out["cpu"], out["cuda"]
    for k in m_c:
        if not k.startswith("metric_"):
            assert abs(m_d[k] - m_c[k]) <= 1e-3 * max(abs(m_c[k]), 1e-12), k
    diff = math.sqrt(sum(float(((g_d[k] - g_c[k]) ** 2).sum()) for k in g_c))
    assert diff <= 1e-2 * math.sqrt(sum(float((g ** 2).sum()) for g in g_c.values()))
    for k in g_c:
        n_d, n_c = float(g_d[k].norm()), float(g_c[k].norm())
        if n_c == 0:
            assert n_d == 0, k
        else:
            assert float((g_d[k] * g_c[k]).sum()) >= 0.99 * n_d * n_c, k
    ref = {k: start[k].clone() for k in g_d}
    tx = make_optimizer(cfg)
    tx.step(ref, {k: g.float() for k, g in g_d.items()}, tx.init(ref))
    for k in ref:
        change = float((ref[k] - start[k]).abs().max())
        assert change > 0, k
        assert float((p_d[k] - ref[k]).abs().max()) <= 1e-3 * change, k


@pytest.mark.cuda
def test_data_parallel_step_on_card_matches_one_process(card, tmp_path):
    """The tiny two-sweep student's step on 2 collected examples (the first
    mirrored: distil_weight 0 on rank 0 only) in float32 compute, with a
    1-rank NCCL group and with a 2-rank gloo group sharing cuda:0, against
    the one-process step on the card: the loss terms and grad_norm to 1e-3
    of their value, the reduced gradient to 1e-2 of its norm with each leaf
    at a cosine of at least 0.99, the ranks' parameters to 1e-3 of each
    leaf's change by the optimizer on the reduced gradient (the tolerances
    of the train step's card-vs-CPU test), and every rank the same
    parameters: crosscheck.step_agreement."""
    import functools

    from thinktwice_tpu_torch.config import TrainConfig
    from thinktwice_tpu_torch.parallel import ranks
    from thinktwice_tpu_torch.parallel.launch import spawn
    from thinktwice_tpu_torch.train import loop
    from thinktwice_tpu_torch.train.augment import maybe_mirror
    from thinktwice_tpu_torch.train.crosscheck import step_agreement

    cfg = TINY.replace(train=TrainConfig(lr=1e-3, warmup_steps=0))
    batch, _ = _tiny_collect(torch.device("cpu"), 7)               # 2 examples, 2 sweeps
    batch = maybe_mirror(batch, do=torch.tensor([True, False]))
    make_model = functools.partial(loop.make_model, cfg, 10, 2)
    make_loss = functools.partial(loop.model_loss_fn, cfg)
    init = make_model(device="cpu")
    gen = torch.Generator().manual_seed(0)
    loop.init_model_params(cfg, init, gen)
    start = {k: v + 1e-3 * torch.randn(v.shape, generator=gen) if not v.any() else v
             for k, v in init.state_dict().items()}
    path = str(tmp_path / "data.pt")
    torch.save({"state_dict": start, "batch": batch}, path)
    one = ranks.train_step_rank(None, cfg, make_model, make_loss, path, float32=True,
                                device=card)
    args = (cfg, make_model, make_loss, path, True)
    for out in (spawn(ranks.train_step_rank, 1, args=args, devices=["cuda:0"],
                      backend="nccl", timeout=300),
                spawn(ranks.train_step_rank, 2, args=args, devices=["cuda:0", "cuda:0"],
                      backend="gloo", timeout=300)):
        agree = step_agreement(out, one, start, cfg, term_tol=1e-3, grad_tol=1e-2,
                               grad_cos=0.99, update_tol=1e-3)
        assert not agree["bad"], (len(out), agree["bad"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ppo", "bc"])
def test_expert_iterate_on_card_matches_cpu(card, kind, monkeypatch):
    """crosscheck's small PPO or BC iterate (BC then its probe) on the card
    against the CPU in float32 (TF32 off), the same weights and draws: K1
    launched once a macro step (and once for PPO's bootstrap, never on the
    CPU), equal dones, metrics within 1e-3 (absolute plus relative), the
    first minibatch's gradient within 1e-2 of its norm and every leaf at a
    cosine of at least 0.99."""
    from thinktwice_tpu_torch.train import crosscheck
    from thinktwice_tpu_torch.train.ppo import make_policy

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    start, anchor = (make_policy(CFG, "cpu", torch.Generator().manual_seed(seed)).state_dict()
                     for seed in (4, 8))
    cpu = crosscheck.small_iterate(kind, CFG, "cpu", start, anchor, seed=2)
    dev = crosscheck.small_iterate(kind, CFG, card, start, anchor, seed=2)
    expected = (crosscheck.SMALL_PPO.n_steps + 1 if kind == "ppo"
                else crosscheck.SMALL_BC.n_steps // 2)
    assert cpu.launches == 0 and dev.launches == expected
    assert (crosscheck.METRIC_TOL, crosscheck.GRAD_TOL, crosscheck.GRAD_COS) == (1e-3, 1e-2, 0.99)
    r = crosscheck.compare(dev, cpu)
    assert r["ok"], r


# --------------------------------------------------------------------------
# K3 (deformable attention) and K4 (the look module's point sampler) at the
# closed loop's shapes: 8 worlds, 4 cameras, 120 look points a camera, the
# FPN levels of 448 x 896 cameras, 8 heads of 32 channels, 8 points a level

LOOP8_LEVELS = ((112, 224), (56, 112), (28, 56), (14, 28))


def _k3_inputs(card, dtype, B=8, N=4, Q=120, H=8, D=32, P=8, shapes=LOOP8_LEVELS, seed=0):
    """value_cams as the student makes it, a transposed view of (B, N, S, C);
    reference points over [-0.2, 1.2]; offsets of a few pixels. World 0,
    camera 0 holds the edges: queries 0-1 at the corners (0, 0) and (1, 1)
    with zero offsets (half a pixel outside the maps), query 2 one pixel of
    the coarsest level off its right and bottom edges (off every level),
    queries 3-4 on pixel centres and on pixel borders of level 0 (integer
    offsets)."""
    g = torch.Generator(device=card).manual_seed(seed)
    L, S, C = len(shapes), sum(h * w for h, w in shapes), H * D
    value = torch.randn((B, N, S, C), generator=g, device=card).to(dtype).transpose(0, 1)
    ref = torch.rand((B, N, Q, 2), generator=g, device=card) * 1.4 - 0.2
    off = torch.randn((B, N, Q, H, L, P, 2), generator=g, device=card) * 4
    h0, w0 = shapes[0]
    ref[0, 0, 0] = 0.0
    ref[0, 0, 1] = 1.0
    ref[0, 0, 2] = torch.tensor([1.0 + 1.0 / shapes[-1][1], 1.0 + 1.0 / shapes[-1][0]])
    ref[0, 0, 3] = torch.tensor([10.5 / w0, 20.5 / h0])
    ref[0, 0, 4] = torch.tensor([10.0 / w0, 20.0 / h0])
    off[0, 0, :3] = 0.0
    off[0, 0, 3:5] = torch.round(off[0, 0, 3:5])
    logits = torch.randn((B, N, Q, H, L * P), generator=g, device=card)
    w = torch.softmax(logits, dim=-1).reshape(B, N, Q, H, L, P)
    return value, shapes, ref, off.to(dtype), w.to(dtype)


def _scaled_err(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.cuda
def test_k3_matches_plain_on_card(card):
    """bfloat16: K3 keeps the corner weights and every sum in float32 and
    rounds its output once, so it lies within 2^-8 of the output's scale of
    the plain version in float64 (half a bfloat16 step and the float32
    sums); the plain bfloat16 version rounds each of the ~12 products and
    sums of a tap's chain, so the two differ by up to 2^-5 of the scale.
    float32: the same operations summed in another order, within 1e-5."""
    from thinktwice_tpu_torch.ops import deform_attn as k3

    value, shapes, ref, off, w = _k3_inputs(card, torch.bfloat16)
    before = k3.K3.launches
    out = k3.deform_attn_cams(value, shapes, ref, off, w)
    torch.cuda.synchronize()
    assert k3.K3.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (8, 4, 120, 256)
    exact = k3.deform_attn_cams_plain(value.double(), shapes, ref.double(), off.double(),
                                      w.double())
    assert _scaled_err(out, exact) <= 2 ** -8
    assert _scaled_err(out, k3.deform_attn_cams_plain(value, shapes, ref, off, w)) <= 2 ** -5
    assert bool((out[0, 0, 2] == 0).all())                 # off every level's edge

    value, shapes, ref, off, w = _k3_inputs(card, torch.float32, seed=1)
    out = k3.deform_attn_cams(value, shapes, ref, off, w)
    assert _scaled_err(out, k3.deform_attn_cams_plain(value, shapes, ref, off, w)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)])
def test_k3_backward_matches_plain_autograd_on_card(card, dtype, tol):
    """K3's backward against the plain version's autograd in float32 on the
    same inputs, each gradient within tol of its scale: float32, 1e-5 (grad
    value's float32 atomics add in an order that changes from run to run,
    and the channel sums of grad offsets and weights run in another order);
    bfloat16, 2^-6 (K3 rounds each gradient once from float32, the
    reference not at all)."""
    from thinktwice_tpu_torch.ops import deform_attn as k3

    value, shapes, ref, off, w = _k3_inputs(card, dtype, seed=2)
    ins = [t.detach().clone().requires_grad_(True) for t in (value, off, w)]
    f32 = [t.detach().float().requires_grad_(True) for t in (value, off, w)]
    out = k3.deform_attn_cams(ins[0], shapes, ref, ins[1], ins[2])
    g = torch.randn(out.shape, generator=torch.Generator(device=card).manual_seed(5),
                    device=card).to(dtype)
    before = k3.K3.launches
    out.backward(g)
    torch.cuda.synchronize()
    assert k3.K3.launches == before + 1
    k3.deform_attn_cams_plain(f32[0], shapes, ref, f32[1], f32[2]).backward(g.float())
    for name, a, b in zip(("value", "offsets", "weights"), ins, f32):
        assert a.grad.dtype == dtype and a.grad.shape == a.shape, name
        assert _scaled_err(a.grad, b.grad) <= tol, name


@pytest.mark.cuda
def test_k3_rejects_what_it_does_not_take(card):
    from thinktwice_tpu_torch.ops import deform_attn as k3

    value, shapes, ref, off, w = _k3_inputs(card, torch.bfloat16, B=2, N=2, Q=8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k3.deform_attn_cams(value.double(), shapes, ref, off, w)
    with pytest.raises(ValueError, match="bfloat16"):
        k3.deform_attn_cams(value, shapes, ref, off.float(), w)
    with pytest.raises(ValueError, match="float32"):
        k3.deform_attn_cams(value, shapes, ref.bfloat16(), off, w)
    with pytest.raises(ValueError, match="rows"):
        k3.deform_attn_cams(value, shapes[:3], ref, off, w)
    with pytest.raises(ValueError, match="shape"):
        k3.deform_attn_cams(value, shapes, ref, off, w[..., :4])
    with pytest.raises(ValueError, match="heads"):
        k3.deform_attn_cams(value[..., :250], shapes, ref, off, w)
    with pytest.raises(ValueError, match="contiguous"):
        k3.deform_attn_cams(value, shapes, ref, off.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError, match="channels"):
        k3.deform_attn_cams(value.transpose(2, 3).contiguous().transpose(2, 3), shapes, ref,
                            off, w)
    with pytest.raises(ValueError, match="CUDA device"):
        k3.deform_attn_cams(value, shapes, ref.cpu(), off, w)
    with pytest.raises(ValueError, match="ref_points"):
        k3.deform_attn_cams(value, shapes, ref.requires_grad_(True), off, w)


def _k4_inputs(card, dtype, B=8, N=4, Q=120, C=256, shapes=LOOP8_LEVELS, seed=0):
    """Channels-last maps as the student's fusion makes them (level 1 a
    strided view with contiguous channels); points over [-0.3, 1.3] of the
    image, world 0, camera 0 holding the corners (0, 0) and (1, 1), points
    one pixel of level 0 off its left, right, top and bottom edges, a pixel
    centre and a pixel border of level 0, and a point far outside."""
    g = torch.Generator(device=card).manual_seed(seed)
    maps = [torch.randn((B, N, h, w, C), generator=g, device=card).to(dtype)
            for h, w in shapes]
    h1, w1 = shapes[1]
    maps[1] = torch.randn((N, B, h1, w1 + 2, C), generator=g, device=card).to(dtype) \
        .transpose(0, 1)[:, :, :, 1:w1 + 1]
    coords = torch.rand((B, N, Q, 2), generator=g, device=card) * 1.6 - 0.3
    h0, w0 = shapes[0]
    for i, xy in enumerate([(0.0, 0.0), (1.0, 1.0), (-1.0 / w0, 0.5), (1.0 + 1.0 / w0, 0.5),
                            (0.5, -1.0 / h0), (0.5, 1.0 + 1.0 / h0), (10.5 / w0, 20.5 / h0),
                            (10.0 / w0, 20.0 / h0), (1e9, -1e9)]):
        coords[0, 0, i] = torch.tensor(xy)
    return maps, coords


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_matches_plain_on_card(card, dtype):
    """K4 does the plain version's float operations in its order (built
    with --fmad=false): equal bit for bit."""
    from thinktwice_tpu_torch.ops import grid_sample as k4

    maps, coords = _k4_inputs(card, dtype)
    before = k4.K4.launches
    out = k4.sample_levels(maps, coords)
    torch.cuda.synchronize()
    assert k4.K4.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (8, 4, 120, 4 * 256)
    assert torch.equal(out, k4.sample_levels_plain(maps, coords))
    assert bool((out[0, 0, 8] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)])
def test_k4_backward_matches_plain_autograd_on_card(card, dtype, tol):
    """K4's backward against the plain version's autograd in float32 on the
    same maps, each level's gradient within tol of its scale: float32, 1e-5
    (both add with atomics, in orders that change from run to run);
    bfloat16, 2^-7 (K4 rounds each sum once from float32)."""
    from thinktwice_tpu_torch.ops import grid_sample as k4

    maps, coords = _k4_inputs(card, dtype, seed=3)
    ins = [m.detach().clone().requires_grad_(True) for m in maps]
    f32 = [m.detach().float().requires_grad_(True) for m in maps]
    out = k4.sample_levels(ins, coords)
    g = torch.randn(out.shape, generator=torch.Generator(device=card).manual_seed(6),
                    device=card)
    before = k4.K4.launches
    out.backward(g)
    torch.cuda.synchronize()
    assert k4.K4.launches == before + 1
    k4.sample_levels_plain(f32, coords).backward(g)
    for lvl, (a, b) in enumerate(zip(ins, f32)):
        assert a.grad.dtype == dtype and a.grad.shape == a.shape, lvl
        assert _scaled_err(a.grad, b.grad) <= tol, lvl


@pytest.mark.cuda
def test_k4_rejects_what_it_does_not_take(card):
    from thinktwice_tpu_torch.ops import grid_sample as k4

    maps, coords = _k4_inputs(card, torch.bfloat16, B=2, N=2, Q=12)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        k4.sample_levels([maps[0], maps[1].float()], coords)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        k4.sample_levels([m.double() for m in maps], coords)
    with pytest.raises(ValueError, match="float32"):
        k4.sample_levels(maps, coords.double())
    with pytest.raises(ValueError, match="shape"):
        k4.sample_levels([maps[0], maps[1][..., :128]], coords)
    with pytest.raises(ValueError, match="channels"):
        k4.sample_levels([m.transpose(3, 4).contiguous().transpose(3, 4) for m in maps],
                         coords)
    with pytest.raises(ValueError, match="levels"):
        k4.sample_levels([], coords)
    with pytest.raises(ValueError, match="lie on"):
        k4.sample_levels([maps[0].cpu()], coords)
    with pytest.raises(ValueError, match="coords"):
        k4.sample_levels(maps, coords.requires_grad_(True))


@pytest.mark.cuda
def test_student_forward_launches_k3_and_k4_once_a_refine_layer_on_card(card):
    """One policy call of the student at the closed loop's size (8 worlds,
    448 x 896 cameras, ResNet-50 over 2 sweeps, 5 refine layers) under
    no_grad: K3 and K4 launch 5 times each, once a refine layer."""
    from thinktwice_tpu_torch.agents.thinktwice_driver import (
        driver_init, make_thinktwice_driver)
    from thinktwice_tpu_torch.config import bench_config
    from thinktwice_tpu_torch.ops import deform_attn as k3
    from thinktwice_tpu_torch.ops import grid_sample as k4
    from thinktwice_tpu_torch.train import loop

    cfg = bench_config().replace(camera=CameraConfig(height=448, width=896),
                                 model=ModelConfig(img_height=448, img_width=896))
    model = loop.make_model(cfg, backbone_depth=50, n_sweeps=2, device=card).eval()
    loop.init_model_params(cfg, model, torch.Generator(device=card).manual_seed(0))
    g = torch.Generator(device=card).manual_seed(1)
    town, state = grid_world(cfg, 8, 120, device=card, generator=g)
    policy = make_thinktwice_driver(cfg, model)
    before = k3.K3.launches, k4.K4.launches
    ctrl, _ = policy(town, state, driver_init(cfg, 8, 2, device=card), generator=g)
    torch.cuda.synchronize()
    assert (k3.K3.launches - before[0], k4.K4.launches - before[1]) == (5, 5)
    assert ctrl.shape == (8, 3) and bool(torch.isfinite(ctrl).all())


def _loop8_points(card, seed=0):
    """The closed loop's LiDAR input at its size: 8 grid worlds, two sweeps
    of 64 x 1,024 rays merged (131,072 points a world), as the driver
    hands them to the student."""
    from thinktwice_tpu_torch.config import bench_config
    from thinktwice_tpu_torch.sensors.lidar import lidar_from_state, merge_sweeps

    cfg = bench_config()
    g = torch.Generator(device=card).manual_seed(seed)
    town, state = grid_world(cfg, 8, 120, device=card, generator=g)
    now = lidar_from_state(cfg.lidar, town, state, generator=g)
    ctrl = torch.tensor([[0.6, 0.0, 0.0]], device=card).expand(8, 3).contiguous()
    for _ in range(4):
        state, _ = step_world(cfg, town, state, ctrl,
                              draws=sample_step_draws(town, state, g))
    prev = lidar_from_state(cfg.lidar, town, state, generator=g)
    ego = (state.ego.pos, state.ego.yaw)
    return merge_sweeps(*now, *prev, ego, ego)


def _sparse_net(card):
    from port_bench.reference.seeded import seeded_params
    from thinktwice_tpu_torch.models.sparse_lidarnet import SparseLidarNet

    net = SparseLidarNet(ModelConfig(lidar_encoder="sparse")).to(card).eval()
    seeded_params(net, 3, card)
    return net


@pytest.mark.cuda
@pytest.mark.parametrize("max_voxels", [160_000, 4_000])
def test_k5_matches_plain_on_card(card, max_voxels):
    """K5's voxels, kept points, counts and VFE means are the plain
    version's bit for bit at the closed loop's size, the cap biting or not;
    rows past the voxels kept are empty."""
    from thinktwice_tpu_torch.ops import voxelize as vx

    spec = vx.VoxelSpec.from_config(ModelConfig(lidar_encoder="sparse",
                                                sparse_max_voxels=max_voxels))
    pts, mask = _loop8_points(card)
    got = vx.voxelize_cuda(pts, mask, spec)
    want = vx.voxelize_plain(pts.cpu(), mask.cpu(), spec)
    n = int(got.n[0])
    assert got.n.cpu().tolist() == want.n.tolist()
    assert (int(want.n[1]) > 0) == (max_voxels < 100_000)
    for name in ("coords", "point_idx", "counts", "feats"):
        assert torch.equal(getattr(got, name)[:n].cpu(), getattr(want, name)), name
    assert (got.coords[n:] == -1).all() and (got.counts[n:] == 0).all()
    if max_voxels < 100_000:
        assert n == 8 * max_voxels                              # every world at its cap
    else:
        assert 8 * 20_000 < n < 8 * 131_072


@pytest.mark.cuda
def test_sparse_encoder_matches_plain_on_card_without_a_sync(card):
    """The whole sparse encoder on the card (K5, K7's rulebooks, 21 K6
    launches, the dense scatter) with torch's sync debug mode at "error":
    no host synchronisation; its dense output is the plain version's on the
    CPU to 1e-5 of its scale."""
    from thinktwice_tpu_torch.models.sparse_lidarnet import SparseLidarNet
    from thinktwice_tpu_torch.ops import sparse_conv as sc

    net = _sparse_net(card)
    pts, mask = _loop8_points(card)
    before = sc.K6.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            got = net.encode(net.voxelize(pts, mask), 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.shape == (8, 256, 84, 84)
    net_cpu = SparseLidarNet(net.cfg).eval()
    net_cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    with torch.no_grad():
        want = net_cpu.encode(net_cpu.voxelize(pts.cpu(), mask.cpu()), 8)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale
    assert sc.K6.launches - before == 21


@pytest.mark.cuda
def test_sparse_encoder_is_bit_identical_run_to_run_on_card(card):
    """Two forwards of the sparse encoder on the same points give the same
    voxels and the same dense output, bit for bit (no float atomics)."""
    net = _sparse_net(card)
    pts, mask = _loop8_points(card, seed=1)
    with torch.no_grad():
        runs = []
        for _ in range(2):
            vox = net.voxelize(pts, mask)
            runs.append((vox, net.encode(vox, 8), net(pts, mask)))
    (v1, d1, o1), (v2, d2, o2) = runs
    for name in ("coords", "point_idx", "counts", "feats", "n", "grid"):
        assert torch.equal(getattr(v1, name), getattr(v2, name)), name
    assert torch.equal(d1, d2) and torch.equal(o1, o2)


@pytest.mark.cuda
def test_k6_takes_no_gradient_on_card(card):
    from thinktwice_tpu_torch.ops import sparse_conv as sc
    from thinktwice_tpu_torch.ops import voxelize as vx

    net = _sparse_net(card)
    pts, mask = _loop8_points(card)
    vox = vx.voxelize_cuda(pts[:1].contiguous(), mask[:1].contiguous(), net.spec)
    level = sc.Level(vox.coords, vox.n[:1], net.spec.shape, 1, vox.grid)
    x = vox.feats.clone().requires_grad_(True)
    conv = net.middle_encoder.conv_input
    y = conv(x, sc.subm_rulebook(level))
    with pytest.raises(RuntimeError, match="no backward"):
        y.sum().backward()
