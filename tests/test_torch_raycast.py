"""PyTorch port parity: the ray caster of thinktwice_tpu_torch (K2's plain
version, the ground plane, the traffic-light fixtures and cast_scene)
against thinktwice_tpu's on the CPU.

K2's plain version must give the JAX `ray_boxes` and the Pallas kernel in
interpret mode the same hit mask and the same box indices, and t to rtol
1e-5 (the JAX suite's own bound between those two, tests/
test_raycast_pallas.py). Against the Pallas kernel, which takes its sines
in the kernel, t may also differ by as much as the JAX package's own two
versions differ on the same rays (more than 1e-5 relative on a ray that
starts near a face, where t is a difference of nearly equal numbers). The
scenes cover inactive boxes, exact ties (duplicate boxes: the lowest index
wins), direction components at and near zero, elevated boxes and ray
counts that are no multiple of a block.

K2's per-tile cull (`k2_tile_cull_plain`, the kernel's formula) must keep
every box that the all-pairs plain version reports hit, for camera and
lidar rays of a grid world and for adversarial rays; a grid passed to
cast_scene changes nothing on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinktwice_tpu.maps.procedural import make_grid_town as jax_grid_town
from thinktwice_tpu.ops.raycast_pallas import ray_boxes_pallas
from thinktwice_tpu.sensors import raycast as jrc
from thinktwice_tpu_torch.config import CameraConfig, Config, LidarConfig, SimConfig
from thinktwice_tpu_torch.maps.procedural import make_grid_town
from thinktwice_tpu_torch.ops import raycast_cuda as k2
from thinktwice_tpu_torch.rollout import grid_world
from thinktwice_tpu_torch.sensors import raycast as rc
from thinktwice_tpu_torch.sensors.camera import cameras_from_state
from thinktwice_tpu_torch.sensors.lidar import lidar_from_state
from tests.test_torch_cuda import adversarial_rays

torch.set_num_threads(1)

RTOL = 1e-5


def scene(seed: int, R: int, N: int, z_base: bool):
    """One world's rays and boxes (numpy): random rays from 0-3 m height,
    some with a zero or tiny direction component, boxes with random yaw,
    ~20% inactive, and box 1 a copy of box 0 (a tie on every ray)."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(-20, 20, (R, 2)), rng.uniform(0.0, 3.0, (R, 1))], 1)
    d = rng.normal(size=(R, 3))
    d[: R // 8, 0] = 0.0                      # exactly zero components
    d[R // 8: R // 4, 1] = 1e-12
    d[R // 4: R // 4 + R // 16, 2] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pose = np.zeros((N, 7 if z_base else 6), np.float32)
    pose[:, 0:2] = rng.uniform(-25, 25, (N, 2))
    pose[:, 2] = rng.uniform(-np.pi, np.pi, N)
    pose[:, 3:5] = rng.uniform(0.2, 2.5, (N, 2))
    pose[:, 5] = rng.uniform(1.0, 3.0, N)
    if z_base:
        pose[:, 6] = rng.uniform(0.0, 0.8, N)
    pose[1] = pose[0]
    act = rng.uniform(size=N) > 0.2
    act[:2] = True
    return o.astype(np.float32), d.astype(np.float32), pose, act


def _max_rel(a, b):
    rel = np.divide(np.abs(a - b), np.abs(b), out=np.zeros_like(a), where=b != 0)
    return float(np.max(rel, initial=0.0))


def assert_same_hits(t_port, i_port, t_ref, i_ref, rtol=RTOL):
    t_port, i_port = np.asarray(t_port), np.asarray(i_port)
    t_ref, i_ref = np.asarray(t_ref), np.asarray(i_ref)
    hit_p, hit_r = i_port >= 0, i_ref >= 0
    np.testing.assert_array_equal(hit_p, hit_r)
    np.testing.assert_array_equal(i_port, i_ref)
    np.testing.assert_allclose(t_port[hit_p], t_ref[hit_r], rtol=rtol)
    np.testing.assert_array_equal(t_port[~hit_p], np.float32(k2.MAX_T))


@pytest.mark.parametrize("R,N,z_base", [(1000, 24, False), (2048 + 77, 40, True),
                                         (33, 3, False)])
def test_plain_ray_boxes_matches_jax_and_pallas(R, N, z_base):
    worlds = [scene(s, R, N, z_base) for s in (0, 1)]
    o, d, pose, act = (np.stack(x) for x in zip(*worlds))
    t, idx = rc.ray_boxes(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(pose),
                          torch.as_tensor(act))
    assert t.shape == (2, R) and idx.dtype == torch.int64
    for b in range(2):
        args = [jnp.asarray(a[b]) for a in (o, d, pose, act)]
        t_xla, i_xla = (np.asarray(a) for a in jrc.ray_boxes(*args))
        t_pal, i_pal = (np.asarray(a) for a in ray_boxes_pallas(*args, interpret=True))
        assert_same_hits(t[b], idx[b], t_xla, i_xla)
        hit = i_xla >= 0
        jax_spread = _max_rel(t_xla[hit], t_pal[hit])
        assert_same_hits(t[b], idx[b], t_pal, i_pal, rtol=max(RTOL, jax_spread))
    # box 1 duplicates box 0: the lower index takes every tie
    assert not bool((idx == 1).any()) and bool((idx == 0).any())


def test_plain_version_is_chunk_invariant():
    o, d, pose, act = scene(3, 777, 30, True)
    table = k2.box_table(torch.as_tensor(pose)[None], torch.as_tensor(act)[None])
    o, d = torch.as_tensor(o)[None], torch.as_tensor(d)[None]
    t_a, i_a = k2.ray_boxes_plain(o, d, table)
    t_b, i_b = k2.ray_boxes_plain(o, d, table, chunk=13)
    assert torch.equal(t_a, t_b) and torch.equal(i_a, i_b)


def test_cpu_tensors_take_the_plain_version():
    o, d, pose, act = scene(4, 100, 8, False)
    before = k2.K2.launches
    rc.ray_boxes(*(torch.as_tensor(a)[None] for a in (o, d, pose, act)))
    assert k2.K2.launches == before


def test_no_boxes_and_axis_rays():
    o = torch.tensor([[[0.0, 0.0, 1.0]] * 5])
    d = torch.tensor([[[1.0, 0.0, 0.0]] * 5])
    t, idx = rc.ray_boxes(o, d, torch.zeros((1, 0, 6)), torch.zeros((1, 0), dtype=torch.bool))
    assert bool((idx == -1).all()) and bool((t == k2.MAX_T).all())
    pose = torch.tensor([[[10.0, 0.0, 0.0, 2.0, 1.0, 1.5]]])
    t, idx = rc.ray_boxes(o, d, pose, torch.ones((1, 1), dtype=torch.bool))
    assert bool((idx == 0).all())
    np.testing.assert_allclose(t.numpy(), 8.0, rtol=1e-6)


def test_ray_ground_matches_jax():
    o, d, _, _ = scene(5, 500, 2, False)
    d[:10, 2] = 0.0
    d[10:20, 2] = 1e-12
    ref = np.asarray(jrc.ray_ground(jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_allclose(rc.ray_ground(torch.as_tensor(o), torch.as_tensor(d)).numpy(),
                               ref, rtol=RTOL)


@pytest.fixture(scope="module")
def towns():
    return (jax_grid_town(n_blocks=2, block=100.0),
            make_grid_town(n_blocks=2, block=100.0, device="cpu"))


def test_traffic_light_boxes_match_jax(towns):
    jtown, ttown = towns
    rng = np.random.default_rng(6)
    states = rng.integers(0, 3, (2, jtown.tl_pos.shape[0]))
    pose, active, cls = rc.traffic_light_boxes(ttown, torch.as_tensor(states))
    for b in range(2):
        jp, ja, jcls = jrc.traffic_light_boxes(jtown, jnp.asarray(states[b]))
        np.testing.assert_allclose(pose[b].numpy(), np.asarray(jp), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(active[b].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(cls[b].numpy(), np.asarray(jcls))


def test_cast_scene_matches_jax(towns):
    """Rays from 1.8 m over the junction at (100, 100) at vehicles, walkers
    and light fixtures: semantics, hit flags, shade and t as the JAX
    package's cast_scene gives them (its XLA ray_boxes; the Pallas kernel
    cannot run outside interpret mode on the CPU, and ray_boxes is held to
    it above)."""
    jtown, ttown = towns
    rng = np.random.default_rng(7)
    R, V, W = 3000, 12, 4
    o = np.tile(np.array([[100.0, 98.0, 1.8]], np.float32), (R, 1))
    o[:, :2] += rng.uniform(-30, 30, (R, 2)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def boxes(n, ext, h):
        p = np.zeros((n, 6), np.float32)
        p[:, :2] = 100.0 + rng.uniform(-25, 25, (n, 2))
        p[:, 2] = rng.uniform(-np.pi, np.pi, n)
        p[:, 3:5] = ext
        p[:, 5] = h
        return p, rng.uniform(size=n) > 0.2

    vp, va = boxes(V, (2.45, 1.06), jrc.VEHICLE_HEIGHT)
    wp, wa = boxes(W, (0.3, 0.3), jrc.WALKER_HEIGHT)
    states = rng.integers(0, 3, jtown.tl_pos.shape[0])
    jextra = jrc.traffic_light_boxes(jtown, jnp.asarray(states))
    textra = rc.traffic_light_boxes(ttown, torch.as_tensor(states)[None])
    port = rc.cast_scene(ttown, torch.as_tensor(o)[None], torch.as_tensor(d)[None],
                         torch.as_tensor(vp)[None], torch.as_tensor(va)[None],
                         torch.as_tensor(wp)[None], torch.as_tensor(wa)[None],
                         extra_pose=textra[0], extra_active=textra[1],
                         extra_class=textra[2])
    ref = jrc.cast_scene(jtown, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vp),
                         jnp.asarray(va), jnp.asarray(wp), jnp.asarray(wa),
                         use_pallas=False, extra_pose=jextra[0],
                         extra_active=jextra[1], extra_class=jextra[2])
    np.testing.assert_array_equal(port["semantic"][0].numpy(), np.asarray(ref["semantic"]))
    np.testing.assert_array_equal(port["hit"][0].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_allclose(port["t"][0].numpy(), np.asarray(ref["t"]), rtol=RTOL)
    np.testing.assert_allclose(port["shade"][0].numpy(), np.asarray(ref["shade"]),
                               rtol=1e-6)
    sem = port["semantic"][0].numpy()
    for cls in (rc.SEM_VEHICLE, rc.SEM_ROAD):
        assert (sem == cls).any(), cls


# --------------------------------------------------------------------------
# K2's per-tile cull


def assert_cull_keeps_hits(o, d, table, grid):
    """Every (ray, box) hit of the all-pairs plain version is a box that the
    ray's tile keeps. -> the share of (tile, box) pairs kept."""
    keep, ids = k2.k2_tile_cull_plain(o, d, table, grid)
    _, idx = k2.ray_boxes_plain(o, d, table)
    R = o.shape[1]
    live = ids >= 0
    tile_of = torch.full((R,), -1, dtype=torch.int64)
    tile_of[ids[live]] = torch.nonzero(live)[:, 0]
    assert bool((tile_of >= 0).all())                     # every ray has a tile
    b, r = torch.nonzero(idx >= 0, as_tuple=True)
    assert b.numel() > 0, "no ray hit a box"
    kept = keep[b, tile_of[r], idx[b, r]]
    assert bool(kept.all()), f"the cull dropped {int((~kept).sum())} hit boxes"
    return float(keep.float().mean())


class RecordK2:
    """Records the rays, tables and grids that cast_scene hands to K2."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = rc.ray_boxes_table

        def record(origins, dirs, table, grid=None):
            self.calls.append((origins, dirs, table, grid))
            return real(origins, dirs, table, grid=grid)

        monkeypatch.setattr(rc, "ray_boxes_table", record)


@pytest.fixture(scope="module")
def sensor_world():
    cfg = Config(sim=SimConfig(max_vehicles=64, max_walkers=8, max_route_len=256))
    g = torch.Generator().manual_seed(11)
    return grid_world(cfg, 2, 60, device="cpu", generator=g)


@pytest.mark.parametrize("cam,lidar", [((64, 128), (16, 256)), ((40, 72), (12, 200)),
                                       ((48, 96), (8, 512))])
def test_tile_cull_keeps_every_hit_box_of_the_sensors(sensor_world, monkeypatch, cam, lidar):
    """Image sizes that are multiples of the tile and ragged ones."""
    town, state = sensor_world
    rec = RecordK2(monkeypatch)
    cameras_from_state(CameraConfig(height=cam[0], width=cam[1]), town, state)
    lidar_from_state(LidarConfig(n_beams=lidar[0], n_azimuth=lidar[1]), town, state)
    (co, cd, ct, cgrid), (lo, ld, lt, lgrid) = rec.calls
    assert cgrid == cam and lgrid == lidar
    for o, d, table, grid in ((co, cd, ct, cgrid), (lo, ld, lt, lgrid)):
        assert assert_cull_keeps_hits(o, d, table, grid) < 0.25   # it culls
        assert_cull_keeps_hits(o, d, table, None)


@pytest.mark.parametrize("grid", [(96, 16), (192, 8), (48, 32), None])
def test_tile_cull_keeps_every_hit_box_of_adversarial_rays(grid):
    """(96, 16): a tile holds one group of adversarial rays; (192, 8) half
    of one; (48, 32) two; None: 256 consecutive rays, one group."""
    o, d, table = adversarial_rays()
    assert_cull_keeps_hits(o, d, table, grid)
    _, idx = k2.ray_boxes_plain(o, d, table)
    by_tile = idx[0].reshape(6, 256)
    assert bool((by_tile[0] == 0).all())                 # the origins inside box 0
    assert bool((by_tile[1] == 1).any())                 # the grazing rays
    assert not bool((by_tile[2] == 2).any())             # box 2 stays behind
    assert bool((by_tile[3] == 3).any())                 # the tiny box
    assert set(by_tile[4].tolist()) >= {4, 5, 6, 7}      # the axes
    assert 100 < int((by_tile[5] == 8).sum()) < 256      # the fan at the corner
    keep, _ = k2.k2_tile_cull_plain(o, d, table, (96, 16))
    assert not bool(keep[0, 2, 2])                       # the box behind is culled


def test_tile_cull_keeps_all_for_short_or_wide_rays():
    o, d, pose, act = scene(8, 512, 12, True)
    table = k2.box_table(torch.as_tensor(pose)[None], torch.as_tensor(act)[None])
    o, d = torch.as_tensor(o)[None], torch.as_tensor(d)[None]
    keep, _ = k2.k2_tile_cull_plain(o, d, table)          # random directions: too wide
    assert torch.equal(keep, table[:, None, :, 7].expand_as(keep) > 0.5)
    d = d.clone()
    d[0, 0] = 0.0
    d[0, 256:] = torch.tensor([1.0, 0.0, 0.0])
    keep, _ = k2.k2_tile_cull_plain(o, d, table)          # a zero ray in tile 0
    assert torch.equal(keep[0, 0], table[0, :, 7] > 0.5)
    assert_cull_keeps_hits(o, d, table, None)


def test_ray_tiles_cover_every_ray_once():
    for R, grid in ((1000, None), (3 * 37 * 45, (37, 45)), (2 * 32 * 64, (32, 64)),
                    (2 * 8 * 200, (8, 200)), (5 * 16 * 32, (16, 32))):
        ids = k2.ray_tiles(R, grid)
        assert ids.shape[1] == (256 if grid is None else k2.K2_TILE[0] * k2.K2_TILE[1])
        assert torch.equal(torch.sort(ids[ids >= 0]).values, torch.arange(R))
    ids = k2.ray_tiles(1000)
    assert ids[0].tolist() == list(range(256)) and ids[3, 231:233].tolist() == [999, -1]
    ids = k2.ray_tiles(2 * 32 * 64, (32, 64))
    assert ids[0, 31:33].tolist() == [31, 64] and ids.shape == (8, 512)   # 16 x 32
    with pytest.raises(ValueError, match="views"):
        k2.ray_tiles(1000, (32, 64))
    with pytest.raises(ValueError, match="views"):
        k2.ray_tiles(2048, (0, 64))


def test_grid_changes_nothing_on_the_cpu(sensor_world, monkeypatch):
    town, state = sensor_world
    rec = RecordK2(monkeypatch)
    cam = CameraConfig(height=32, width=64)
    cameras_from_state(cam, town, state)
    o, d, table, grid = rec.calls[0]
    V, W = state.traffic.pos.shape[1], state.walkers.pos.shape[1]
    veh = rc.box_pose_from_state(state.traffic.pos, state.traffic.yaw,
                                 state.traffic.extent, rc.VEHICLE_HEIGHT)
    wlk = rc.box_pose_from_state(state.walkers.pos, state.walkers.yaw,
                                 state.walkers.extent, rc.WALKER_HEIGHT)
    a = rc.cast_scene(town, o, d, veh, state.traffic.active, wlk, state.walkers.active)
    b = rc.cast_scene(town, o, d, veh, state.traffic.active, wlk, state.walkers.active,
                      grid=grid)
    assert grid == (32, 64) and V and W
    for key in a:
        assert torch.equal(a[key], b[key]), key
    with pytest.raises(ValueError, match="views"):
        rc.cast_scene(town, o, d, veh, state.traffic.active, wlk, state.walkers.active,
                      grid=(33, 64))
