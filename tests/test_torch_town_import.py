"""PyTorch port parity: imported towns of thinktwice_tpu_torch
(`maps/compile_h5.py`, `maps/cache.py`, `bench.town05_world`) against
thinktwice_tpu's on the CPU.

The town is a synthetic town H5 (tests/test_torch_router.py): the 2-block
grid town's rasters, with its stop lines drawn into the stopline layer or
that layer left empty (as Town05's is), and routes planned through each
package's RasterPlanner from keypoints of lane-graph routes.

- `compile_town`: every TownMap field equal, integers and masks exactly,
  floats within 1e-6 (both stopline cases: lights from the stopline
  components; lights and stop signs from junction detection).
- `strict=True` raises in both packages when a capacity is too small;
  without it both truncate alike.
- `save_town` / `load_town`: a file written by either package loads in the
  other, field for field, and the two files hold the same arrays.
- The birdview of two worlds on the compiled town: the port's (K1's plain
  version) against the JAX package's XLA renderer within its suite's 2e-3
  of the pixels, while every 48-px tile stays within 1/1.5 of the XLA
  renderer's TILE_SEG_K road and lane segments (beyond that cap the XLA
  renderer would drop segments that K1 keeps).
- `bench.town05_world` on synthetic H5 and route XML files: the town of the
  JAX package's `town05_cached`, the JAX bench's densified routes and its
  scenario slots; with a bank XML and the rasters read from an .npz through
  `read`, the same town as the JAX package's on the H5 and both XMLs.
- `bench.run` takes the imported town only when both of its files are
  given.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_router import keypoint_specs, write_town_h5
from test_torch_sim import configs, jax_reset_batch
from thinktwice_tpu.harness.evaluator import build_route_scenarios as jax_build_scenarios
from thinktwice_tpu.harness.route_parser import ScenarioTrigger as JaxTrigger
from thinktwice_tpu.maps import cache as jcache
from thinktwice_tpu.maps import compile_h5 as jcompile
from thinktwice_tpu.maps import router as jrouter
from thinktwice_tpu.maps.town import TownMap as JaxTownMap
from thinktwice_tpu.sensors.birdview import TILE_PX, TILE_SEG_K, _tile_reach_m
from thinktwice_tpu.sensors.birdview import birdview_from_state as jax_birdview
from thinktwice_tpu_torch import bench
from thinktwice_tpu_torch.config import Config, SimConfig
from thinktwice_tpu_torch.maps import cache, compile_h5, router
from thinktwice_tpu_torch.maps.procedural import grid_town_rasters, make_grid_town
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sensors.birdview import birdview_from_state
from thinktwice_tpu_torch.sim.state import state_from_arrays

torch.set_num_threads(1)

FLOAT_TOL = 1e-6
XLA_TOL = 2e-3       # the JAX suite's bound between its Pallas and XLA birdviews
HEADROOM = 1.5       # tests/test_birdview_tiling.py's margin under TILE_SEG_K
SMALL_CAPS = dict(max_lane_pts=2048, max_lights=64, max_stops=8, max_spawn=256,
                  max_road_segs=512, max_lane_segs=512)


@pytest.fixture(scope="module")
def town_files(tmp_path_factory):
    """{"raster" | "empty": H5 path} and the planned polylines of each
    package (spacing 2 m, as town05_cached plans them)."""
    root = tmp_path_factory.mktemp("town_h5")
    grid = make_grid_town(n_blocks=2, block=100.0, device="cpu")
    rasters = grid_town_rasters(grid)
    paths = {"raster": write_town_h5(root / "Grid.h5", rasters)}
    paths["empty"] = write_town_h5(root / "GridNoStop.h5",
                                   dict(rasters, stopline=np.zeros_like(rasters["stopline"])))
    routes = router.generate_random_routes(grid, 5, min_length=100.0, seed=2)
    planner = router.RasterPlanner.from_h5(paths["raster"])
    jplanner = jrouter.RasterPlanner(paths["raster"])
    specs = keypoint_specs(routes)
    polys = [s.dense(spacing=2.0, planner=planner) for s, _ in specs]
    jpolys = [j.dense(spacing=2.0, planner=jplanner) for _, j in specs]
    for p, q in zip(polys, jpolys):
        np.testing.assert_array_equal(p, q)
    return dict(paths=paths, polys=polys, jpolys=jpolys, specs=specs, planner=planner,
                jplanner=jplanner, routes=routes)


def assert_town_matches(port: TownMap, ref):
    for f in dataclasses.fields(TownMap):
        a = getattr(port, f.name).cpu().numpy()
        b = np.asarray(getattr(ref, f.name))
        assert a.shape == b.shape, f.name
        if b.dtype.kind == "f":
            assert a.dtype == np.float32, f.name
            np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_TOL, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("stopline", ["raster", "empty"])
def test_compile_town_matches(town_files, stopline):
    path = town_files["paths"][stopline]
    town = compile_h5.compile_town(path, town_files["polys"], device="cpu", **SMALL_CAPS)
    jtown = jcompile.compile_town(path, town_files["jpolys"], **SMALL_CAPS)
    assert_town_matches(town, jtown)
    assert int(town.lane_valid.sum()) > 300 and int(town.tl_valid.sum()) >= 4
    assert int(town.road_seg_valid.sum()) > 50 and int(town.spawn_valid.sum()) > 20
    assert town.road.shape == (600, 600) and float(town.pixels_per_meter) == 2.5


def test_compile_town_arrays_is_the_h5_form(town_files):
    path = town_files["paths"]["raster"]
    a = compile_h5.compile_town_arrays(compile_h5.read_town_h5(path), town_files["polys"],
                                       device="cpu", **SMALL_CAPS)
    b = compile_h5.compile_town(path, town_files["polys"], device="cpu", **SMALL_CAPS)
    for f in dataclasses.fields(TownMap):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_strict_raises_and_truncation_matches(town_files, capsys):
    path = town_files["paths"]["raster"]
    caps = dict(SMALL_CAPS, max_road_segs=8)
    with pytest.raises(ValueError, match="cap"):
        compile_h5.compile_town(path, town_files["polys"], device="cpu", strict=True, **caps)
    with pytest.raises(ValueError, match="cap"):
        jcompile.compile_town(path, town_files["jpolys"], strict=True, **caps)
    with pytest.raises(ValueError, match="lane_pts capacity"):
        compile_h5.compile_town(path, town_files["polys"], device="cpu", strict=True,
                                **dict(SMALL_CAPS, max_lane_pts=100))
    town = compile_h5.compile_town(path, town_files["polys"], device="cpu", **caps)
    assert "WARNING compile_town: road_segs" in capsys.readouterr().out
    assert_town_matches(town, jcompile.compile_town(path, town_files["jpolys"], **caps))
    assert int(town.road_seg_valid.sum()) == 8


def test_town_cache_cross_reads(town_files, tmp_path):
    path = town_files["paths"]["empty"]
    town = compile_h5.compile_town(path, town_files["polys"], device="cpu", **SMALL_CAPS)
    jtown = jcompile.compile_town(path, town_files["jpolys"], **SMALL_CAPS)
    cache.save_town(str(tmp_path / "port.npz"), town)
    jcache.save_town(str(tmp_path / "jax.npz"), jtown)
    assert_town_matches(cache.load_town(str(tmp_path / "jax.npz"), device="cpu"), jtown)
    back = jcache.load_town(str(tmp_path / "port.npz"))
    assert isinstance(back, JaxTownMap)
    assert_town_matches(town, back)
    with np.load(tmp_path / "port.npz") as p, np.load(tmp_path / "jax.npz") as q:
        assert sorted(p.files) == sorted(q.files)
        for k in q.files:
            assert p[k].dtype == q[k].dtype, k
            if q[k].dtype.kind != "f":
                np.testing.assert_array_equal(p[k], q[k], err_msg=k)


def tile_segment_counts(cfg, town: TownMap, pos, yaw) -> int:
    """The most road or lane segments whose bound reaches one of the 4 x 4
    48-px tiles of the birdview at ego pose (pos, yaw)
    (tests/test_birdview_tiling.py's count)."""
    reach = _tile_reach_m(cfg)
    g = cfg.width // TILE_PX
    fwd = np.array([np.cos(yaw), np.sin(yaw)])
    right = np.array([-np.sin(yaw), np.cos(yaw)])
    rows = (cfg.width - cfg.pixels_ev_to_bottom
            - (np.arange(g) * TILE_PX + TILE_PX / 2.0)) / cfg.pixels_per_meter
    cols = ((np.arange(g) * TILE_PX + TILE_PX / 2.0) - 0.5 * cfg.width) / cfg.pixels_per_meter
    centers = (pos[None, None] + rows[:, None, None] * fwd[None, None]
               + cols[None, :, None] * right[None, None]).reshape(-1, 2)
    worst = 0
    for segs, valid in ((town.road_segs, town.road_seg_valid),
                        (town.lane_segs, town.lane_seg_valid)):
        segs, valid = segs.numpy(), valid.numpy()
        a, b, hw = segs[:, 0:2], segs[:, 2:4], segs[:, 4]
        hl = 0.5 * np.linalg.norm(b - a, axis=-1) + hw
        d = np.linalg.norm(centers[:, None] - 0.5 * (a + b)[None], axis=-1) - hl[None]
        worst = max(worst, int(((d <= reach) & valid[None]).sum(axis=1).max()))
    return worst


def test_birdview_on_compiled_town_matches(town_files):
    path = town_files["paths"]["empty"]
    town = compile_h5.compile_town(path, town_files["polys"], device="cpu", **SMALL_CAPS)
    jtown = jcompile.compile_town(path, town_files["jpolys"], **SMALL_CAPS)
    jcfg, tcfg = configs()
    R = jcfg.sim.max_route_len
    specs = town_files["specs"][:2]
    routes = np.stack([s.dense(spacing=1.0, max_len=R, planner=town_files["planner"])
                       for s, _ in specs])
    jroutes = np.stack([j.dense(spacing=1.0, max_len=R, planner=town_files["jplanner"])
                        for _, j in specs])
    np.testing.assert_array_equal(routes, jroutes)
    jstate, _ = jax_reset_batch(jcfg, jtown, jroutes, seed=0, n_vehicles=12)
    state = state_from_arrays(jstate, device="cpu")
    obs = birdview_from_state(tcfg.birdview, town, state).numpy()
    ref = np.asarray(jax.jit(jax.vmap(lambda s: jax_birdview(jcfg.birdview, jtown, s)))(jstate))
    assert obs.shape == ref.shape == (2, 15, 192, 192)
    for b in range(2):
        pos = np.asarray(jstate.ego.pos[b], np.float64)
        worst = tile_segment_counts(tcfg.birdview, town, pos, float(jstate.ego.yaw[b]))
        assert worst * HEADROOM <= TILE_SEG_K, (worst, TILE_SEG_K)
        frac = float(np.mean(np.abs(obs[b] - ref[b]) > 1e-6))
        assert frac <= XLA_TOL, (b, frac)
    assert obs[:, 0].mean() > 0.1 and obs[:, 1].mean() > 0.005   # road and route drawn


def _write_routes_xml(path, specs) -> str:
    lines = ["<routes>"]
    for s, _ in specs:
        lines.append(f'  <route id="{s.route_id}" town="Grid">')
        for (x, y), yaw in zip(s.keypoints, s.keypoint_yaws):
            lines.append(f'    <waypoint x="{float(x)!r}" y="{float(y)!r}" z="0.0" yaw="{float(yaw)!r}"/>')
        lines.append("  </route>")
    lines.append("</routes>")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_town05_world_on_synthetic_files(town_files, tmp_path, monkeypatch):
    monkeypatch.setattr(cache, "CACHE_DIR", str(tmp_path / "port_cache"))
    monkeypatch.setattr(jcache, "CACHE_DIR", str(tmp_path / "jax_cache"))
    h5 = town_files["paths"]["raster"]
    xml = _write_routes_xml(tmp_path / "routes.xml", town_files["specs"])
    jcfg, _ = configs(max_lights=256, max_stop_signs=32, max_route_len=384)
    R = jcfg.sim.max_route_len
    cfg = Config(sim=SimConfig(**{f.name: getattr(jcfg.sim, f.name)
                                  for f in dataclasses.fields(SimConfig)}))
    town, routes, scens = bench.town05_world(cfg, 2, h5, xml, device="cpu")
    # the JAX bench's world (bench.py:49-86) on the same files
    jtown = jcache.town05_cached(h5, [xml], **bench.TOWN05_CAPS)
    assert_town_matches(town, jtown)
    assert town.lane_pts.shape[0] == 49152 and town.road_segs.shape[0] == 8192
    jroutes = []
    for _, j in town_files["specs"]:
        raw = j.dense(spacing=1.0, planner=town_files["jplanner"])
        if 100.0 <= np.linalg.norm(np.diff(raw[:, :2], axis=0), axis=1).sum() <= R - 10:
            jroutes.append(j.dense(spacing=1.0, max_len=R, planner=town_files["jplanner"]))
    np.testing.assert_array_equal(routes.numpy(), np.stack(jroutes[:2]))
    for b, r in enumerate(jroutes[:2]):
        n = len(r)
        trigs = [JaxTrigger("Scenario3", r[n // 3, :2].astype(np.float64), np.rad2deg(r[n // 3, 2])),
                 JaxTrigger("Scenario7", r[2 * n // 3, :2].astype(np.float64),
                            np.rad2deg(r[2 * n // 3, 2]))]
        js = jax_build_scenarios(jcfg, r, trigs)
        for f in dataclasses.fields(js):
            a = getattr(scens, f.name)[b].numpy()
            e = np.asarray(getattr(js, f.name))
            if e.dtype.kind == "f":
                np.testing.assert_allclose(a, e, rtol=0, atol=FLOAT_TOL, err_msg=f.name)
            else:
                np.testing.assert_array_equal(a, e, err_msg=f.name)
    # a second call reads the cache file
    again, _, _ = bench.town05_world(cfg, 2, h5, xml, device="cpu")
    assert torch.equal(again.lane_pts, town.lane_pts)
    assert len(list((tmp_path / "port_cache").iterdir())) == 1


def _read_town_npz(path) -> dict:
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["pixels_per_meter"] = float(out["pixels_per_meter"])
    return out


def test_town05_world_with_bank_and_reader(town_files, tmp_path, monkeypatch):
    """The town's rasters kept as an .npz and read through `read`, and a
    bank XML after the route XML: the same town as the JAX package's
    town05_cached on the H5 and both XMLs, and the same routes."""
    monkeypatch.setattr(cache, "CACHE_DIR", str(tmp_path / "port_cache"))
    monkeypatch.setattr(jcache, "CACHE_DIR", str(tmp_path / "jax_cache"))
    h5 = town_files["paths"]["raster"]
    npz = str(tmp_path / "Grid.npz")
    grid = make_grid_town(n_blocks=2, block=100.0, device="cpu")
    np.savez(npz, **grid_town_rasters(grid))
    specs = town_files["specs"]
    xml = _write_routes_xml(tmp_path / "routes.xml", specs[:3])
    bank = _write_routes_xml(tmp_path / "bank.xml", specs[3:])
    jcfg, _ = configs(max_lights=256, max_stop_signs=32, max_route_len=384)
    cfg = Config(sim=SimConfig(**{f.name: getattr(jcfg.sim, f.name)
                                  for f in dataclasses.fields(SimConfig)}))
    town, routes, _ = bench.town05_world(cfg, 1, npz, xml, device="cpu", bank_files=[bank],
                                         read=_read_town_npz)
    assert_town_matches(town, jcache.town05_cached(h5, [xml, bank], **bench.TOWN05_CAPS))
    with_h5, h5_routes, _ = bench.town05_world(cfg, 1, h5, xml, device="cpu", bank_files=[bank])
    np.testing.assert_array_equal(routes.numpy(), h5_routes.numpy())
    assert torch.equal(with_h5.lane_pts, town.lane_pts)


def test_bench_takes_town05_only_with_both_files():
    for h5, xml in (("Town05.h5", None), (None, "routes.xml")):
        with pytest.raises(ValueError, match="both"):
            bench.run("cpu", 1, 1, h5_path=h5, routes_xml=xml)
