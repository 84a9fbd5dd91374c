"""PyTorch port parity: route planning of thinktwice_tpu_torch
(`maps/router.py`) against thinktwice_tpu's on the CPU.

- `build_graph` on the 2-block grid town: equal waypoints and equal edge
  lists (targets and costs).
- `plan_route` for the JAX suite's queries (tests/test_router_augment_
  noiser.py) and `generate_random_routes` for seeds 0-3: equal arrays.
- `RasterPlanner` from a synthetic town H5 (the grid town's rasters and a
  stopline layer drawn from its stop lines, written with h5py): equal
  drivable cells, edge distances and both snap tables, the arrays form
  equal to the H5 form, and equal dense routes from `plan` and from
  `RouteSpec.dense(planner=)`, padded and cut to max_len.
"""

import h5py
import numpy as np
import pytest
import torch

from thinktwice_tpu.harness.route_parser import RouteSpec as JaxRouteSpec
from thinktwice_tpu.maps import router as jrouter
from thinktwice_tpu.maps.procedural import make_grid_town as jax_grid_town
from thinktwice_tpu_torch.harness.route_parser import RouteSpec
from thinktwice_tpu_torch.maps import router
from thinktwice_tpu_torch.maps.procedural import grid_town_rasters, make_grid_town

torch.set_num_threads(1)

QUERIES = [([10.0, -1.75], [80.0, -1.75]), ([50.0, -1.75], [50.0, 201.75])]
KEYPOINT_STRIDE = 12     # keep every 12th point (~24 m) of a lane-graph route


def write_town_h5(path, rasters: dict) -> str:
    """A town H5 in the reference's layout from grid_town_rasters' dict."""
    with h5py.File(path, "w") as hf:
        for name in ("road", "lane_marking_all", "lane_marking_white_broken", "sidewalk",
                     "stopline"):
            hf.create_dataset(name, data=rasters[name])
        hf.attrs["world_offset_in_meters"] = rasters["world_offset"]
        hf.attrs["pixels_per_meter"] = rasters["pixels_per_meter"]
    return str(path)


def keypoint_specs(routes, stride: int = KEYPOINT_STRIDE):
    """Lane-graph routes -> (port, JAX) RouteSpecs of every stride-th point
    and the last, posed with the route's headings in degrees."""
    out = []
    for i, r in enumerate(routes):
        idx = np.unique(np.r_[np.arange(0, len(r), stride), len(r) - 1])
        kp, yaw = r[idx, :2].astype(np.float64), np.rad2deg(r[idx, 2]).astype(np.float64)
        out.append((RouteSpec(str(i), "grid", kp, yaw), JaxRouteSpec(str(i), "grid", kp, yaw)))
    return out


@pytest.fixture(scope="module")
def towns():
    return make_grid_town(n_blocks=2, block=100.0, device="cpu"), jax_grid_town(
        n_blocks=2, block=100.0)


@pytest.fixture(scope="module")
def town_h5(towns, tmp_path_factory):
    return write_town_h5(tmp_path_factory.mktemp("h5") / "Grid.h5", grid_town_rasters(towns[0]))


@pytest.fixture(scope="module")
def planners(town_h5):
    return router.RasterPlanner.from_h5(town_h5), jrouter.RasterPlanner(town_h5)


def test_build_graph_matches(towns):
    g, jg = router.build_graph(towns[0]), jrouter.build_graph(towns[1])
    np.testing.assert_array_equal(g.pts, np.asarray(jg.pts))
    np.testing.assert_array_equal(g.yaw, np.asarray(jg.yaw))
    assert g.adj == jg.adj
    assert sum(len(a) for a in g.adj) > len(g.pts)      # lane-change links exist


@pytest.mark.parametrize("query", range(len(QUERIES)))
def test_plan_route_matches(towns, query):
    start, goal = QUERIES[query]
    r = router.plan_route(router.build_graph(towns[0]), start, goal)
    jr = jrouter.plan_route(jrouter.build_graph(towns[1]), start, goal)
    assert r is not None and r.dtype == np.float32
    np.testing.assert_array_equal(r, jr)


@pytest.mark.parametrize("seed", range(4))
def test_generate_random_routes_matches(towns, seed):
    rs = router.generate_random_routes(towns[0], 4, min_length=80.0, seed=seed)
    jrs = jrouter.generate_random_routes(towns[1], 4, min_length=80.0, seed=seed)
    assert len(rs) == len(jrs) == 4
    for r, jr in zip(rs, jrs):
        np.testing.assert_array_equal(r, jr)


def test_raster_planner_tables_match(planners, towns):
    p, jp = planners
    np.testing.assert_array_equal(p.drivable, jp.drivable)
    np.testing.assert_array_equal(p.edge_m, jp.edge_m)
    np.testing.assert_array_equal(p._edge_fine_m, jp._edge_fine_m)
    np.testing.assert_array_equal(p._snap_idx, jp._snap_idx)
    np.testing.assert_array_equal(p._snap_idx2, jp._snap_idx2)
    assert (p.cell_m, p.ppm) == (jp.cell_m, jp.ppm)
    np.testing.assert_array_equal(p.offset, jp.offset)
    # the arrays form builds the same planner as the H5 form
    r = grid_town_rasters(towns[0])
    q = router.RasterPlanner(r["road"], r["world_offset"], r["pixels_per_meter"])
    np.testing.assert_array_equal(q._snap_idx2, p._snap_idx2)
    np.testing.assert_array_equal(q.edge_m, p.edge_m)


def test_raster_planner_routes_match(planners, towns, town_h5):
    p, jp = planners
    routes = router.generate_random_routes(towns[0], 3, min_length=100.0, seed=1)
    for spec, jspec in keypoint_specs(routes):
        d = p.plan(spec.keypoints, spec.keypoint_yaws, spacing=1.0)
        np.testing.assert_array_equal(d, jp.plan(jspec.keypoints, jspec.keypoint_yaws,
                                                 spacing=1.0))
        assert len(d) > 50
        for max_len in (len(d) + 40, len(d) - 20):
            dense = spec.dense(spacing=1.0, max_len=max_len, planner=p)
            assert dense.shape == (max_len, 3)
            np.testing.assert_array_equal(
                dense, jspec.dense(spacing=1.0, max_len=max_len, planner=jp))
        # on the road everywhere
        road = grid_town_rasters(towns[0])["road"]
        px = ((d[:, :2] - np.asarray([-20.0, -20.0])) * 5.0).astype(int)
        assert road[px[:, 1], px[:, 0]].all()
    assert router.raster_planner(town_h5) is router.raster_planner(town_h5)
