"""PyTorch port parity: K1, the birdview rasterizer (ops/birdview_cuda.py),
against the JAX package's Pallas kernel in interpret mode and its XLA
renderer, on the CPU where the port takes K1's plain version.

Tolerances: the plain version takes the cosines and sines of the ego and
box yaws from torch, the Pallas kernel from XLA inside the kernel, so a
pixel on a primitive's edge may flip: at most 1e-3 of the pixels differ
from the Pallas kernel's bits and stack. Against the XLA renderer (another
formulation of the pixel coordinates and of segment distance) the JAX
suite's own bound holds: 2e-3 (tests/test_birdview_pallas.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sim import configs, jax_reset_batch, towns, two_routes
from thinktwice_tpu.ops.birdview_pallas import (
    render_birdview_bits,
    render_birdview_pallas,
)
from thinktwice_tpu.sensors.birdview import render_birdview
from thinktwice_tpu.sim.step import step_world as jax_step_world
from thinktwice_tpu_torch.ops import birdview_cuda as k1
from thinktwice_tpu_torch.sensors.birdview import (
    birdview_bits_from_state,
    birdview_from_state,
    birdview_inputs,
)
from thinktwice_tpu_torch.sim.state import state_from_arrays

torch.set_num_threads(1)

PALLAS_TOL = 1e-3   # share of pixels that may differ from the Pallas kernel
XLA_TOL = 2e-3      # the JAX suite's bound between its Pallas and XLA paths


@pytest.fixture(scope="module")
def scene():
    """Two worlds with traffic and light history: world 0 near the junction
    at (100, 100) with a walker on the road, world 1 near the stop sign at
    (-5.5, -1.75). Holds each world's Pallas bits (interpret mode) and the
    port's plain-version bits."""
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    jstate, _ = jax_reset_batch(jcfg, jtown, two_routes(), seed=0, n_vehicles=12)
    wk = jstate.walkers
    wk = dataclasses.replace(
        wk, pos=wk.pos.at[0, 0].set(jnp.asarray([85.0, 95.0])),
        active=wk.active.at[0, 0].set(True),
    )
    jstate = dataclasses.replace(jstate, walkers=wk)
    step = jax.jit(jax.vmap(lambda s, c: jax_step_world(jcfg, jtown, s, c)))
    for _ in range(6):
        jstate, _ = step(jstate, jnp.asarray([[0.0, 0.5, 0.0]] * 2))
    tstate = state_from_arrays(jstate, device="cpu")
    inputs = [jax_inputs(jcfg.birdview, jtown, world(jstate, b)) for b in range(2)]
    pallas = jax.jit(render_birdview_bits, static_argnums=0,
                     static_argnames="interpret")
    pallas_bits = [pallas(jcfg.birdview, jtown, *args, interpret=True, **kw)
                   for args, kw in inputs]
    bits = birdview_bits_from_state(tcfg.birdview, ttown, tstate)
    return dict(jcfg=jcfg, tcfg=tcfg, jtown=jtown, ttown=ttown, tstate=tstate,
                inputs=inputs, pallas_bits=pallas_bits, bits=bits)


def jax_inputs(cfg, town, st):
    """One world's birdview inputs as birdview_from_state builds them."""
    idx = st.criteria.route_idx
    win = jnp.clip(idx + jnp.arange(cfg.n_route_points), 0, st.route.shape[0] - 1)
    d_stop = jnp.linalg.norm(town.stop_pos - st.ego.pos[None], axis=-1)
    stop_active = town.stop_valid & ~st.criteria.stop_has_stopped & (d_stop < 30.0)
    ns = town.stop_pos.shape[0]
    stop_pose = jnp.concatenate(
        [town.stop_pos, town.stop_yaw[:, None], jnp.tile(jnp.asarray([[0.6, 2.8]]), (ns, 1))],
        axis=-1,
    )
    return (st.ego.pos, st.ego.yaw, st.history, st.route[win, :2]), dict(
        stop_pose=stop_pose, stop_active=stop_active)


def world(jstate, b):
    return jax.tree.map(lambda x: x[b], jstate)


def test_plain_bits_match_pallas_interpret(scene):
    bits = scene["bits"].numpy()
    for b, ref in enumerate(scene["pallas_bits"]):
        frac = float(np.mean(bits[b] != np.asarray(ref)))
        assert frac <= PALLAS_TOL, (b, frac)
    # every layer is drawn somewhere: road, route, lanes, vehicles, lights,
    # the walker (world 0) and the stop sign's red bit (world 1)
    for bit in (0, 1, 3, 7, 11, 12, 14):
        assert ((bits >> bit) & 1).any(), bit
    assert ((bits[1] >> 23) & 1).any()


def test_plain_stack_matches_pallas_and_xla(scene):
    """The 15-channel stack against render_birdview_pallas and against
    render_birdview."""
    jcfg, jtown = scene["jcfg"], scene["jtown"]
    obs = k1.decode_bits(scene["tcfg"].birdview, scene["bits"]).numpy()
    assert obs.shape == (2, 15, 192, 192)
    pallas = jax.jit(render_birdview_pallas, static_argnums=0,
                     static_argnames="interpret")
    for b, (args, kw) in enumerate(scene["inputs"]):
        pal = np.asarray(pallas(jcfg.birdview, jtown, *args, interpret=True, **kw))
        xla = np.asarray(jax.jit(render_birdview, static_argnums=0)(
            jcfg.birdview, jtown, *args, **kw))
        frac_pal = float(np.mean(np.abs(obs[b] - pal) > 1e-6))
        frac_xla = float(np.mean(np.abs(obs[b] - xla) > 1e-6))
        assert frac_pal <= PALLAS_TOL, (b, frac_pal)
        assert frac_xla <= XLA_TOL, (b, frac_xla)


def test_birdview_from_state_decodes_the_bits(scene):
    obs = birdview_from_state(scene["tcfg"].birdview, scene["ttown"], scene["tstate"])
    assert torch.equal(obs, k1.decode_bits(scene["tcfg"].birdview, scene["bits"]))


def test_plain_version_is_chunk_invariant(scene):
    """The OR over primitives does not depend on how they are chunked."""
    cfg = dataclasses.replace(scene["tcfg"].birdview, width=64, pixels_ev_to_bottom=16)
    prims, ego = birdview_inputs(cfg, scene["ttown"], scene["tstate"])
    a = k1.birdview_bits_plain(cfg, prims, ego, chunk=7)
    b = k1.birdview_bits_plain(cfg, prims, ego, chunk=k1.PLAIN_CHUNK)
    assert torch.equal(a, b)
    assert bool((a != 0).any())


def test_cpu_tensors_take_the_plain_version(scene):
    cfg = scene["tcfg"].birdview
    prims, ego = birdview_inputs(cfg, scene["ttown"], scene["tstate"])
    before = k1.K1.launches
    assert torch.equal(k1.birdview_bits(cfg, prims, ego), scene["bits"])
    assert k1.K1.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        k1.birdview_bits_cuda(cfg, prims, ego)


def test_plain_cull_drops_no_bit(monkeypatch):
    """The plain version leaves out of each tile of pixels the rows whose
    bounds reach none of its pixels: on rows scattered over, outside and
    across the edges of three worlds' views (segments and turned boxes,
    wide and thin), the masks equal those of every row tested on every
    pixel."""
    cfg = configs()[1].birdview
    g = torch.Generator().manual_seed(11)
    ego = k1.ego_table(torch.tensor([[0.0, 0.0], [40.0, -25.0], [-7.0, 90.0]]),
                       torch.tensor([0.4, -2.1, 3.0]))
    wx, wy = k1.pixel_world_coords(cfg, ego)
    centre = torch.stack([wx.mean(1), wy.mean(1)], dim=-1)
    n = 900
    a = centre[:, None] + (torch.rand((3, n, 2), generator=g) - 0.5) * 90.0
    b = a + (torch.rand((3, n, 2), generator=g) - 0.5) * 30.0
    bits = torch.randint(0, k1.n_bits(cfg), (3, n), generator=g).float()
    hw = torch.rand((3, n), generator=g) * 3.0 + 0.05
    valid = torch.rand((3, n), generator=g) > 0.1
    segs = k1._seg_rows(a, b, hw, bits, valid)
    yaw = (torch.rand((3, n), generator=g) - 0.5) * 6.28
    ext = torch.rand((3, n, 2), generator=g) * 6.0 + 0.1
    boxes = torch.stack([torch.ones_like(yaw), bits, a[..., 0], a[..., 1], torch.cos(yaw),
                         torch.sin(yaw), ext[..., 0], ext[..., 1]], dim=-1)
    boxes = torch.where(valid[..., None], boxes, segs)
    prims = torch.where(torch.rand((3, n, 1), generator=g) > 0.5, segs, boxes)
    lo_x, hi_x, lo_y, hi_y = k1.row_bounds(prims)
    x0, x1 = wx.amin(1, keepdim=True), wx.amax(1, keepdim=True)
    y0, y1 = wy.amin(1, keepdim=True), wy.amax(1, keepdim=True)
    inside = (lo_x >= x0) & (hi_x <= x1) & (lo_y >= y0) & (hi_y <= y1)
    outside = (hi_x < x0) | (lo_x > x1) | (hi_y < y0) | (lo_y > y1)
    culled = k1.birdview_bits_plain(cfg, prims, ego)
    monkeypatch.setattr(k1, "row_bounds", lambda p: tuple(
        torch.full(p.shape[:2], v) for v in (-1e9, 1e9, -1e9, 1e9)))
    full = k1.birdview_bits_plain(cfg, prims, ego)       # no row dropped
    assert torch.equal(culled, full)
    assert bool((full != 0).any())
    for part in (inside, outside, ~inside & ~outside):   # rows inside, outside and across
        assert bool((valid & part).any(dim=1).all())
