"""PyTorch port on the card: each CUDA kernel against its plain version (K1
the birdview rasterizer, K2 the ray-vs-box intersector), and the card's
world step against the CPU's. These tests need an NVIDIA card and skip
without one; they import no JAX, so on a machine with a card and no JAX
they run with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from thinktwice_tpu_torch.config import Config, SimConfig
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
