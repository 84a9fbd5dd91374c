"""Draws provider of expert training: every random number PPO and BC take
(the counterpart of the `jax.random` key chain in `thinktwice_tpu/train/ppo.py`
and `thinktwice_tpu/train/bc.py`).

The trainers never draw themselves. They ask a provider, at the points
where the JAX package splits its key:

- `init()` before the first reset, `macro()` at the start of every macro
  step of a rollout, `epoch()` at the start of every epoch of an update (a
  key-chain provider splits there; this one ignores them);
- `reset(done, n_routes)`: a route index and the spawn draw for every world
  (the trainers reset only the rows where done is set);
- `step(state)`: one tick's StepDraws;
- `gamma(alpha, beta)`: the two Gamma variates of a Beta sample (PPO);
- `permutation(n)`: an epoch's order of the samples;
- `perturb(n, prob)`, `steer_noise(n)`, `dagger(n, mix)`, `label_jitter(i, shape)`:
  BC's displacement, exploration noise, DAgger mixing and label jitter;
- `probe_reset(n)`: the spawn draws of BC's held-out probe.

`GeneratorTrainDraws(seed)` draws them all from one torch.Generator. A test
can hand a trainer a provider of the JAX key chain instead.
"""

from __future__ import annotations

import torch

from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sim.state import WorldState
from thinktwice_tpu_torch.sim.step import StepDraws


class GeneratorTrainDraws:
    """Every draw from one torch.Generator seeded with `seed`, made on
    `device` (default: the town's) and moved to the device of the tensors
    it serves, so that two runs on different devices that draw on the same
    one see the same numbers."""

    def __init__(self, town: TownMap, seed: int, device=None):
        self.town, self.seed = town, seed
        self.device = town.device if device is None else torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def init(self) -> None:
        pass

    def macro(self) -> None:
        pass

    def epoch(self) -> None:
        pass

    def reset(self, done, n_routes: int):
        """-> (route index (W,) int64 in [0, n_routes), spawn draw (W, SP))."""
        g, dev = self.generator, self.device
        W, SP = done.shape[0], self.town.spawn.shape[0]
        idx = torch.randint(0, n_routes, (W,), generator=g, device=dev)
        spawn = torch.rand((W, SP), generator=g, device=dev)
        return idx.to(done.device), spawn.to(done.device)

    def probe_reset(self, n: int):
        g, dev = self.generator, self.device
        return torch.rand((n, self.town.spawn.shape[0]), generator=g,
                          device=dev).to(self.town.device)

    def step(self, state: WorldState) -> StepDraws:
        g, dev = self.generator, self.device
        B, V = state.traffic.active.shape
        return StepDraws(
            steer_normal=torch.randn((B,), generator=g, device=dev).to(state.tick.device),
            recycle_cand=torch.randint(0, self.town.spawn.shape[0], (B, V), generator=g,
                                       device=dev).to(state.tick.device),
        )

    def gamma(self, alpha, beta):
        """-> (Gamma(alpha, 1), Gamma(beta, 1)) samples, elementwise."""
        g, dev = self.generator, self.device
        g1 = torch._standard_gamma(alpha.detach().to(dev), generator=g)
        g2 = torch._standard_gamma(beta.detach().to(dev), generator=g)
        return g1.to(alpha.device), g2.to(alpha.device)

    def permutation(self, n: int, device) -> torch.Tensor:
        g, dev = self.generator, self.device
        return torch.randperm(n, generator=g, device=dev).to(device)

    def perturb(self, n: int, prob: float, device):
        """-> (displace (n,) bool, set with probability prob; lateral and
        yaw uniforms (n,) in [-1, 1))."""
        g, dev = self.generator, self.device
        u = torch.rand((3, n), generator=g, device=dev).to(device)
        return u[0] < prob, u[1] * 2.0 - 1.0, u[2] * 2.0 - 1.0

    def steer_noise(self, n: int, device) -> torch.Tensor:
        g, dev = self.generator, self.device
        return torch.randn((n,), generator=g, device=dev).to(device)

    def dagger(self, n: int, mix: float, device) -> torch.Tensor:
        """-> (n,) bool, set with probability mix: the worlds that execute
        the learned policy."""
        g, dev = self.generator, self.device
        return torch.rand((n,), generator=g, device=dev).to(device) < mix

    def label_jitter(self, i: int, shape, device) -> torch.Tensor:
        g, dev = self.generator, self.device
        return torch.randn(shape, generator=g, device=dev).to(device)
