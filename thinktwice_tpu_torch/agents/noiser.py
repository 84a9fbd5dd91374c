"""Expert control noiser: DAgger-style perturbation episodes for a batch of
worlds (counterpart of `thinktwice_tpu/agents/noiser.py`).

Time-based noise episodes ramp a steer (or throttle) perturbation up and
back down over a short window, so the expert demonstrates recovery. The
schedule is a pure function of the sim tick and each world's episode draws:
every EPISODE_EVERY_S seconds an episode starts at a drawn offset, with a
drawn sign and magnitude. The draws come from a provider, `episode(ep_idx)`
-> (start s, sign +-1, magnitude in [0.3, 1)), each (B,) and the same for
the same episode index; `NoiserDraws` is the default one.
"""

from __future__ import annotations

import torch

EPISODE_EVERY_S = 25.0     # mean seconds between noise episodes
EPISODE_LEN_S = 1.5        # ramp up + down window
MAX_STEER_NOISE = 0.25
MAX_THROTTLE_NOISE = 0.2


class NoiserDraws:
    """Each world's episode draws from a torch.Generator seeded with `seed`,
    kept in a table that grows as later episodes are asked for, so an
    episode's numbers do not depend on when it is asked."""

    def __init__(self, n_worlds: int, seed: int, device="cpu"):
        self.n_worlds, self.device = n_worlds, torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.table = torch.empty((3, n_worlds, 0), device=self.device)

    def episode(self, ep_idx):
        """ep_idx (B,) int -> (start (B,) s, sign (B,), magnitude (B,))."""
        need = int(ep_idx.max()) + 1
        if need > self.table.shape[2]:     # one episode's (3, W) draws at a time
            more = [torch.rand((3, self.n_worlds, 1), generator=self.generator,
                               device=self.device)
                    for _ in range(need - self.table.shape[2])]
            self.table = torch.cat([self.table, *more], dim=2)
        b = torch.arange(self.n_worlds, device=self.device)
        u = self.table[:, b, ep_idx.to(self.device)].to(ep_idx.device)
        start = u[0] * (EPISODE_EVERY_S - EPISODE_LEN_S)
        sign = torch.where(u[1] < 0.5, 1.0, -1.0)
        return start, sign, 0.3 + 0.7 * u[2]


def noise_for_tick(draws, tick, dt: float, kind: str = "steer"):
    """(B,) additive control perturbation at this tick (B,) of each world."""
    t = tick.to(torch.float32) * dt
    ep_idx = torch.floor(t / EPISODE_EVERY_S).to(torch.int64)
    start, sign, mag = draws.episode(ep_idx)
    mag = mag * (MAX_STEER_NOISE if kind == "steer" else MAX_THROTTLE_NOISE)
    phase = (t - ep_idx.to(torch.float32) * EPISODE_EVERY_S - start) / EPISODE_LEN_S
    # triangular ramp 0 -> 1 -> 0 across the episode, zero outside
    envelope = torch.clamp(1.0 - torch.abs(phase * 2.0 - 1.0), 0.0, 1.0)
    envelope = torch.where((phase >= 0.0) & (phase <= 1.0), envelope, 0.0)
    return sign * mag * envelope


def apply_noise(draws, tick, control, dt: float = 0.05, steer: bool = True,
                throttle_draws=None):
    """control (B, 3) (steer, throttle, brake) -> the perturbed control: the
    steer episodes of `draws` when steer is set, and the throttle episodes
    of `throttle_draws` when it is given."""
    s, th = control[:, 0], control[:, 1]
    if steer:
        s = torch.clamp(s + noise_for_tick(draws, tick, dt, "steer"), -1.0, 1.0)
    if throttle_draws is not None:
        th = torch.clamp(th + noise_for_tick(throttle_draws, tick, dt, "throttle"), 0.0, 1.0)
    return torch.stack([s, th, control[:, 2]], dim=-1)
