"""The Roach expert's closed loop: `expert_control` (birdview through K1,
the policy, the rule brakes) every `policy_every` ticks and `step_world`
every tick, over a batch of worlds, as `rollout.rollout` drives them.

Until the port has a per-tick hook in its loops, this file makes the same
per-tick calls itself. Each tick's random draws are made by the port's
`sample_step_draws` from the run's generator and handed to `step_world`,
so the reference can be given the same draws.
"""

from __future__ import annotations

import time

import torch

from port_bench.clock import sync
from port_bench.counts.flops import count_flops
from port_bench.loops.common import choose_checks, grid_world, peak, program_config, set_precision
from port_bench.reference.roach_check import weights_path
from port_bench.spans import Span


def policy_flops(conf: dict, traffic: dict) -> int:
    """FLOPs of one policy forward over the batch, counted on the
    reference's policy on the meta device."""
    from port_bench.reference.roach_check import reference_config
    from port_bench.reference.ttref.agents.roach import RoachPolicy

    cfg = reference_config(conf, traffic)
    with torch.device("meta"):
        policy = RoachPolicy.from_config(cfg)
        B, W = traffic["worlds"], cfg.birdview.width
        bv = torch.empty((B, cfg.birdview.n_channels, W, W))
        sv = torch.empty((B, cfg.roach.state_dim))
    return count_flops(policy, bv, sv)


class Loop:
    def __init__(self, conf: dict, traffic: dict, seed: int, device: torch.device):
        from thinktwice_tpu_torch.agents import expert
        from thinktwice_tpu_torch.sim import step as sim_step
        from thinktwice_tpu_torch.weights import load_roach_policy

        self.conf, self.traffic, self.seed, self.device = conf, traffic, seed, device
        set_precision(conf)
        self.cfg = program_config(conf, traffic)
        self.expert, self.sim_step = expert, sim_step
        self.policy = load_roach_policy(weights_path(conf), self.cfg, device=device)
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.town, self.state = grid_world(self.cfg, traffic, device, self.g)
        self.state0 = self.state
        self.every = traffic["policy_every"]
        self.units_per_step = traffic["worlds"]
        self.trace_steps = traffic["trace_ticks"]
        self.ctrl = None
        self.tick = 0
        self.policy_calls = 0
        self.samples: list[int] = []
        self.captures: dict[int, tuple] = {}
        self.last = None
        self.flops = policy_flops(conf, traffic)

    def spans(self):
        from thinktwice_tpu_torch.sensors import birdview

        d = self.device
        self.k1 = Span(birdview, "birdview_bits", "k1", d, keep=True)
        return [Span(self.expert, "expert_control", "expert_control", d),
                Span(self.sim_step, "step_world", "step_world", d), self.k1]

    def _tick(self, keep: bool) -> None:
        state = self.state
        policy_tick = self.tick % self.every == 0
        if policy_tick:
            self.ctrl, sup = self.expert.expert_control(self.cfg, self.policy, self.town, state)
            self.policy_calls += 1
        draws = self.sim_step.sample_step_draws(self.town, state, self.g)
        self.state, _ = self.sim_step.step_world(self.cfg, self.town, state, self.ctrl,
                                                 draws=draws)
        if keep and policy_tick:
            self.last = (state, draws, self.ctrl, sup["action"], sup["birdview"], self.state)
        self.tick += 1

    def warm_up(self, seconds: float) -> None:
        n = self.traffic["warmup_ticks"]
        for _ in range(n // 2):
            self._tick(False)
        sync(self.device)
        t = time.perf_counter()
        for _ in range(n - n // 2):
            self._tick(False)
        sync(self.device)
        per_tick = (time.perf_counter() - t) / (n - n // 2)
        # the policy ticks checked against the reference (and the window's last)
        self.samples = choose_checks(self.seed, seconds, per_tick, self.every,
                                     self.traffic["checks"])
        self.tick = 0
        self.policy_calls = 0

    def step(self, i: int) -> None:
        self._tick(True)
        if i in self.samples:
            self.captures[i] = self.last

    def record(self, run: dict) -> None:
        run["policy_calls"] = self.policy_calls
        run["flops_per_call"] = self.flops
        run["peak_flop_per_s"] = peak(self.conf)
        if getattr(self, "k1", None) is not None and self.k1.calls:
            bv = self.cfg.birdview
            run["k1"] = {"kernel": "birdview_bits_kernel", "width": bv.width,
                         "pixels_ev_to_bottom": bv.pixels_ev_to_bottom,
                         "pixels_per_meter": bv.pixels_per_meter,
                         "inputs": [(args[1], args[2]) for args, _, _ in self.k1.calls]}

    def release(self) -> None:
        if self.last is not None:
            self.captures[max(self.captures, default=-1) + 1] = self.last
        for k in ("policy", "town", "state", "last", "ctrl", "k1"):
            self.__dict__.pop(k, None)

    def check(self, control: bool = False) -> dict:
        from port_bench.reference.roach_check import check

        return check(self.conf, self.traffic, self.seed, self.device, self.state0,
                     list(self.captures.values()), control)

