"""The ThinkTwice student's closed loop: every tick the driver policy
(cameras and lidar through K2, the two-sweep forward, control fusion), then
`step_world`, over a batch of worlds, as `rollout_thinktwice` drives them.

The weights are made on the device from the seed. Set-up fills the history
ring (warm-up calls), so every call of the window sees two sweeps. Each
call's sensor draws and each tick's step draws are made by the port's
samplers from the run's generator and handed in, so the reference can be
given the same.
"""

from __future__ import annotations

import time

import torch

from port_bench.clock import sync
from port_bench.counts.flops import count_flops
from port_bench.loops.common import choose_checks, grid_world, peak, program_config, set_precision
from port_bench.reference.seeded import seeded_params
from port_bench.spans import Span, Tap

RINGS = ("rgb_ring", "pts_ring", "mask_ring", "pos_ring", "yaw_ring")


def student_flops(conf: dict, traffic: dict, device) -> int:
    """FLOPs of one policy call's forward over the batch, counted on the
    reference's model at the cell's shapes (zero inputs)."""
    from port_bench.reference.student_check import reference_config, reference_forward

    cfg = reference_config(conf, traffic)
    return count_flops(reference_forward(conf, cfg, traffic["worlds"], device))


class Loop:
    def __init__(self, conf: dict, traffic: dict, seed: int, device: torch.device):
        from thinktwice_tpu_torch.agents import thinktwice_driver as ttd
        from thinktwice_tpu_torch.sim import step as sim_step
        from thinktwice_tpu_torch.train.loop import make_model

        self.conf, self.traffic, self.seed, self.device = conf, traffic, seed, device
        set_precision(conf)
        self.cfg = program_config(conf, traffic)
        self.ttd, self.sim_step = ttd, sim_step
        self.model = make_model(self.cfg, conf["backbone_depth"], conf["n_sweeps"],
                                device=device).eval()
        seeded_params(self.model, seed, device)
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.town, self.state = grid_world(self.cfg, traffic, device, self.g)
        self.state0 = self.state
        self.policy = ttd.make_thinktwice_driver(self.cfg, self.model)
        self.driver = ttd.driver_init(self.cfg, traffic["worlds"], conf["n_sweeps"],
                                      hist_len=traffic["history_calls"], device=device)
        self.taps = {"cameras": Tap(ttd, "cameras_from_state"),
                     "lidar": Tap(ttd, "lidar_from_state"),
                     "model": Tap(self.model, "forward")}
        self.units_per_step = traffic["worlds"]
        self.trace_steps = traffic["trace_ticks"]
        self.policy_calls = 0
        self.samples: list[int] = []
        self.captures: list[tuple] = []
        self.flops = student_flops(conf, traffic, device)

    def spans(self):
        from thinktwice_tpu_torch.sensors import raycast

        d = self.device
        self.k2 = Span(raycast, "ray_boxes_table", "k2", d, keep=True)
        return [Span(self.ttd, "cameras_from_state", "cameras_from_state", d),
                Span(self.ttd, "lidar_from_state", "lidar_from_state", d),
                Span(self.model, "forward", "student_forward", d),
                Span(self.sim_step, "step_world", "step_world", d), self.k2]

    def _history(self):
        """Copies of the ring slot this call reads as its history sweep
        (the call overwrites it in place)."""
        d = self.driver
        slot = d.tick % d.rgb_ring.shape[1]
        return {k: getattr(d, k)[:, slot].clone() for k in RINGS}

    def _tick(self, keep: bool) -> None:
        ttd, cfg, state = self.ttd, self.cfg, self.state
        sdraws = ttd.sample_sensor_draws(cfg, state.n_worlds, self.device, self.g)
        before = (state, self.driver.agent, self.driver.tick, self._history(), sdraws) \
            if keep else None
        for t in self.taps.values():
            t.on = keep
        ctrl, self.driver = self.policy(self.town, state, self.driver, draws=sdraws)
        self.policy_calls += 1
        draws = self.sim_step.sample_step_draws(self.town, state, self.g)
        self.state, _ = self.sim_step.step_world(cfg, self.town, state, ctrl, draws=draws)
        if keep:
            taps = self.taps
            self.captures.append(before + (taps["cameras"].last, taps["lidar"].last,
                                           taps["model"].last, ctrl, draws, self.state))
            for t in taps.values():
                t.on, t.last = False, None

    def warm_up(self, seconds: float) -> None:
        n = self.traffic["warmup_ticks"]
        for _ in range(n - 1):
            self._tick(False)
        sync(self.device)
        t = time.perf_counter()
        self._tick(False)
        sync(self.device)
        self.samples = choose_checks(self.seed, seconds, time.perf_counter() - t, 1,
                                     self.traffic["checks"])
        self.policy_calls = 0

    def step(self, i: int) -> None:
        self._tick(i in self.samples)

    def record(self, run: dict) -> None:
        run["policy_calls"] = self.policy_calls
        run["flops_per_call"] = self.flops
        run["peak_flop_per_s"] = peak(self.conf)
        if getattr(self, "k2", None) is not None and self.k2.calls:
            run["k2"] = {"kernel": "ray_boxes_kernel",
                         "inputs": [(a[0], a[1], a[2], kw.get("grid", a[3] if len(a) > 3 else None))
                                    for a, kw, _ in self.k2.calls]}

    def release(self) -> None:
        for t in self.taps.values():
            t.remove()
        for k in ("model", "policy", "driver", "town", "state", "k2", "taps"):
            self.__dict__.pop(k, None)

    def check(self, control: bool = False) -> dict:
        from port_bench.reference.student_check import check

        return check(self.conf, self.traffic, self.seed, self.device, self.state0,
                     self.captures, control)
