"""The ThinkTwice student's closed loop with its published sparse LiDAR
encoder (`lidar_encoder: sparse`): the student loop (`loops/student.py`)
with the program's configuration carrying the encoder's settings (the
configuration file's `sparse_lidar`), and with what its comparison and its
metrics read besides:

- at the checked ticks, the points and mask the encoder took, its voxels
  (coordinates, kept point indices, counts) and its dense output, for
  `voxel_flips` and `encoder_gap` (`reference/student_spconv_check.py`);
- in a traced run, a summary of each launch of K5 (the voxelizer), K6 (a
  sparse convolution) and K7 (a rulebook): its sizes and the device
  tensors that hold its counts, never its arrays, for the rooflines;
- the model FLOPs of a policy call: the reference's dense stages counted
  from shapes (no LiDAR encoder's dense conv3d: the reference's is not the
  program's work), plus 2 x pairs x C_in x C_out of each sparse
  convolution, its pairs read from the rulebooks of the last warm-up
  call's own points.

The parent of this configuration cannot run it: its ModelConfig has no
`lidar_encoder`, and the loop stops there, in set-up.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from port_bench.clock import sync
from port_bench.counts.flops import count_flops
from port_bench.loops import student
from port_bench.loops.common import choose_checks, grid_world, peak, program_config, set_precision
from port_bench.reference.seeded import seeded_params
from port_bench.spans import Tap


def _tuples(v):
    return tuple(_tuples(a) for a in v) if isinstance(v, list) else v


def sparse_config(conf: dict, traffic: dict):
    """The port's Config of the configuration, its encoder chosen and set."""
    cfg = program_config(conf, traffic)
    settings = {k: _tuples(v) for k, v in conf["sparse_lidar"].items()}
    model = dataclasses.replace(cfg.model, lidar_encoder=conf["lidar_encoder"], **settings)
    return cfg.replace(model=model)


class Summary:
    """A span-like wrapper of module.name: while `capturing`, keeps
    summarize(args, kwargs, result) of each call, and no stamps. The
    harness installs the launch summaries with the loop's spans in a traced
    run; the loop installs its own captures of the encoder's calls."""

    def __init__(self, module, name: str, span: str, summarize):
        self._mod, self._name, self.span, self._summarize = module, name, span, summarize
        self.stamps: list = []
        self.calls: list = []
        self.capturing = False
        self._real = None

    def install(self) -> "Summary":
        real = self._real = getattr(self._mod, self._name)

        def wrapper(*args, **kwargs):
            out = real(*args, **kwargs)
            if self.capturing:
                self.calls.append(self._summarize(args, kwargs, out))
            return out

        setattr(self._mod, self._name, wrapper)
        return self

    def remove(self) -> None:
        if self._real is not None:
            setattr(self._mod, self._name, self._real)
            self._real = None

    def ms(self) -> list:
        return []


def _k5(args, kwargs, vox):
    points = args[0]
    B, P, F = points.shape
    return {"B": B, "P": P, "F": F, "M": int(vox.point_idx.shape[1]), "n": vox.n}


def _k6(args, kwargs, out):
    x, rb, weight = args[:3]
    residual = args[4] if len(args) > 4 else kwargs.get("residual")
    return {"n_in": rb.n_in, "n_out": rb.n_out, "pairs": rb.pairs, "K": int(rb.nbr.shape[1]),
            "cin": int(weight.shape[1]), "cout": int(weight.shape[0]),
            "residual": residual is not None}


def _k7_subm(args, kwargs, rb):
    return {"n_out": rb.n_out, "K": int(rb.nbr.shape[1]), "n_in": None}


def _k7_strided(args, kwargs, out):
    level, rb = out
    return {"n_out": rb.n_out, "K": int(rb.nbr.shape[1]), "n_in": rb.n_in}


def read_counts(calls: list) -> list:
    """The summaries with every device count read (after the window): a
    one-element tensor as an int, a longer one as a list."""
    def host(v):
        if not torch.is_tensor(v):
            return v
        v = v.reshape(-1).tolist()
        return v[0] if len(v) == 1 else v

    return [{k: host(v) for k, v in c.items()} for c in calls]


class Loop(student.Loop):
    def __init__(self, conf: dict, traffic: dict, seed: int, device: torch.device):
        from thinktwice_tpu_torch.agents import thinktwice_driver as ttd
        from thinktwice_tpu_torch.sim import step as sim_step
        from thinktwice_tpu_torch.train.loop import make_model

        self.conf, self.traffic, self.seed, self.device = conf, traffic, seed, device
        set_precision(conf)
        self.cfg = sparse_config(conf, traffic)
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
        enc = self.model.lidar_encoder
        self.lidar_taps = {
            "voxels": Summary(enc, "voxelize", "voxels", lambda a, k, out: (a, out)).install(),
            "encoder": Summary(enc, "encode", "encoder", lambda a, k, out: out).install()}
        self.lidar_captures: list[tuple] = []
        self.units_per_step = traffic["worlds"]
        self.trace_steps = traffic["trace_ticks"]
        self.policy_calls = 0
        self.samples: list[int] = []
        self.captures: list[tuple] = []
        self.flops = None
        self.launches: dict = {}

    def spans(self):
        from thinktwice_tpu_torch.ops import sparse_conv, voxelize

        out = super().spans()
        self.launches = {
            "k5": [Summary(voxelize, "voxelize", "k5", _k5)],
            "k6": [Summary(sparse_conv, "sparse_conv", "k6", _k6)],
            "k7": [Summary(sparse_conv, "subm_rulebook", "k7", _k7_subm),
                   Summary(sparse_conv, "strided_level", "k7.strided", _k7_strided)]}
        return out + [s for group in self.launches.values() for s in group]

    def _tick(self, keep: bool) -> None:
        for t in self.lidar_taps.values():
            t.capturing = keep
        super()._tick(keep)
        if keep:
            (points, mask), vox = self.lidar_taps["voxels"].calls[-1]
            dense = self.lidar_taps["encoder"].calls[-1]
            self.lidar_captures.append((points, mask, dataclasses.replace(vox, grid=None), dense))
        for t in self.lidar_taps.values():
            t.capturing = False
            t.calls.clear()

    def _dense_flops(self) -> int:
        """FLOPs of a policy call's forward without the LiDAR encoder's
        sparse part: the reference's model at the cell's shapes, its LiDAR
        encoder's SECOND and SECONDFPN run on a zero dense map."""
        from port_bench.reference.student_spconv_check import reference_config, reference_forward

        cfg = reference_config(self.conf, self.traffic)
        return count_flops(reference_forward(self.conf, cfg, self.traffic["worlds"],
                                             self.device))

    def _sparse_flops(self) -> int:
        """2 x pairs x C_in x C_out over the sparse convolutions of one
        policy call (the last warm-up call's points)."""
        from thinktwice_tpu_torch.ops import sparse_conv

        s = Summary(sparse_conv, "sparse_conv", "k6", _k6).install()
        s.capturing = True
        try:
            self._tick(False)
        finally:
            s.remove()
        sync(self.device)
        return sum(2 * c["pairs"] * c["cin"] * c["cout"] for c in read_counts(s.calls))

    def warm_up(self, seconds: float) -> None:
        n = self.traffic["warmup_ticks"]
        for _ in range(n - 2):
            self._tick(False)
        sparse = self._sparse_flops()
        sync(self.device)
        t = time.perf_counter()
        self._tick(False)
        sync(self.device)
        self.samples = choose_checks(self.seed, seconds, time.perf_counter() - t, 1,
                                     self.traffic["checks"])
        self.flops = self._dense_flops() + sparse
        self.policy_calls = 0

    def record(self, run: dict) -> None:
        super().record(run)
        run["flops_per_call"] = self.flops
        run["peak_flop_per_s"] = peak(self.conf)
        for key, group in self.launches.items():
            calls = [c for s in group for c in s.calls]
            if calls:
                run[key] = read_counts(calls)

    def release(self) -> None:
        for t in self.lidar_taps.values():
            t.remove()
        self.__dict__.pop("lidar_taps", None)
        super().release()

    def check(self, control: bool = False) -> dict:
        from port_bench.reference.student_spconv_check import check

        return check(self.conf, self.traffic, self.seed, self.device, self.state0,
                     self.captures, self.lidar_captures, control)
