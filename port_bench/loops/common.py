"""What the loops share: the configuration's precision, the peak it is
held to, and the port's Config of a configuration and a traffic file."""

from __future__ import annotations

import torch

from port_bench.counts.peaks import flop_per_s
from port_bench.reference.configs import make_config


def set_precision(conf: dict) -> None:
    """Run float32 matrix work as the configuration states it: TF32 on or
    off."""
    tf32 = bool(conf["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def peak(conf: dict) -> float:
    """The dense peak of the precision the configuration declares for its
    matrix work."""
    p = conf["precision"]
    return flop_per_s("tf32" if p["matrix"] == "float32" and p["tf32"] else p["matrix"])


def program_config(conf: dict, traffic: dict):
    """The port's Config of this configuration and traffic."""
    from thinktwice_tpu_torch import config

    return make_config(conf, traffic, config)


def grid_world(cfg, traffic: dict, device, generator):
    """The port's grid town and reset worlds of the traffic file."""
    from thinktwice_tpu_torch.rollout import grid_world as port_grid_world

    if traffic["town"]["kind"] != "grid":
        raise ValueError(f"unknown town kind {traffic['town']['kind']!r}")
    return port_grid_world(cfg, traffic["worlds"], traffic["vehicles"], device=device,
                           generator=generator)


def choose_checks(seed: int, seconds: float, per_tick_s: float, every: int, n: int) -> list[int]:
    """The window's ticks to check against the reference: n ticks, multiples
    of every, drawn from the seed over the first four fifths of the
    window's expected length."""
    import numpy as np

    expect = max(1, int(0.8 * seconds / per_tick_s) // every)
    rng = np.random.default_rng(seed)
    return sorted(set(int(k) * every for k in rng.integers(0, expect, n)))
