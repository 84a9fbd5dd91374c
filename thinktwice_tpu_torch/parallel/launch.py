"""Process groups: one process per card (the counterpart of the JAX
package's `Mesh` over devices, `thinktwice_tpu/parallel/worlds.py:25-27`
and `thinktwice_tpu/train/train_step.py:65-67`).

A `Group` is one process's place in a `torch.distributed` group: its rank,
the group's size, the device the rank computes on and the backend of its
collectives. `init_group` joins the group, reading torchrun's `RANK`,
`WORLD_SIZE` and `LOCAL_RANK` or taking them as arguments. `spawn` starts
the ranks itself, one process each, meeting through a file store, so no
TCP port is fixed and several groups can start on one host at once.

Rank r computes on `cuda:{local rank}`. The backend is NCCL for a card and
gloo for the CPU; nothing falls back. More NCCL ranks than cards, or two
NCCL ranks on one card, raise. Sharing one card among gloo ranks takes
`devices=[...]` given explicitly.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from thinktwice_tpu_torch import resolve_device

TIMEOUT_S = 600.0   # a collective, and a spawned group's join, fail after this


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's rank of `size` in the default process group."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def all_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Overwrite t with its sum over the ranks, in place."""
        dist.all_reduce(t)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, as a new tensor (t stays as it is)."""
        return self.all_sum_(t.detach().clone())

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite t with rank src's t, in place."""
        dist.broadcast(t, src)
        return t

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's t (equal shapes), in rank order, on t's device.
        Under gloo the tensors travel through the host."""
        x = (t.cpu() if self.backend == "gloo" else t).contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x)
        return [o.to(t.device) for o in out]


def flat_collective(tensors: list[torch.Tensor], op: Callable[[torch.Tensor], Any]
                    ) -> list[torch.Tensor]:
    """Apply op in place to the tensors as one flat buffer (one collective
    for all of them) -> the results, shaped as the tensors. They must share
    one dtype."""
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("a flat collective needs tensors of one dtype")
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    op(flat)
    return [x.view_as(t) for x, t in zip(torch.split(flat, [t.numel() for t in tensors]),
                                         tensors)]


def init_group(rank: int | None = None, size: int | None = None,
               local_rank: int | None = None, device: str | torch.device | None = None,
               backend: str | None = None, init_method: str | None = None,
               timeout: float = TIMEOUT_S) -> Group:
    """Join the process group. rank, size and local_rank default to
    torchrun's RANK, WORLD_SIZE and LOCAL_RANK (init_method then defaults
    to env://, its MASTER_ADDR and MASTER_PORT). device defaults to
    cuda:{local_rank}; backend to nccl for a card, gloo for the CPU."""
    env = os.environ
    if rank is None or size is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            raise RuntimeError("RANK and WORLD_SIZE are not set: run under torchrun, or "
                               "pass rank and size")
        rank = int(env["RANK"]) if rank is None else rank
        size = int(env["WORLD_SIZE"]) if size is None else size
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    device = resolve_device(f"cuda:{local_rank}" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} takes {device}, but {torch.cuda.device_count()} "
                               "card(s) are present")
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a card; rank {rank} is on {device}")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=timeout))
    return Group(rank=rank, size=size, device=device, backend=backend)


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn, args, size: int, backend: str, devices: list[str],
               init_file: str, out_dir: str, timeout: float) -> None:
    if devices[rank] == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the ranks share the host's cores: n ranks of all of them each
        # oversubscribe it many times over
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    group = init_group(rank, size, local_rank=rank, device=devices[rank], backend=backend,
                       init_method=f"file://{init_file}", timeout=timeout)
    try:
        result = fn(group, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), backend: str | None = None,
          devices: list | None = None, init_file: str | None = None,
          timeout: float = TIMEOUT_S) -> list:
    """Run fn(group, *args) in nprocs new processes, rank r on devices[r]
    (default cuda:r), and return their results in rank order (on the CPU).

    fn and args are pickled (fn by its import path). The ranks meet through
    a file store at init_file (default: a fresh temporary file). Every rank
    is joined within timeout seconds; past it the ranks are killed and
    TimeoutError is raised. A rank that raises kills the others, and its
    traceback is raised here."""
    if devices is None:
        n = torch.cuda.device_count()
        if nprocs > n:
            raise RuntimeError(f"{nprocs} ranks need {nprocs} cards, {n} found: pass "
                               "devices=[...] to run gloo ranks on the CPU or on one card")
        devices = [f"cuda:{r}" for r in range(nprocs)]
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    backend = backend or ("nccl" if all(d.startswith("cuda") for d in devices) else "gloo")
    if backend == "nccl" and len(set(devices)) < nprocs:
        raise RuntimeError(f"NCCL takes one rank per card, got {devices}: share a card "
                           "among gloo ranks")
    with tempfile.TemporaryDirectory() as tmp:
        store = init_file or os.path.join(tmp, "store")
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, nprocs, backend, devices, store, tmp, timeout),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} did not finish "
                                       f"within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(nprocs)]
