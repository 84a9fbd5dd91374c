"""The training step: loss, gradients, clip, AdamW, data-parallel over a
process group (counterpart of `thinktwice_tpu/train/train_step.py`).

The optimizer is optax's chain, written as tensor arithmetic so that it
takes the same steps:

- `clip_by_global_norm(grad_clip)`: when the global norm exceeds the limit,
  every gradient becomes (g / norm) * limit (no epsilon);
- `adamw`: b1 0.9, b2 0.999, eps (1e-8 unless given) added after the
  square root, bias correction, and weight decay on every parameter (no
  mask: biases, norm scales and embeddings decay too), the update scaled by
  the learning rate;
- `warmup_cosine_decay_schedule`: linear from lr * 1e-3 to lr over
  warmup_steps, then a cosine down to lr * 1e-2 at total_steps, read at the
  count of updates made before this one (the first step uses lr * 1e-3).
  The schedule is float32 arithmetic in optax's order.

`Adam` is `optax.chain(clip_by_global_norm(grad_clip), adam(lr, eps))`, the
expert trainers' optimizer: the same step without weight decay, at a
constant learning rate.

Parameters are the model's own tensors (`TrainState.params`, by name) and
are updated in place. With grad_accum = K the batch splits into K chunks
along its leading axis, and the gradients, the loss and the metrics are
averaged over them; `grad_norm` in the metrics is the norm before the clip.

Data parallelism, the counterpart of the JAX package's `data` mesh: a
`parallel.launch.Group` of one process per card (`data_group`), each rank
holding its rows of the global batch (`shard_batch`) and the same state
(`replicate`). `make_train_step(..., group=group)` all-reduces the
gradients (one flat buffer), the loss and the metrics as their mean over
the ranks before `grad_norm` and the clip, so every rank clips and steps
as the JAX step does on the global gradient. The all-reduce is explicit,
not `DistributedDataParallel`'s: the step takes its gradients with
`torch.autograd.grad` through rematerialized blocks, which DDP's hooks on
`.backward()` do not see. The loss must be the rank's share of the global
loss (`total_loss(..., group=group)`), whose mean over the ranks is the
loss of the global batch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.parallel.launch import Group, flat_collective, init_group

B1, B2, EPS = 0.9, 0.999, 1e-8


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class AdamState:
    count: int                          # updates made
    mu: dict[str, torch.Tensor]         # first moments, by parameter name
    nu: dict[str, torch.Tensor]         # second moments


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]     # the model's parameters, by name
    opt_state: AdamState


class AdamW:
    """optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay)) as a
    step on tensors."""

    def __init__(self, lr: float, weight_decay: float, warmup_steps: int,
                 total_steps: int, grad_clip: float, eps: float = EPS):
        self.lr, self.weight_decay = lr, weight_decay
        self.warmup_steps, self.total_steps = warmup_steps, total_steps
        self.grad_clip, self.eps = grad_clip, eps

    def schedule(self, count: int) -> float:
        """The learning rate of the update made after `count` others."""
        init, peak, end = self.lr * 1e-3, self.lr, self.lr * 1e-2
        warm = self.warmup_steps
        if count < warm:
            c = _f32(min(max(count, 0), warm))
            frac = 1 - c / warm
            return float(_f32(init - peak) * frac + _f32(peak))
        decay = float(self.total_steps - warm)
        alpha = 0.0 if peak == 0.0 else end / peak
        c = torch.minimum(_f32(count - warm), _f32(decay))
        cosine = 0.5 * (1 + torch.cos(_f32(math.pi) * c / _f32(decay)))
        return float(_f32(peak) * ((1 - alpha) * cosine + alpha))

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu={k: torch.zeros_like(p) for k, p in params.items()},
                         nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             state: AdamState) -> tuple[AdamState, float]:
        """Update params in place from grads. -> (new state, the learning
        rate used)."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        norm = global_norm(g)
        if not bool(norm < self.grad_clip):
            g = torch._foreach_mul(torch._foreach_div(g, float(norm)), self.grad_clip)
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2))
        count = state.count + 1
        bc1 = float(1 - _f32(B1) ** count)
        bc2 = float(1 - _f32(B2) ** count)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        lr = self.schedule(state.count)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)
        return AdamState(count=count, mu=dict(zip(names, mu)), nu=dict(zip(names, nu))), lr


class Adam(AdamW):
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr, eps=eps)): AdamW's
    step with no weight decay and a constant learning rate."""

    def __init__(self, lr: float, grad_clip: float, eps: float = EPS):
        super().__init__(lr, 0.0, 0, 0, grad_clip, eps=eps)

    def schedule(self, count: int) -> float:
        return self.lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def make_optimizer(cfg: Config) -> AdamW:
    t = cfg.train
    return AdamW(t.lr, t.weight_decay, t.warmup_steps, t.total_steps, t.grad_clip)


def create_train_state(cfg: Config, params: dict[str, torch.Tensor]) -> TrainState:
    return TrainState(step=0, params=params, opt_state=make_optimizer(cfg).init(params))


# the counterpart of data_mesh: the process group whose ranks share a batch
data_group = init_group


def shard_batch(group: Group, batch: dict, grad_accum: int = 1) -> dict:
    """This rank's rows of a global batch, on its device. The one-process
    step (and the JAX package's on its mesh) splits the global batch into
    grad_accum = K microbatches of consecutive rows, each normalized on its
    own; so rank r of n holds, for k = 0 .. K-1 in turn, the r-th n-th of
    microbatch k: rows [kL/K + rL/(nK), kL/K + (r+1)L/(nK)) of a leaf of L
    rows (a per-camera leaf's rows lie example by example, so it is cut
    alike). split_batch then gives each rank its part of every microbatch.
    Scalars are shared."""
    n, K = group.size, grad_accum

    def one(x):
        if isinstance(x, tuple):
            return tuple(one(y) for y in x)
        if not torch.is_tensor(x) or x.dim() == 0:
            return x.to(group.device) if torch.is_tensor(x) else x
        L = x.shape[0]
        if L % (n * K):
            raise ValueError(f"a batch leaf of {L} rows does not split into {n} ranks x "
                             f"{K} microbatches")
        rows = x.reshape(K, n, L // (n * K), *x.shape[1:])[:, group.rank]
        return rows.reshape(L // n, *x.shape[1:]).to(group.device)

    return {k: one(v) for k, v in batch.items()}


@torch.no_grad()
def replicate(group: Group, state: TrainState) -> TrainState:
    """Every rank's state made rank 0's, in place: the parameters, the
    moments, the update count and the step."""
    tensors = [*state.params.values(), *state.opt_state.mu.values(),
               *state.opt_state.nu.values()]
    for t, v in zip(tensors, flat_collective(tensors, group.broadcast_)):
        t.copy_(v)
    counts = group.broadcast_(torch.tensor([state.step, state.opt_state.count],
                                           device=group.device))
    step, count = (int(c) for c in counts)
    return TrainState(step=step, params=state.params,
                      opt_state=dataclasses.replace(state.opt_state, count=count))


def all_mean(group: Group, values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The mean over the ranks of each value, by one all-reduce of a flat
    buffer."""
    def mean_(flat):
        group.all_sum_(flat).div_(group.size)

    dtype = functools.reduce(torch.promote_types, (v.dtype for v in values.values()))
    means = flat_collective([v.to(dtype) for v in values.values()], mean_)
    return {k: m.to(v.dtype) for (k, v), m in zip(values.items(), means)}


def split_batch(batch: dict, k: int) -> list[dict]:
    """The batch's k chunks along the leading axis of every tensor (tuples
    of tensors split leaf-wise; scalars and None are shared)."""

    def chunks(x):
        if isinstance(x, tuple):
            return list(zip(*(chunks(y) for y in x)))
        if torch.is_tensor(x) and x.dim() > 0:
            return list(torch.chunk(x, k, dim=0))
        return [x] * k

    parts = {key: chunks(v) for key, v in batch.items()}
    return [{key: parts[key][i] for key in batch} for i in range(k)]


def make_train_step(cfg: Config, loss_fn: Callable[[dict], tuple[torch.Tensor, dict]],
                    probe: Callable[[str, object], None] | None = None,
                    group: Group | None = None):
    """loss_fn(batch) -> (scalar loss, metrics), computed by the model that
    owns the state's parameters. -> step(state, batch) -> (state, metrics
    as float32 scalars, grad_norm included).

    probe(stage, value), when given, is called as each stage's work has
    been issued: ("forward", loss) after each chunk's loss, ("backward",
    gradients by name) once they are averaged, before the clip, and
    ("optimizer", lr) after the update. It lets a caller time the stages
    of the step that `loop.train` runs and read its gradients.

    With a group, batch is this rank's shard (shard_batch) and loss_fn
    gives the rank's share of the global loss; "backward" then sees the
    rank's own gradients, and ("reduce", gradients by name) follows once
    they, the loss and the metrics are averaged over the ranks."""
    tx = make_optimizer(cfg)
    K = cfg.train.grad_accum
    probe = probe or (lambda stage, value: None)

    def grads_of(params, batch):
        loss, metrics = loss_fn(batch)
        probe("forward", loss)
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient (and is
        # still decayed), as jax.grad gives it
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), got)}
        return {k: v.detach() for k, v in metrics.items()}, grads

    def step(state: TrainState, batch: dict):
        if K <= 1:
            metrics, grads = grads_of(state.params, batch)
        else:
            msum = gsum = None
            for mb in split_batch(batch, K):
                m, g = grads_of(state.params, mb)
                if gsum is None:
                    msum, gsum = m, g
                else:
                    msum = {k: msum[k] + m[k] for k in msum}
                    gsum = {k: gsum[k] + g[k] for k in gsum}
            metrics = {k: v / K for k, v in msum.items()}
            grads = {k: v / K for k, v in gsum.items()}
        probe("backward", grads)
        if group is not None:
            grads, metrics = all_mean(group, grads), all_mean(group, metrics)
            probe("reduce", grads)
        metrics["grad_norm"] = global_norm(list(grads.values()))
        opt_state, lr = tx.step(state.params, grads, state.opt_state)
        probe("optimizer", lr)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    return step
