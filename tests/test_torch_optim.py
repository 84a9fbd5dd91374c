"""PyTorch port parity: the optimizer and the train step of
thinktwice_tpu_torch against optax (thinktwice_tpu.train.train_step) on the
CPU.

- The same parameters and the same gradients, 6 steps through the port's
  AdamW and the JAX package's optax chain (clip_by_global_norm 35, adamw,
  warmup_cosine_decay): the steps span the 3-step warmup and the cosine,
  one gradient's global norm exceeds 35 (the clip fires), and every leaf,
  biases and norm scales included, decays. Parameters agree to 1e-6
  relative after every step, the learning rates are equal, and the global
  norms agree to float32 rounding (1e-6 relative: the two sum the leaves in
  another order).
- grad_accum = 2 gives the step of grad_accum = 1 on the same batch.
- The train step's probe sees one forward a chunk, then the averaged
  gradients, then the step's learning rate.
- A train state saved and restored takes the same next step, bit for bit.
- The expert trainers' Adam holds to optax.chain(clip_by_global_norm,
  adam(lr, eps)) over 3 steps, to 1e-6 (the parameters' change to 1e-3
  of a step of lr): PPO's clip 0.5, eps 1e-5 at lr
  3e-5 and BC's clip 1.0, eps 1e-8 at lr 3e-4, with one gradient under the
  clip, one over it and one with elements far below eps.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from thinktwice_tpu.config import Config as JConfig
from thinktwice_tpu.config import TrainConfig as JTrain
from thinktwice_tpu.train.train_step import make_optimizer as jax_make_optimizer
from thinktwice_tpu_torch.config import Config, TrainConfig
from thinktwice_tpu_torch.train import checkpoint as ckpt_lib
from thinktwice_tpu_torch.train.train_step import (
    Adam,
    create_train_state,
    global_norm,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(1)

TRAIN = dict(lr=1e-3, warmup_steps=3, total_steps=10, weight_decay=0.01)
SHAPES = {"conv.weight": (8, 4, 3, 3), "conv.bias": (8,), "norm.weight": (8,),
          "norm.bias": (8,), "dense.weight": (5, 8), "embed": (4, 16)}


def test_adamw_matches_optax():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    params["norm.weight"] = np.ones(SHAPES["norm.weight"], np.float32)
    tx_j = jax_make_optimizer(JConfig(train=JTrain(**TRAIN)))
    tx = make_optimizer(Config(train=TrainConfig(**TRAIN)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx_j.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = tx.init(tp)
    sched = optax.warmup_cosine_decay_schedule(1e-6, 1e-3, 3, 10, 1e-5)
    norms = []
    for step in range(6):
        grads = {k: rng.standard_normal(s).astype(np.float32) * (20.0 if step == 2 else 1.0)
                 for k, s in SHAPES.items()}
        ref_norm = float(optax.global_norm(grads))
        norms.append(ref_norm)
        updates, jstate = tx_j.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate, lr = tx.step(tp, {k: torch.tensor(g) for k, g in grads.items()}, tstate)
        assert lr == float(sched(step)), (step, lr, float(sched(step)))
        assert lr == tx.schedule(step)
        got_norm = float(global_norm([torch.tensor(g) for g in grads.values()]))
        assert abs(got_norm - ref_norm) <= 1e-6 * ref_norm
        for k in params:
            ref = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=f"{k} step {step}")
    assert max(norms) > 35.0 > min(norms)         # the clip fired once, not always
    assert tstate.count == 6


def _tiny(seed=0):
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(), torch.nn.Linear(16, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return model


def _batch(seed=1, B=8):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn((B, 6), generator=g), "y": torch.randn((B, 3), generator=g),
            "distil_weight": torch.tensor(1.0)}


def _loss_fn(model):
    def loss_fn(batch):
        loss = ((model(batch["x"]) - batch["y"]) ** 2).mean()
        return loss, {"loss": loss}

    return loss_fn


def _one_step(grad_accum):
    cfg = Config(train=TrainConfig(**TRAIN, grad_accum=grad_accum))
    model = _tiny()
    state = create_train_state(cfg, dict(model.named_parameters()))
    state, metrics = make_train_step(cfg, _loss_fn(model))(state, _batch())
    return {k: v.detach().clone() for k, v in state.params.items()}, metrics


def test_grad_accum_equals_the_whole_batch():
    p1, m1 = _one_step(1)
    p2, m2 = _one_step(2)
    assert set(m1) == set(m2) == {"loss", "grad_norm"}
    for k in m1:
        assert abs(float(m1[k]) - float(m2[k])) <= 1e-6 * abs(float(m1[k])), k
    for k in p1:
        torch.testing.assert_close(p2[k], p1[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_probe_sees_each_stage_and_the_step_gradients(grad_accum):
    cfg = Config(train=TrainConfig(**TRAIN, grad_accum=grad_accum))
    model = _tiny()
    state = create_train_state(cfg, dict(model.named_parameters()))
    seen = []
    make_train_step(cfg, _loss_fn(model), lambda stage, value: seen.append((stage, value)))(
        state, _batch())
    assert [s for s, _ in seen] == ["forward"] * grad_accum + ["backward", "optimizer"]
    ref = _tiny()
    loss, _ = _loss_fn(ref)(_batch())
    want = torch.autograd.grad(loss, list(ref.parameters()))
    grads = seen[grad_accum][1]
    assert list(grads) == [k for k, _ in ref.named_parameters()]
    for g, w in zip(grads.values(), want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    assert seen[-1][1] == make_optimizer(cfg).schedule(0)


def test_saved_train_state_takes_the_same_next_step(tmp_path):
    cfg = Config(train=TrainConfig(**TRAIN))
    model = _tiny()
    state = create_train_state(cfg, dict(model.named_parameters()))
    step = make_train_step(cfg, _loss_fn(model))
    state, _ = step(state, _batch(1))
    ckpt_lib.save_train_state(str(tmp_path / "ckpt"), state)
    state, _ = step(state, _batch(2))
    after = {k: v.detach().clone() for k, v in state.params.items()}

    model2 = _tiny(seed=5)                       # other weights, overwritten by the restore
    state2 = create_train_state(cfg, dict(model2.named_parameters()))
    state2 = ckpt_lib.restore_train_state(str(tmp_path / "ckpt"), state2)
    assert state2.step == 1 and state2.opt_state.count == 1
    state2, _ = make_train_step(cfg, _loss_fn(model2))(state2, _batch(2))
    assert state2.step == 2
    for k, v in after.items():
        assert torch.equal(state2.params[k], v), k


@pytest.mark.parametrize("clip,eps,lr", [(0.5, 1e-5, 3e-5), (1.0, 1e-8, 3e-4)])
def test_adam_matches_optax(clip, eps, lr):
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    tx_j = optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr, eps=eps))
    tx = Adam(lr, clip, eps=eps)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx_j.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = tx.init(tp)
    for step, scale in enumerate((0.01, 5.0, 1e-7)):
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in SHAPES.items()}
        updates, jstate = tx_j.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate, used = tx.step(tp, {k: torch.tensor(g) for k, g in grads.items()}, tstate)
        assert used == lr
        for k in params:
            ref = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=f"{k} step {step}")
            # the parameters' change, to 1e-3 of a step of lr
            moved = ref.astype(np.float64) - params[k]
            np.testing.assert_allclose(tp[k].numpy() - params[k].astype(np.float64), moved,
                                       rtol=0, atol=1e-3 * lr, err_msg=f"{k} step {step}")
            assert 0.5 * lr < np.abs(moved).max() <= 3.5 * lr
    assert tstate.count == 3
