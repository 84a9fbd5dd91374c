"""PyTorch port parity: checkpoints and archives of thinktwice_tpu_torch
against flax and thinktwice_tpu on the CPU.

- The port's `archive_params` file is read by flax's msgpack_restore into
  the tree the JAX package holds, leaf for leaf bit-equal, and its bytes
  are the bytes flax writes for that tree.
- The JAX package's `archive_params` file is read by the port.
- state_dict -> flax tree -> state_dict is exact, and so is flax tree ->
  state_dict -> flax tree on the student_rl6 archive (Bottleneck blocks).
- `loop.train` logs its steps and validations, resumes from its own
  checkpoint (the step count goes on; a step with IDA augmentation), and
  from `params.msgpack` beside the checkpoint directory once that
  directory is gone (fresh optimizer state).
- A Roach policy's archive written by the port is read by the JAX
  package's restore_pytree and by the port's load_roach_policy (equal
  leaves, the same forward), and the repository's Roach archives
  (roach_bc5, roach_rl5, roach_rl6) give the same forward in both packages.
"""

import itertools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_train_model import CAMS, random_params
from test_torch_train_model_full import FROZEN, _torch_batch, model_inputs
from thinktwice_tpu.config import ModelConfig as JaxModelConfig
from thinktwice_tpu.models.encoder_decoder import ThinkTwiceModel as JaxThinkTwiceModel
from thinktwice_tpu.train import checkpoint as jax_ckpt
from thinktwice_tpu_torch.config import CameraConfig, Config, ModelConfig, TrainConfig
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel
from thinktwice_tpu_torch.train import checkpoint as ckpt
from thinktwice_tpu_torch.train import loop
from thinktwice_tpu_torch.weights import (
    flax_tree_from_student_state_dict,
    load_flax_msgpack,
    student_state_dict_from_flax,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT_RL6 = os.path.join(REPO, "runs", "student_rl6", "params.msgpack")


def _jax_tiny_params():
    """A seeded flax tree of the two-sweep ResNet-10 student at the frozen
    dry-run shapes."""
    args, s2k, _, _ = model_inputs()
    jmodel = JaxThinkTwiceModel(JaxModelConfig(**FROZEN), backbone_depth=10, n_sweeps=2)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                *[jnp.asarray(a) for a in args],
                                                sweep2key=jnp.asarray(s2k)))
    return random_params(shapes)


def _port_model():
    return ThinkTwiceModel(ModelConfig(**FROZEN), backbone_depth=10, n_sweeps=2, n_cams=2)


def _assert_same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_port_archive_is_read_by_flax(tmp_path):
    tree = jax.tree.map(np.asarray, _jax_tiny_params())
    model = _port_model()
    sd = student_state_dict_from_flax(tree, model)
    path = str(tmp_path / "params.msgpack")
    ckpt.archive_params(path, sd)
    with open(path, "rb") as f:
        data = f.read()
    restored = serialization.msgpack_restore(data)
    _assert_same_tree(restored, tree)
    assert data == serialization.msgpack_serialize(restored)
    assert not os.path.exists(path + ".tmp")


def test_jax_archive_is_read_by_the_port(tmp_path):
    tree = jax.tree.map(np.asarray, _jax_tiny_params())
    path = str(tmp_path / "params.msgpack")
    jax_ckpt.archive_params(path, tree)
    model = _port_model()
    got = ckpt.restore_archive(path, model)
    want = student_state_dict_from_flax(tree, model)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert ckpt.restore_pytree(path, model).keys() == want.keys()


def test_state_dict_and_flax_tree_round_trip():
    model = _port_model()
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in model.state_dict().items()}
    back = student_state_dict_from_flax(flax_tree_from_student_state_dict(sd), model)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # the student_rl6 archive (Bottleneck blocks) through the port and back
    tree = load_flax_msgpack(STUDENT_RL6)
    with torch.device("meta"):
        big = ThinkTwiceModel(Config().model, backbone_depth=50, n_sweeps=2, n_cams=4)
    _assert_same_tree(flax_tree_from_student_state_dict(student_state_dict_from_flax(tree, big)),
                      tree)


def _train_cfg():
    return Config(camera=CameraConfig(**CAMS), model=ModelConfig(**FROZEN),
                  train=TrainConfig(lr=1e-3, warmup_steps=2, total_steps=20))


def _batch():
    args, s2k, _, batch = model_inputs()
    b = _torch_batch(batch)
    imgs, points, mask, speed, tp, cmd = (torch.as_tensor(a) for a in args[:6])
    b.update(imgs=imgs, points=points, points_mask=mask, speed=speed, target_point=tp,
             command=cmd, sweep2key=torch.as_tensor(s2k))
    return b


def test_train_resumes_from_its_checkpoint_and_from_the_archive(tmp_path, capsys):
    cfg, batch = _train_cfg(), _batch()
    ckpt_dir = str(tmp_path / "run" / "ckpt")
    archive = str(tmp_path / "run" / "params.msgpack")

    def model():
        return loop.make_model(cfg, backbone_depth=10, n_sweeps=2, device="cpu")

    log_path = os.path.join(ckpt_dir, "train.jsonl")       # as the CLI's, before the dir exists
    state = loop.train(cfg, model(), itertools.repeat(batch), 2, ckpt_dir=ckpt_dir,
                       ckpt_every=1, log_every=1, log_path=log_path,
                       val_batches_fn=lambda: [batch], eval_every=2)
    assert state.step == 2 and os.path.exists(archive)
    lines = [json.loads(line) for line in open(log_path).read().splitlines()]
    assert [line["step"] for line in lines] == [1, 2, 2]
    assert all({"loss", "grad_norm", "collect_s", "grad_s", "wall_s"} <= set(line)
               for line in lines[:2])
    assert np.isfinite(lines[2]["val_loss"]) and "val_depth_loss" in lines[2]

    m2 = model()
    state = loop.train(cfg, m2, itertools.repeat(batch), 1, ckpt_dir=ckpt_dir, resume=True,
                       augment_ida=True)
    assert "resumed from step 2" in capsys.readouterr().out
    assert state.step == 3 and state.opt_state.count == 3

    shutil.rmtree(ckpt_dir)
    want = ckpt.restore_archive(archive, m2)
    m3 = model()
    state = loop.train(cfg, m3, iter(()), 0, ckpt_dir=ckpt_dir, resume=True)
    assert "resumed params from" in capsys.readouterr().out
    assert state.step == 0 and state.opt_state.count == 0
    for k, v in m3.state_dict().items():
        assert torch.equal(v, want[k]), k


# --------------------------------------------------------------------------
# Roach archives, both ways

ROACH_RUNS = ("roach_bc5", "roach_rl5", "roach_rl6")
ROACH_PARAMS = 1_460_021


def _roach_raster():
    rng = np.random.default_rng(0)
    bv = rng.choice([0.0, 80 / 255, 120 / 255, 1.0], size=(2, 15, 192, 192)).astype(np.float32)
    sv = np.array([[0.5, 0.1, 0.0, 1.0, 4.0, 0.0], [0.0, -0.2, 1.0, 1.0, 0.5, 0.0]], np.float32)
    return bv, sv


def _assert_roach_forward(policy, jparams, tol=1e-4):
    from thinktwice_tpu.agents.roach import RoachPolicy as JaxRoachPolicy

    bv, sv = _roach_raster()
    ref = JaxRoachPolicy().apply(jparams, jnp.asarray(bv), jnp.asarray(sv))
    with torch.no_grad():
        out = policy(torch.from_numpy(bv), torch.from_numpy(sv))
    for key in ("alpha", "beta", "value"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=tol, atol=tol,
                                   err_msg=key)
    return out


def test_roach_archive_is_read_by_both_packages(tmp_path):
    """A RoachPolicy drawn from the JAX package's initial distribution,
    archived by the port: the JAX package's restore_pytree reads every leaf
    bit for bit into its own template, the port's load_roach_policy gives
    the same state_dict and, on the same raster, the JAX forward's alpha,
    beta and value within 1e-4 and its own forward bit for bit."""
    from thinktwice_tpu.agents.roach import RoachPolicy as JaxRoachPolicy
    from thinktwice_tpu_torch.agents.roach import RoachPolicy, init_roach_params
    from thinktwice_tpu_torch.weights import flax_tree_from_roach_state_dict, load_roach_policy

    cfg = Config()
    policy = RoachPolicy.from_config(cfg)
    init_roach_params(policy, torch.Generator().manual_seed(3))
    assert sum(p.numel() for p in policy.parameters()) == ROACH_PARAMS
    path = str(tmp_path / "params.msgpack")
    ckpt.archive_params(path, policy.state_dict())

    template = JaxRoachPolicy().init(jax.random.key(0), jnp.zeros((1, 15, 192, 192)),
                                     jnp.zeros((1, 6)))
    restored = jax_ckpt.restore_pytree(path, template)
    want = flax_tree_from_roach_state_dict(policy.state_dict())
    assert jax.tree.structure(restored) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a, b)

    loaded = load_roach_policy(path, cfg, device="cpu")
    for k, v in policy.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    out = _assert_roach_forward(loaded, restored)
    with torch.no_grad():
        again = policy(*(torch.from_numpy(x) for x in _roach_raster()))
    for key in ("alpha", "beta", "value"):
        assert torch.equal(out[key], again[key])
    # the archive restores into a RoachPolicy template through the port's
    # restore_pytree too
    sd = ckpt.restore_pytree(path, RoachPolicy.from_config(cfg))
    assert all(torch.equal(sd[k], v) for k, v in policy.state_dict().items())


@pytest.mark.parametrize("run", ROACH_RUNS)
def test_roach_runs_give_the_same_forward_in_both_packages(run):
    """Each Roach archive of the repository at full size (1,460,021
    parameters): the port's forward within 1e-4 of the JAX package's, and
    the archive rewritten by the port holds the same leaves."""
    from thinktwice_tpu_torch.weights import flax_tree_from_roach_state_dict, load_roach_policy

    path = os.path.join(REPO, "runs", run, "params.msgpack")
    with open(path, "rb") as f:
        jparams = serialization.msgpack_restore(f.read())
    policy = load_roach_policy(path, Config(), device="cpu")
    assert sum(p.numel() for p in policy.parameters()) == ROACH_PARAMS
    _assert_roach_forward(policy, jparams)
    back = flax_tree_from_roach_state_dict(policy.state_dict())
    flat_a = dict(_flat(jparams))
    flat_b = dict(_flat(back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert np.array_equal(np.asarray(flat_a[k], np.float32), flat_b[k]), k


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v
