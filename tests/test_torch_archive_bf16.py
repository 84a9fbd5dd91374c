"""PyTorch port parity: bfloat16 parameter archives of thinktwice_tpu_torch
against flax and thinktwice_tpu on the CPU.

- A bfloat16 archive of the JAX package's `archive_params(cast_floats=
  jnp.bfloat16)` restores in the port (`restore_archive`) to float32 leaves
  bit-equal to the JAX package's own restore.
- The port's `archive_params(cast_floats=torch.bfloat16)` writes bfloat16
  leaves that flax reads bit-equal to the same tree cast by the JAX
  package, and the JAX package restores it bit-equal to its own archive;
  `packb` writes flax's bytes for a bfloat16 tensor.
- Every one of the 691 bfloat16 leaves of `runs/student_town05/params.
  msgpack` decodes in the port (`load_flax_msgpack`) bit-equal to flax's
  `msgpack_restore` cast to float32. (That archive is a one-sweep student
  whose blocks are named `Bottleneck_*`; the port's model is not loaded
  from it.)
- A bfloat16 scalar and a 0-d array decode too.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from thinktwice_tpu.train import checkpoint as jax_ckpt
from thinktwice_tpu_torch.agents.roach import RoachPolicy
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.train import checkpoint as ckpt
from thinktwice_tpu_torch.weights import (
    flax_tree_from_roach_state_dict,
    load_flax_msgpack,
    packb,
    unpackb,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT_TOWN05 = os.path.join(REPO, "runs", "student_town05", "params.msgpack")


def _roach():
    """A Roach policy with seeded weights spread over bfloat16's range."""
    policy = RoachPolicy.from_config(Config())
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for p in policy.parameters():
            p.copy_(torch.tensor(rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-6, 2),
                                 dtype=torch.float32))
    return policy


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _cast_bf16(tree):
    return {k: _cast_bf16(v) if isinstance(v, dict) else np.asarray(v).astype(jnp.bfloat16)
            for k, v in tree.items()}


def test_port_restores_a_reference_bf16_archive(tmp_path):
    policy = _roach()
    tree = flax_tree_from_roach_state_dict(policy.state_dict())
    path = str(tmp_path / "jax_bf16.msgpack")
    jax_ckpt.archive_params(path, tree, cast_floats=jnp.bfloat16)
    want = jax_ckpt.restore_archive(path, tree)          # float32, the template's
    got = ckpt.restore_archive(path, RoachPolicy.from_config(Config()))
    got_tree = flax_tree_from_roach_state_dict(got)
    n = 0
    for key, v in _leaves(want):
        g = dict(_leaves(got_tree))[key]
        assert g.dtype == np.float32
        np.testing.assert_array_equal(_bits(g), _bits(v), err_msg=str(key))
        n += 1
    assert n == len(policy.state_dict())
    # the cast really rounded: some leaf moved, none beyond bfloat16's step
    moved = [np.max(np.abs(_bits(dict(_leaves(want))[k]).astype(np.int64)
                           - _bits(v).astype(np.int64))) for k, v in _leaves(tree)]
    assert max(moved) > 0 and max(moved) <= 1 << 15


def test_reference_restores_a_port_bf16_archive(tmp_path):
    policy = _roach()
    tree = flax_tree_from_roach_state_dict(policy.state_dict())
    port_path = str(tmp_path / "port_bf16.msgpack")
    jax_path = str(tmp_path / "jax_bf16.msgpack")
    ckpt.archive_params(port_path, policy.state_dict(), cast_floats=torch.bfloat16)
    jax_ckpt.archive_params(jax_path, tree, cast_floats=jnp.bfloat16)
    # flax reads the leaves of the tree cast as the JAX package casts it
    with open(port_path, "rb") as f:
        data = f.read()
    raw = serialization.msgpack_restore(data)
    cast = dict(_leaves(_cast_bf16(tree)))
    for key, v in _leaves(raw):
        assert v.dtype == jnp.bfloat16
        np.testing.assert_array_equal(v.view(np.uint16), cast[key].view(np.uint16))
    assert len(cast) == len(dict(_leaves(raw)))
    restored = jax_ckpt.restore_archive(port_path, tree)
    own = jax_ckpt.restore_archive(jax_path, tree)
    for key, v in _leaves(own):
        np.testing.assert_array_equal(_bits(dict(_leaves(restored))[key]), _bits(v))
    # and the port reads its own archive back to the same values
    back = ckpt.restore_archive(port_path, RoachPolicy.from_config(Config()))
    for key, v in _leaves(flax_tree_from_roach_state_dict(back)):
        np.testing.assert_array_equal(_bits(v), _bits(dict(_leaves(own))[key]))


def test_student_town05_bf16_leaves_match_flax():
    tree = load_flax_msgpack(STUDENT_TOWN05)
    with open(STUDENT_TOWN05, "rb") as f:
        ref = dict(_leaves(serialization.msgpack_restore(f.read())))
    port = dict(_leaves(tree))
    assert set(port) == set(ref)
    bf16 = [k for k, v in ref.items() if v.dtype == jnp.bfloat16]
    assert len(bf16) == 691 == len(ref)
    for key in bf16:
        got = port[key]
        assert got.dtype == np.float32 and got.shape == ref[key].shape
        np.testing.assert_array_equal(_bits(got), _bits(ref[key].astype(np.float32)),
                                      err_msg="/".join(key))
    # a one-sweep student of the older naming: Bottleneck_* blocks, no sweep merge
    enc = tree["params"]["img_encoder"]
    assert "sweep_merge" not in enc
    assert any(k.startswith("Bottleneck_") for k in enc["lss"]["backbone"])


def test_bf16_scalar_and_small_arrays_decode_like_flax():
    values = np.asarray([0.0, -0.0, 1.0, -2.5, 3.0e38, 1.0e-40, np.inf, -np.inf, 0.1],
                        np.float32)
    for tree in ({"a": jnp.asarray(values, jnp.bfloat16)},
                 {"s": jnp.asarray(values[3], jnp.bfloat16)},
                 {"z": np.asarray(jnp.asarray(values[4], jnp.bfloat16))}):
        data = serialization.msgpack_serialize(jax.tree.map(np.asarray, tree))
        got = unpackb(data)
        ref = serialization.msgpack_restore(data)
        for k in tree:
            np.testing.assert_array_equal(_bits(got[k]), _bits(np.asarray(ref[k], np.float32)))
    # the port's encoder writes flax's bytes for a bfloat16 tensor
    t = torch.tensor(values).to(torch.bfloat16)
    assert packb({"a": t}) == serialization.msgpack_serialize(
        {"a": np.asarray(jnp.asarray(values, jnp.bfloat16))})
