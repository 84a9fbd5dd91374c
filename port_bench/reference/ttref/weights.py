"""Weights carried across from the JAX package's archives.

`load_flax_msgpack` reads a flax msgpack archive (the `runs/*/params.msgpack`
files, written by `flax.serialization.to_bytes`) into nested dicts of numpy
arrays with a small msgpack decoder of its own: pure Python and `struct`,
no msgpack package. It covers maps, arrays, str, bin, int, float, nil and
bool, and flax's extension types 1 (an ndarray as a msgpack triple
(shape, dtype name, bytes)) and 3 (a numpy scalar). numpy has no
bfloat16: a bfloat16 leaf is read as float32 (its 16 bits are the upper
half of one, so the value is exact).

`roach_state_dict_from_flax` maps the flax Roach param tree onto
`agents.roach.RoachPolicy`'s state_dict: conv kernels HWIO -> OIHW, Dense
kernels (in, out) -> Linear weights (out, in).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from port_bench.reference.ttref import resolve_device
from port_bench.reference.ttref.agents.roach import RoachPolicy

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    simple = {
        0xC0: lambda: None,
        0xC2: lambda: False,
        0xC3: lambda: True,
        0xC4: lambda: bytes(r.take(r.unpack(">B"))),
        0xC5: lambda: bytes(r.take(r.unpack(">H"))),
        0xC6: lambda: bytes(r.take(r.unpack(">I"))),
        0xC7: lambda: _ext(r, r.unpack(">B")),
        0xC8: lambda: _ext(r, r.unpack(">H")),
        0xC9: lambda: _ext(r, r.unpack(">I")),
        0xCA: lambda: r.unpack(">f"),
        0xCB: lambda: r.unpack(">d"),
        0xCC: lambda: r.unpack(">B"),
        0xCD: lambda: r.unpack(">H"),
        0xCE: lambda: r.unpack(">I"),
        0xCF: lambda: r.unpack(">Q"),
        0xD0: lambda: r.unpack(">b"),
        0xD1: lambda: r.unpack(">h"),
        0xD2: lambda: r.unpack(">i"),
        0xD3: lambda: r.unpack(">q"),
        0xD4: lambda: _ext(r, 1),
        0xD5: lambda: _ext(r, 2),
        0xD6: lambda: _ext(r, 4),
        0xD7: lambda: _ext(r, 8),
        0xD8: lambda: _ext(r, 16),
        0xD9: lambda: str(r.take(r.unpack(">B")), "utf-8"),
        0xDA: lambda: str(r.take(r.unpack(">H")), "utf-8"),
        0xDB: lambda: str(r.take(r.unpack(">I")), "utf-8"),
        0xDC: lambda: [_decode(r) for _ in range(r.unpack(">H"))],
        0xDD: lambda: [_decode(r) for _ in range(r.unpack(">I"))],
        0xDE: lambda: _map(r, r.unpack(">H")),
        0xDF: lambda: _map(r, r.unpack(">I")),
    }
    if b not in simple:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    return simple[b]()


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data)
    if dtype_name == "bfloat16":
        # numpy has no bfloat16: its 16 bits are the upper half of a
        # float32, so the leaf widens to float32 exactly
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(r: _Reader, n: int):
    code = r.unpack(">b")
    data = bytes(r.take(n))
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def unpackb(data: bytes):
    """Decode one msgpack object."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def load_flax_msgpack(path: str) -> dict:
    """A flax msgpack archive -> nested dicts of numpy arrays (the tree that
    flax.serialization.msgpack_restore gives)."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def _conv(p):
    return {
        "weight": np.ascontiguousarray(np.transpose(p["kernel"], (3, 2, 0, 1))),
        "bias": p["bias"],
    }


def _dense(p):
    return {"weight": np.ascontiguousarray(p["kernel"].T), "bias": p["bias"]}


def roach_state_dict_from_flax(tree: dict, n_states: int = 1,
                               n_policy: int = 2, n_value: int = 2,
                               n_convs: int = 6) -> dict:
    """Flax RoachPolicy params -> RoachPolicy.state_dict() tensors. The
    flax names Dense_k in creation order: inside the trunk the state MLP,
    then the two feature Linears; at the top the policy head, then the
    value head."""
    p = tree.get("params", tree)
    fe = p["features_extractor"]
    mods = {}
    for i in range(n_convs):
        mods[f"features_extractor.convs.{i}"] = _conv(fe[f"Conv_{i}"])
    for i in range(n_states):
        mods[f"features_extractor.states.{i}"] = _dense(fe[f"Dense_{i}"])
    mods["features_extractor.linear0"] = _dense(fe[f"Dense_{n_states}"])
    mods["features_extractor.linear1"] = _dense(fe[f"Dense_{n_states + 1}"])
    for i in range(n_policy):
        mods[f"policy_head.{i}"] = _dense(p[f"Dense_{i}"])
    for i in range(n_value):
        mods[f"value_head.{i}"] = _dense(p[f"Dense_{n_policy + i}"])
    for name in ("dist_alpha", "dist_beta", "value_out"):
        mods[name] = _dense(p[name])
    return {
        f"{m}.{k}": torch.from_numpy(np.array(v, np.float32))
        for m, d in mods.items() for k, v in d.items()
    }


def load_roach_policy(path: str, cfg, device="cuda"):
    """A RoachPolicy with the weights of a flax archive, in eval mode on
    `device`."""
    device = resolve_device(device)
    policy = RoachPolicy.from_config(cfg)
    sd = roach_state_dict_from_flax(
        load_flax_msgpack(path),
        n_states=len(cfg.roach.states_neurons),
        n_policy=len(cfg.roach.policy_head),
        n_value=len(cfg.roach.value_head),
    )
    policy.load_state_dict(sd, strict=True)
    return policy.to(device).eval()

