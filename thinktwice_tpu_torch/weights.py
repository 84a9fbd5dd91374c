"""Weights carried across from the JAX package's archives.

`load_flax_msgpack` reads a flax msgpack archive (the `runs/*/params.msgpack`
files, written by `flax.serialization.to_bytes`) into nested dicts of numpy
arrays with a small msgpack decoder of its own: pure Python and `struct`,
no msgpack package. It covers maps, arrays, str, bin, int, float, nil and
bool, and flax's extension types 1 (an ndarray as a msgpack triple
(shape, dtype name, bytes)) and 3 (a numpy scalar). `packb` is the encoder
beside it, with msgpack's choice of the smallest form of each value, so a
tree of numpy arrays encodes to the bytes flax writes for it. numpy has no
bfloat16: a bfloat16 leaf is read as float32 (its 16 bits are the upper
half of one, so the value is exact), and a torch bfloat16 tensor is written
under flax's dtype name "bfloat16".

`roach_state_dict_from_flax` maps the flax Roach param tree onto
`agents.roach.RoachPolicy`'s state_dict: conv kernels HWIO -> OIHW, Dense
kernels (in, out) -> Linear weights (out, in);
`flax_tree_from_roach_state_dict` is its inverse.

`student_state_dict_from_flax` maps the flax ThinkTwiceModel tree onto
`models.encoder_decoder.ThinkTwiceModel`, whose submodules carry the flax
names: path for path, conv kernels HWIO -> OIHW, Dense kernels transposed,
GroupNorm and LayerNorm `scale` -> `weight`; the backbone's rematerialized
blocks `Checkpoint<Block>_k` go to `blocks.k` by their numeric suffix.
`flax_tree_from_student_state_dict` is its inverse.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch

from thinktwice_tpu_torch import resolve_device
from thinktwice_tpu_torch.agents.roach import RoachPolicy
from thinktwice_tpu_torch.models.encoder_decoder import ThinkTwiceModel

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


def _head(out: bytearray, n: int, small: int | None, small_max: int, codes) -> None:
    """A length header: the fix form (small | n) when n <= small_max, else
    the first of codes (8-, 16-, 32-bit) whose width holds n."""
    if small is not None and n <= small_max:
        out += struct.pack(">B", small | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out += struct.pack(">B", code) + struct.pack(fmt, n)
            return
    raise ValueError("msgpack object too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2 ** 64 - 1)) if v >= 0 else (
        (0xD0, ">b", -2 ** 7, 0), (0xD1, ">h", -2 ** 15, 0), (0xD2, ">i", -2 ** 31, 0),
        (0xD3, ">q", -2 ** 63, 0))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out += struct.pack(">B", code) + struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} out of msgpack's range")


def _ext_bytes(code: int, data: bytes, out: bytearray) -> None:
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fix:
        out += struct.pack(">B", fix[len(data)])
    else:
        _head(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _encode(obj, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif isinstance(obj, (bool, np.bool_)):
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, np.ndarray):
        _ext_bytes(_EXT_NDARRAY, packb((obj.shape, obj.dtype.name, obj.tobytes("C"))), out)
    elif isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16:
        bits = obj.detach().cpu().contiguous().view(torch.int16).numpy().astype("<i2")
        _ext_bytes(_EXT_NDARRAY, packb((tuple(obj.shape), "bfloat16", bits.tobytes())), out)
    elif isinstance(obj, np.generic):
        _ext_bytes(_EXT_NPSCALAR,
                   packb(((), np.asarray(obj).dtype.name, np.asarray(obj).tobytes())), out)
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode one object: dicts, lists and tuples of None, bool, int,
    float, str, bytes, numpy arrays, numpy scalars and torch bfloat16
    tensors (flax's extension types; a bfloat16 tensor is written as the
    array of dtype name "bfloat16" that flax writes for ml_dtypes')."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


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


def flax_tree_from_roach_state_dict(state_dict: dict) -> dict:
    """RoachPolicy state_dict tensors -> the flax param tree {"params": ...}
    of numpy float32 arrays (inverse of roach_state_dict_from_flax)."""

    def layers(prefix):
        return sorted({int(k[len(prefix):].split(".")[0]) for k in state_dict
                       if k.startswith(prefix)})

    def arr(key):
        return state_dict[key].detach().cpu().to(torch.float32).numpy()

    def conv(m):
        return {"kernel": np.ascontiguousarray(np.transpose(arr(m + ".weight"), (2, 3, 1, 0))),
                "bias": np.ascontiguousarray(arr(m + ".bias"))}

    def dense(m):
        return {"kernel": np.ascontiguousarray(arr(m + ".weight").T),
                "bias": np.ascontiguousarray(arr(m + ".bias"))}

    fe = {f"Conv_{i}": conv(f"features_extractor.convs.{i}")
          for i in layers("features_extractor.convs.")}
    states = layers("features_extractor.states.")
    for i in states:
        fe[f"Dense_{i}"] = dense(f"features_extractor.states.{i}")
    fe[f"Dense_{len(states)}"] = dense("features_extractor.linear0")
    fe[f"Dense_{len(states) + 1}"] = dense("features_extractor.linear1")
    top = {"features_extractor": fe}
    policy = layers("policy_head.")
    for i in policy:
        top[f"Dense_{i}"] = dense(f"policy_head.{i}")
    for i in layers("value_head."):
        top[f"Dense_{len(policy) + i}"] = dense(f"value_head.{i}")
    for name in ("dist_alpha", "dist_beta", "value_out"):
        top[name] = dense(name)
    return {"params": top}


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


_REMAT_BLOCK = re.compile(r"^Checkpoint\w+_(\d+)$")


def _flat_leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _student_leaf(path, value):
    """A flax leaf -> (torch state_dict key, array)."""
    mods = [f"blocks.{_REMAT_BLOCK.match(p).group(1)}" if _REMAT_BLOCK.match(p) else p
            for p in path[:-1]]
    leaf = path[-1]
    a = np.asarray(value, np.float32)
    if leaf == "kernel":
        leaf = "weight"
        a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(mods + [leaf]), a


def student_state_dict_from_flax(tree: dict, model: ThinkTwiceModel) -> dict:
    """Flax ThinkTwiceModel params -> model.state_dict() tensors. Raises if a
    flax leaf has no parameter of the model, a parameter gets no leaf, or a
    shape differs."""
    p = tree.get("params", tree)
    want = {k: v.shape for k, v in model.state_dict().items()}
    out = {}
    for path, value in _flat_leaves(p):
        key, a = _student_leaf(path, value)
        if key not in want:
            raise KeyError(f"flax leaf {'/'.join(path)} has no parameter {key}")
        if tuple(a.shape) != tuple(want[key]):
            raise ValueError(f"{key}: flax {a.shape} vs port {tuple(want[key])}")
        out[key] = torch.tensor(a)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} port parameters have no flax leaf: {missing[:8]}")
    return out


def flax_tree_from_student_state_dict(state_dict: dict) -> dict:
    """ThinkTwiceModel state_dict tensors -> the flax param tree {"params":
    ...} of numpy float32 arrays (inverse of student_state_dict_from_flax).
    The backbone's blocks take the flax name of their type, read from the
    first block's first conv: a 1x1 conv opens a Bottleneck, a 3x3 one a
    BasicBlock."""
    first = [v for k, v in state_dict.items() if k.endswith("blocks.0.ConvGN_0.Conv_0.weight")]
    block = "Bottleneck" if first and first[0].shape[-1] == 1 else "BasicBlock"
    tree: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "blocks":
                path.append(f"Checkpoint{block}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        leaf = parts[-1]
        a = value.detach().cpu().to(torch.float32).numpy()
        if leaf == "weight":
            if a.ndim == 4:
                leaf, a = "kernel", np.transpose(a, (2, 3, 1, 0))
            elif a.ndim == 2:
                leaf, a = "kernel", a.T
            else:
                leaf = "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def student_arch(tree: dict) -> tuple[int, int]:
    """(backbone depth, n_sweeps) of a flax student tree: the backbone's
    block type and count, and the width of the sweep-merge conv."""
    p = tree.get("params", tree)
    enc = p["img_encoder"]
    blocks = [k for k in enc["lss"]["backbone"] if _REMAT_BLOCK.match(k)]
    bottleneck = any("Bottleneck" in k for k in blocks)
    depth = {(True, 16): 50, (False, 4): 10, (False, 8): 18, (False, 16): 34}[
        (bottleneck, len(blocks))]
    merge = enc.get("sweep_merge")
    n_sweeps = 1 if merge is None else merge["kernel"].shape[2] // merge["kernel"].shape[3]
    return depth, n_sweeps


def load_student_model(path: str, cfg, device="cuda"):
    """A ThinkTwiceModel with the weights of a flax student archive (backbone
    depth and sweep count read from the archive), in eval mode on `device`.
    cfg is the full Config (model widths and camera count)."""
    device = resolve_device(device)
    tree = load_flax_msgpack(path)
    depth, n_sweeps = student_arch(tree)
    model = ThinkTwiceModel(cfg.model, backbone_depth=depth, n_sweeps=n_sweeps,
                            n_cams=cfg.camera.n_cams)
    model.load_state_dict(student_state_dict_from_flax(tree, model), strict=True)
    return model.to(device).eval()
