"""Sparse 3D convolution over neighbour tables: K6, a hand-written CUDA
kernel, and K7, its rulebooks (both in `csrc/sparse_conv.cu`), with their
plain versions (spconv's SubMConv3d and SparseConv3d as mmdet3d's
SparseEncoder calls them; no counterpart in the JAX package).

A `Level` is a sparse tensor's active sites: coords (cap, 4) int32 (b, z,
y, x), their count `n` on the device, the spatial shape (D, H, W), and on
the card a dense (B, D, H, W) int32 index grid (a site's row, negative or
EMPTY where none). A `Rulebook` is the neighbour table of one output level
over one input level: nbr (cap_out, K) int32, the input row at output o's
offset kk (kz-major, as the weight's (kz, ky, kx)), -1 where that site is
not active, with the counts of its inputs, outputs and active pairs on the
device. Submanifold convolutions at one level share one rulebook, as
spconv's `indice_key` does.

- `subm_rulebook(level)`: the 3 x 3 x 3 table of a level over itself;
- `strided_level(level, kernel, stride, padding)`: the output level of a
  strided convolution (every site some active input reaches, in linear
  order) and its table;
- `sparse_conv(x, rb, weight, bn, residual, relu)`: each output row
  sums its K offsets in order, in float32, then batch norm in eval mode
  (running statistics), the residual, ReLU;
- `to_dense(x, level)`: (B, C, D, H, W) with zeros where no site is active.

On the card every array has a fixed capacity (a strided level: at most
prod(ceil(k / s)) x its input's capacity, and at most its grid's cells),
every count stays on the device and nothing synchronises with the host;
each function launches K7 or K6 on the current stream (one library,
`K6`, whose `launches` counts the convolutions). For tensors on the
CPU the plain versions work on exactly the active sites (cap = n) and keep
no grid. There is no backward: a gradient through K6 raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from thinktwice_tpu_torch.ops.nvcc import CudaKernel, check_tensor, ci, cf, vp

int_p = ctypes.POINTER(ctypes.c_int)
PLAIN_ROWS = 65536      # output rows the plain convolution gathers at once
K6 = CudaKernel("sparse_conv", "sparse_conv.cu", {
    "tt_rulebook_mark": ([vp, vp, ci, int_p, int_p, vp, vp], ci),
    "tt_rulebook_compact": ([vp, vp, int_p, vp, vp, vp], ci),
    "tt_rulebook_table": ([vp, vp, ci, vp, int_p, int_p, vp, vp, vp], ci),
    "tt_sparse_conv": ([vp, ci, vp, ci, vp, ci, vp, ci, vp, vp, vp, vp, cf, vp, ci, vp, vp], ci),
    "tt_sparse_to_dense": ([vp, ci, vp, vp, ci, int_p, vp, vp], ci),
})


@dataclasses.dataclass
class Level:
    coords: torch.Tensor
    n: torch.Tensor
    shape: tuple
    batch: int
    grid: torch.Tensor | None = None


@dataclasses.dataclass
class Rulebook:
    nbr: torch.Tensor
    n_in: torch.Tensor
    n_out: torch.Tensor
    pairs: torch.Tensor
    kernel: tuple


def triple(v) -> tuple:
    """An int or a 3-sequence -> a 3-tuple of ints (z, y, x)."""
    return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) else (int(v),) * 3


def conv_out_shape(shape, kernel, stride, padding) -> tuple:
    k, s, p = triple(kernel), triple(stride), triple(padding)
    return tuple((shape[i] + 2 * p[i] - k[i]) // s[i] + 1 for i in range(3))


def _conv_args(kernel, stride, padding):
    return (ctypes.c_int * 9)(*triple(kernel), *triple(stride), *triple(padding))


def _geo(batch, shape):
    return (ctypes.c_int * 4)(int(batch), *[int(v) for v in shape])


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _offsets(kernel) -> torch.Tensor:
    """(K, 3) int64 (dz, dy, dx), kz-major."""
    kz, ky, kx = kernel
    g = torch.meshgrid(torch.arange(kz), torch.arange(ky), torch.arange(kx), indexing="ij")
    return torch.stack([a.flatten() for a in g], 1)


# --------------------------------------------------------------------------
# plain versions (CPU)


def _keys(coords, shape) -> torch.Tensor:
    D, H, W = shape
    c = coords.to(torch.int64)
    return ((c[:, 0] * D + c[:, 1]) * H + c[:, 2]) * W + c[:, 3]


def _table_plain(out_coords, level: Level, kernel, stride, padding) -> Rulebook:
    k, s, p = triple(kernel), triple(stride), triple(padding)
    keys = _keys(level.coords, level.shape)
    sk, perm = torch.sort(keys)
    off = _offsets(k)                                              # (K, 3)
    q = (out_coords[:, None, 1:].to(torch.int64) * torch.tensor(s)
         - torch.tensor(p) + off[None])                            # (N, K, 3)
    inside = torch.ones(q.shape[:2], dtype=torch.bool)
    for i in range(3):
        inside &= (q[..., i] >= 0) & (q[..., i] < level.shape[i])
    D, H, W = level.shape
    qk = ((out_coords[:, None, 0].to(torch.int64) * D + q[..., 0]) * H + q[..., 1]) * W + q[..., 2]
    pos = torch.searchsorted(sk, qk.clamp_min(0)).clamp_max(max(len(sk) - 1, 0))
    hit = inside & (len(sk) > 0)
    if len(sk):
        hit &= sk[pos] == qk
    nbr = torch.where(hit, perm[pos] if len(sk) else torch.zeros_like(pos),
                      torch.full_like(pos, -1)).to(torch.int32)
    n_out = torch.tensor([out_coords.shape[0]], dtype=torch.int32)
    return Rulebook(nbr, level.n, n_out, hit.sum().reshape(1).to(torch.int64), k)


def _strided_plain(level: Level, kernel, stride, padding):
    k, s, p = triple(kernel), triple(stride), triple(padding)
    out_shape = conv_out_shape(level.shape, k, s, p)
    c = level.coords.to(torch.int64)
    num = c[:, None, 1:] + torch.tensor(p) - _offsets(k)[None]    # o * s for each offset
    ok = (num >= 0).all(-1) & (num % torch.tensor(s) == 0).all(-1)
    o = torch.div(num, torch.tensor(s), rounding_mode="floor")
    ok &= (o < torch.tensor(out_shape)).all(-1)
    b = c[:, None, :1].expand(-1, o.shape[1], 1)
    cand = torch.cat([b, o], -1)[ok]
    uniq = torch.unique(_keys(cand, out_shape))       # sorted: linear order
    D, H, W = out_shape
    coords = torch.stack([uniq // (D * H * W), (uniq // (H * W)) % D, (uniq // W) % H,
                          uniq % W], 1).to(torch.int32)
    out = Level(coords, torch.tensor([len(uniq)], dtype=torch.int32), out_shape, level.batch)
    return out, _table_plain(coords, level, k, s, p)


def sparse_conv_plain(x, rb: Rulebook, weight, bn, residual=None, relu: bool = True):
    """x (n_in, C_in) float32; weight (C_out, C_in, kz, ky, kx); bn (weight,
    bias, running mean, running var, eps) -> (n_out, C_out) float32."""
    cout, cin = weight.shape[:2]
    w = weight.reshape(cout, cin, -1).permute(2, 1, 0)             # (K, C_in, C_out)
    parts = []
    for nbr in torch.split(rb.nbr.to(torch.int64), PLAIN_ROWS):     # bounded gathers
        g = torch.where((nbr >= 0)[..., None], x[nbr.clamp_min(0)],
                        torch.zeros((), dtype=x.dtype))
        parts.append(torch.einsum("nkc,kcd->nd", g, w))
    y = torch.cat(parts) if parts else x.new_zeros((0, cout))
    bw, bb, mean, var, eps = bn
    y = (y - mean) * (bw / torch.sqrt(var + eps)) + bb
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def to_dense_plain(x, level: Level):
    B, C = level.batch, x.shape[1]
    dense = torch.zeros((B, C, *level.shape), dtype=x.dtype)
    c = level.coords.to(torch.int64)
    dense[c[:, 0], :, c[:, 1], c[:, 2], c[:, 3]] = x
    return dense


# --------------------------------------------------------------------------
# K6 and K7 (CUDA)


def _table_cuda(out: Level, level: Level, kernel, stride, padding) -> Rulebook:
    k = triple(kernel)
    K = math.prod(k)
    cap = out.coords.shape[0]
    nbr = torch.empty((cap, K), dtype=torch.int32, device=out.coords.device)
    pairs = torch.zeros((1,), dtype=torch.int64, device=out.coords.device)
    lib = K6.library()
    with torch.cuda.device(out.coords.device):
        rc = lib.tt_rulebook_table(out.coords.data_ptr(), out.n.data_ptr(), cap,
                                   level.grid.data_ptr(), _geo(level.batch, level.shape),
                                   _conv_args(k, stride, padding), nbr.data_ptr(),
                                   pairs.data_ptr(), _stream(nbr))
    K6.check(rc)
    return Rulebook(nbr, level.n, out.n, pairs, k)


def _strided_cuda(level: Level, kernel, stride, padding):
    k, s = triple(kernel), triple(stride)
    out_shape = conv_out_shape(level.shape, k, s, padding)
    dev = level.coords.device
    cells = level.batch * math.prod(out_shape)
    reach = math.prod(-(-k[i] // s[i]) for i in range(3))
    cap = min(reach * level.coords.shape[0], cells)
    grid = torch.zeros((level.batch, *out_shape), dtype=torch.int32, device=dev)
    coords = torch.empty((cap, 4), dtype=torch.int32, device=dev)
    n = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = K6.library()
    geo = _geo(level.batch, out_shape)
    with torch.cuda.device(dev):
        rc = lib.tt_rulebook_mark(level.coords.data_ptr(), level.n.data_ptr(),
                                  level.coords.shape[0], geo, _conv_args(k, s, padding),
                                  grid.data_ptr(), _stream(grid))
        K6.check(rc)
        scan = torch.cumsum(grid.view(-1), 0, dtype=torch.int32)
        rc = lib.tt_rulebook_compact(grid.data_ptr(), scan.data_ptr(), geo, coords.data_ptr(),
                                     n.data_ptr(), _stream(grid))
    K6.check(rc)
    out = Level(coords, n, out_shape, level.batch, grid)
    return out, _table_cuda(out, level, k, s, padding)


class _NoBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, *inputs):
        return y.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("K6 (the sparse convolution on the card) has no backward: the "
                           "sparse LiDAR encoder runs forward only on CUDA")


def _sparse_conv_cuda(x, rb: Rulebook, weight, bn, residual=None, relu: bool = True):
    cout, cin = int(weight.shape[0]), int(weight.shape[1])
    K = rb.nbr.shape[1]
    cap = rb.nbr.shape[0]
    if tuple(weight.shape[2:]) != rb.kernel:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit the rulebook's kernel "
                         f"{rb.kernel}")
    check_tensor(x, "x", torch.float32, (x.shape[0], cin))
    w = weight.detach().reshape(cout, cin, K).permute(2, 1, 0).contiguous()
    bw, bb, mean, var, eps = (t.detach() if torch.is_tensor(t) else t for t in bn)
    for name, t in (("bn weight", bw), ("bn bias", bb), ("bn mean", mean), ("bn var", var)):
        check_tensor(t, name, torch.float32, (cout,))
    if residual is not None:
        check_tensor(residual, "residual", torch.float32, (cap, cout))
    y = torch.empty((cap, cout), dtype=torch.float32, device=x.device)
    lib = K6.library()
    with torch.cuda.device(x.device):
        rc = lib.tt_sparse_conv(x.data_ptr(), cin, rb.nbr.data_ptr(), K, rb.n_out.data_ptr(),
                                cap, w.data_ptr(), cout, bw.data_ptr(), bb.data_ptr(),
                                mean.data_ptr(), var.data_ptr(), float(eps),
                                None if residual is None else residual.data_ptr(), int(relu),
                                y.data_ptr(), _stream(y))
    K6.check(rc)
    K6.launches += 1
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _NoBackward.apply(y, x, weight)
    return y


def _to_dense_cuda(x, level: Level):
    C = x.shape[1]
    dense = torch.zeros((level.batch, C, *level.shape), dtype=torch.float32, device=x.device)
    lib = K6.library()
    with torch.cuda.device(x.device):
        rc = lib.tt_sparse_to_dense(x.data_ptr(), C, level.coords.data_ptr(), level.n.data_ptr(),
                                    level.coords.shape[0], _geo(level.batch, level.shape),
                                    dense.data_ptr(), _stream(dense))
    K6.check(rc)
    return dense


# --------------------------------------------------------------------------
# dispatch: the kernels for tensors on the card, the plain versions on the CPU


def subm_rulebook(level: Level, kernel=3) -> Rulebook:
    """The submanifold table of a level over itself (stride 1, padding
    kernel // 2)."""
    k = triple(kernel)
    pad = tuple(v // 2 for v in k)
    if level.coords.device.type == "cpu":
        return _table_plain(level.coords, level, k, 1, pad)
    return _table_cuda(level, level, k, 1, pad)


def strided_level(level: Level, kernel, stride, padding):
    """-> (the output level of a strided convolution, its rulebook)."""
    if level.coords.device.type == "cpu":
        return _strided_plain(level, kernel, stride, padding)
    return _strided_cuda(level, kernel, stride, padding)


def sparse_conv(x, rb: Rulebook, weight, bn, residual=None, relu: bool = True):
    """One sparse convolution with its batch norm, residual and ReLU: K6 on
    the card, the plain version on the CPU. x (rows, C_in) float32; weight
    (C_out, C_in, kz, ky, kx); bn (weight, bias, running mean, running var,
    eps) -> (rows of rb's outputs, C_out) float32."""
    if x.device.type == "cpu":
        return sparse_conv_plain(x, rb, weight, bn, residual, relu)
    return _sparse_conv_cuda(x, rb, weight, bn, residual, relu)


def to_dense(x, level: Level):
    """(rows, C) -> (B, C, D, H, W) float32, zeros where no site is active."""
    if x.device.type == "cpu":
        return to_dense_plain(x, level)
    return _to_dense_cuda(x, level)
