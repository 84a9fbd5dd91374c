"""Bilinear grid sampling with zero padding, as gathers (counterpart of
`thinktwice_tpu/ops/grid_sample.py`); channels last, as there.

`sample_levels` samples every camera's FPN levels at the look module's
points: K4, a hand-written CUDA kernel (`csrc/look_sample.cu`), for tensors
on the card, with its backward a kernel too (`torch.autograd.Function`), and
its plain version, `grid_sample_norm` a level, for tensors on the CPU; there
is no fallback from one to the other. K4 does the plain version's float
operations in the same order. The CUDA source is compiled with nvcc for
sm_90a at first use (`ops/nvcc.py`) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from thinktwice_tpu_torch.ops.nvcc import DTYPE_CODES, CudaKernel, check_tensor, ci, vp

MAX_LEVELS = 8          # the kernel's level table
ll_p, int_p = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
vp_p = ctypes.POINTER(ctypes.c_void_p)

K4 = CudaKernel("look_sample", "look_sample.cu", {
    "tt_look_sample_fwd": ([ci, vp_p, ll_p, int_p, ci, vp, vp, ci, ci, ci, ci, vp], ci),
    "tt_look_sample_bwd": ([vp_p, int_p, ci, vp, vp, ci, ci, ci, ci, vp], ci),
})


def grid_sample_2d(img, coords):
    """img (B, H, W, C); coords (B, ..., 2) pixel units (x, y) -> (B, ..., C).
    Taps outside the image read zero. The taps keep img's dtype; the
    weighted sum is float32 (as the JAX package's promotion gives)."""
    B, H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    flat = img.reshape(B, H * W, C)
    lead = x.shape[1:]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)).reshape(B, -1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C)).reshape(B, *lead, C)
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    return (tap(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
            + tap(x0 + 1, y0) * (fx * (1 - fy))[..., None]
            + tap(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
            + tap(x0 + 1, y0 + 1) * (fx * fy)[..., None])


def grid_sample_norm(img, coords_norm):
    """coords in the [-1, 1] convention (align_corners=False)."""
    H, W = img.shape[1], img.shape[2]
    x = (coords_norm[..., 0] + 1.0) * 0.5 * W - 0.5
    y = (coords_norm[..., 1] + 1.0) * 0.5 * H - 0.5
    return grid_sample_2d(img, torch.stack([x, y], dim=-1))


def sample_levels_plain(maps, coords):
    """The plain version of K4: maps, L levels (B, N, H_l, W_l, C); coords
    (B, N, Q, 2) float32 in [0, 1] of the image -> (B, N, Q, L * C) float32,
    level l in channels [l * C, (l + 1) * C): `grid_sample_norm` of each
    level with every camera as one batch of B * N."""
    B, N, Q, _ = coords.shape
    g = (coords * 2.0 - 1.0).reshape(B * N, Q, 2)
    return torch.cat([grid_sample_norm(m.reshape(B * N, *m.shape[2:]), g) for m in maps],
                     dim=-1).reshape(B, N, Q, -1)


def _check(maps, coords):
    """Raise unless K4 takes these. -> (B, N, Q, C)."""
    if not 0 < len(maps) <= MAX_LEVELS:
        raise ValueError(f"K4 takes 1 to {MAX_LEVELS} levels, got {len(maps)}")
    if coords.dim() != 4:
        raise ValueError(f"coords must be (B, N, Q, 2), got {tuple(coords.shape)}")
    B, N, Q = coords.shape[:3]
    check_tensor(coords, "coords", torch.float32, (B, N, Q, 2))
    if coords.requires_grad:
        raise ValueError("K4 gives no gradient for coords: detach them")
    dtype, C = maps[0].dtype, maps[0].shape[-1]
    for lvl, m in enumerate(maps):
        if m.device != coords.device:
            raise ValueError(f"maps[{lvl}] must lie on {coords.device}, got {m.device}")
        if m.dtype not in DTYPE_CODES or m.dtype != dtype:
            raise ValueError(f"maps must be all float32 or all bfloat16, got {m.dtype} "
                             f"at level {lvl}")
        if m.dim() != 5 or (m.shape[0], m.shape[1], m.shape[4]) != (B, N, C) or 0 in m.shape:
            raise ValueError(f"maps[{lvl}] must have shape ({B}, {N}, H, W, {C}), got "
                             f"{tuple(m.shape)}")
        if m.stride(-1) != 1:
            raise ValueError(f"maps[{lvl}]'s channels must be contiguous")
    return B, N, Q, C


def _level_hw(shapes):
    return (ctypes.c_int * (2 * len(shapes)))(*[int(v) for s in shapes for v in s[2:4]])


class _LookSampleK4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coords, dims, *maps):
        B, N, Q, C = dims
        L = len(maps)
        lib = K4.library()
        out = torch.empty((B, N, Q, L * C), dtype=torch.float32, device=coords.device)
        ptrs = (ctypes.c_void_p * L)(*[m.data_ptr() for m in maps])
        strides = (ctypes.c_longlong * (4 * L))(*[s for m in maps for s in m.stride()[:4]])
        with torch.cuda.device(coords.device):
            stream = torch.cuda.current_stream(coords.device).cuda_stream
            rc = lib.tt_look_sample_fwd(DTYPE_CODES[maps[0].dtype], ptrs, strides,
                                        _level_hw([m.shape for m in maps]), L,
                                        coords.data_ptr(), out.data_ptr(), B, N, Q, C, stream)
        K4.check(rc)
        K4.launches += 1
        ctx.save_for_backward(coords)
        ctx.dims, ctx.shapes, ctx.dtype = dims, [tuple(m.shape) for m in maps], maps[0].dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (coords,) = ctx.saved_tensors
        B, N, Q, C = ctx.dims
        L = len(ctx.shapes)
        grads = [torch.zeros(s, dtype=torch.float32, device=coords.device) for s in ctx.shapes]
        grad_out = grad_out.float().contiguous()
        lib = K4.library()
        ptrs = (ctypes.c_void_p * L)(*[g.data_ptr() for g in grads])
        with torch.cuda.device(coords.device):
            stream = torch.cuda.current_stream(coords.device).cuda_stream
            rc = lib.tt_look_sample_bwd(ptrs, _level_hw(ctx.shapes), L, coords.data_ptr(),
                                        grad_out.data_ptr(), B, N, Q, C, stream)
        K4.check(rc)
        K4.launches += 1
        return (None, None, *[g.to(ctx.dtype) if need else None
                              for g, need in zip(grads, ctx.needs_input_grad[2:])])


def sample_levels_cuda(maps, coords):
    """Launch K4 on the current stream -> (B, N, Q, L * C) float32; its
    backward (grad maps in float32 atomics) is one more launch. Arguments as
    `sample_levels_plain`; each map in any layout with contiguous channels,
    all of one dtype (float32 or bfloat16); coords contiguous and carrying
    no gradient."""
    maps = tuple(maps)
    dims = _check(maps, coords)
    return _LookSampleK4.apply(coords, dims, *maps)


def sample_levels(maps, coords):
    """Every camera's FPN levels sampled at its points: K4 for tensors on
    the card, its plain version for tensors on the CPU. Arguments as
    `sample_levels_plain`."""
    if coords.device.type == "cpu":
        return sample_levels_plain(maps, coords)
    return sample_levels_cuda(maps, coords)
