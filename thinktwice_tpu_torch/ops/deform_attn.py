"""Multi-scale deformable attention: K3, a hand-written CUDA kernel
(`csrc/deform_attn.cu`), and its plain version as gathers and bilinear
interpolation (counterpart of `thinktwice_tpu/ops/deform_attn.py`).

`value` is channel-fused (B, sum HW, C): head h samples at its own
locations and keeps its own channel block [h*C/H, (h+1)*C/H). The JAX
package gathers all C channels for every head and keeps each head's block
with a one-hot mixing product; here each head gathers its own block only
(an eighth of the gathered bytes at 8 heads), which gives the same numbers:
the product adds exact zeros to each kept channel. The plain interpolation
runs in value's dtype (bfloat16 in the model).

`deform_attn_cams` takes every camera at once: the sampling locations are
the reference points plus the raw offsets over each level's (W, H), in
float32. It runs K3 for tensors on the card, with its backward a kernel too
(`torch.autograd.Function`), and the plain version for tensors on the CPU;
there is no fallback from one to the other. K3 keeps the corner weights and
every sum in float32 and rounds the output once, where the plain version
rounds each step to value's dtype. The CUDA source is compiled with nvcc for
sm_90a at first use (`ops/nvcc.py`) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from thinktwice_tpu_torch.ops.nvcc import DTYPE_CODES, CudaKernel, check_tensor, ci, vp

MAX_LEVELS = 8          # the kernel's level table
ll, int_p = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)

K3 = CudaKernel("deform_attn", "deform_attn.cu", {
    "tt_deform_attn_fwd": ([ci, vp, ll, ll, ll, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                            int_p, vp], ci),
    "tt_deform_attn_bwd": ([ci, vp, ll, ll, ll, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                            ci, ci, ci, int_p, vp], ci),
})


def ms_deform_attn(value, spatial_shapes: Sequence[tuple[int, int]],
                   sampling_locations, attention_weights):
    """value (B, sum_l H_l*W_l, C); sampling_locations (B, Q, heads, levels,
    points, 2) in [0, 1]; attention_weights (B, Q, heads, levels, points)
    -> (B, Q, C)."""
    B, _, C = value.shape
    Q, n_heads, n_points = (sampling_locations.shape[1], sampling_locations.shape[2],
                            sampling_locations.shape[4])
    head_dim = C // n_heads

    # the heads lead: (B, heads, Q * points, head_dim) stays contiguous
    out = torch.zeros((B, n_heads, Q, head_dim), dtype=value.dtype, device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = (value[:, start:start + H * W].reshape(B, H * W, n_heads, head_dim)
             .transpose(1, 2).contiguous())                        # (B, h, HW, d)
        start += H * W
        loc = sampling_locations[:, :, :, lvl].transpose(1, 2)     # (B, h, Q, P, 2)
        x = (loc[..., 0] * W - 0.5).reshape(B, n_heads, Q * n_points)
        y = (loc[..., 1] * H - 0.5).reshape(B, n_heads, Q * n_points)
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        fx = (x - x0).to(value.dtype)
        fy = (y - y0).to(value.dtype)

        def tap(xi, yi, v=v, H=H, W=W):
            inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)   # (B, h, QP)
            g = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, head_dim))
            return torch.where(inb[..., None], g, torch.zeros_like(g))

        sampled = (tap(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
                   + tap(x0 + 1, y0) * (fx * (1 - fy))[..., None]
                   + tap(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
                   + tap(x0 + 1, y0 + 1) * (fx * fy)[..., None])   # (B, h, QP, d)
        w = attention_weights[:, :, :, lvl].transpose(1, 2).reshape(B, n_heads, -1, 1)
        out = out + torch.sum((sampled * w).reshape(B, n_heads, Q, n_points, head_dim), dim=3)
    return out.transpose(1, 2).reshape(B, Q, C)


def sampling_locations(spatial_shapes, ref_points, offsets):
    """ref_points (..., 2) in [0, 1]; offsets (..., heads, levels, points, 2)
    in pixels of each level -> float32 locations ref + offset / (W_l, H_l)."""
    norm = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                        device=ref_points.device)
    return ref_points[..., None, None, None, :].float() + offsets.float() / norm[:, None, :]


def deform_attn_cams_plain(value_cams, spatial_shapes, ref_points, offsets, weights):
    """The plain version of K3: every camera's deformable attention as one
    batch of B * N. value_cams (N, B, sum HW, C); ref_points (B, N, Q, 2) in
    [0, 1]; offsets (B, N, Q, heads, levels, points, 2) raw; weights (B, N, Q,
    heads, levels, points) softmaxed -> (B, N, Q, C) in value's dtype."""
    N, B, S, C = value_cams.shape
    Q = ref_points.shape[2]
    locs = sampling_locations(spatial_shapes, ref_points, offsets)
    out = ms_deform_attn(value_cams.transpose(0, 1).reshape(B * N, S, C), spatial_shapes,
                         locs.reshape(B * N, Q, *locs.shape[3:]),
                         weights.reshape(B * N, Q, *weights.shape[3:]))
    return out.reshape(B, N, Q, C)


def _check(value_cams, spatial_shapes, ref_points, offsets, weights):
    """Raise unless K3 takes these. -> (N, B, Q, heads, D, L, P)."""
    if value_cams.dim() != 4:
        raise ValueError(f"value_cams must be (N, B, S, C), got {tuple(value_cams.shape)}")
    N, B, S, C = value_cams.shape
    if value_cams.device.type != "cuda":
        raise ValueError(f"value_cams must lie on the CUDA device, got {value_cams.device}")
    if value_cams.dtype not in DTYPE_CODES:
        raise ValueError(f"value_cams must be float32 or bfloat16, got {value_cams.dtype}")
    if value_cams.stride(-1) != 1:
        raise ValueError("value_cams' channels must be contiguous")
    L = len(spatial_shapes)
    if not 0 < L <= MAX_LEVELS:
        raise ValueError(f"K3 takes 1 to {MAX_LEVELS} levels, got {L}")
    if S != sum(int(h) * int(w) for h, w in spatial_shapes):
        raise ValueError(f"value_cams has {S} rows, the levels {tuple(spatial_shapes)} "
                         f"{sum(int(h) * int(w) for h, w in spatial_shapes)}")
    if offsets.dim() != 7:
        raise ValueError(f"offsets must be (B, N, Q, heads, levels, points, 2), got "
                         f"{tuple(offsets.shape)}")
    Q, H, P = offsets.shape[2], offsets.shape[3], offsets.shape[5]
    if H == 0 or C % H:
        raise ValueError(f"{C} channels do not split into {H} heads")
    check_tensor(ref_points, "ref_points", torch.float32, (B, N, Q, 2))
    check_tensor(offsets, "offsets", value_cams.dtype, (B, N, Q, H, L, P, 2))
    check_tensor(weights, "weights", value_cams.dtype, (B, N, Q, H, L, P))
    if not value_cams.device == ref_points.device == offsets.device == weights.device:
        raise ValueError("value_cams, ref_points, offsets and weights must lie on one device")
    if ref_points.requires_grad:
        raise ValueError("K3 gives no gradient for ref_points: detach them")
    return N, B, Q, H, C // H, L, P


def _levels(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[int(v) for hw in spatial_shapes for v in hw])


def _strides(value_cams):
    return value_cams.stride(0), value_cams.stride(1), value_cams.stride(2)


class _DeformAttnK3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value_cams, ref_points, offsets, weights, spatial_shapes, dims):
        N, B, Q, H, D, L, P = dims
        lib = K3.library()
        out = torch.empty((B, N, Q, H * D), dtype=value_cams.dtype, device=value_cams.device)
        with torch.cuda.device(value_cams.device):
            stream = torch.cuda.current_stream(value_cams.device).cuda_stream
            rc = lib.tt_deform_attn_fwd(
                DTYPE_CODES[value_cams.dtype], value_cams.data_ptr(), *_strides(value_cams),
                ref_points.data_ptr(), offsets.data_ptr(), weights.data_ptr(), out.data_ptr(),
                B, N, Q, H, D, L, P, _levels(spatial_shapes), stream)
        K3.check(rc)
        K3.launches += 1
        ctx.save_for_backward(value_cams, ref_points, offsets, weights)
        ctx.spatial_shapes, ctx.dims = spatial_shapes, dims
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value_cams, ref_points, offsets, weights = ctx.saved_tensors
        N, B, Q, H, D, L, P = ctx.dims
        grad_out = grad_out.to(value_cams.dtype).contiguous()
        dev = value_cams.device
        grad_value = (torch.zeros((N, B, value_cams.shape[2], H * D), dtype=torch.float32,
                                  device=dev) if ctx.needs_input_grad[0] else None)
        grad_off = torch.empty_like(offsets)
        grad_w = torch.empty_like(weights)
        lib = K3.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tt_deform_attn_bwd(
                DTYPE_CODES[value_cams.dtype], value_cams.data_ptr(), *_strides(value_cams),
                ref_points.data_ptr(), offsets.data_ptr(), weights.data_ptr(),
                grad_out.data_ptr(), None if grad_value is None else grad_value.data_ptr(),
                grad_off.data_ptr(), grad_w.data_ptr(), B, N, Q, H, D, L, P,
                _levels(ctx.spatial_shapes), stream)
        K3.check(rc)
        K3.launches += 1
        if grad_value is not None:
            grad_value = grad_value.to(value_cams.dtype)
        return grad_value, None, grad_off, grad_w, None, None


def deform_attn_cams_cuda(value_cams, spatial_shapes, ref_points, offsets, weights):
    """Launch K3 on the current stream -> (B, N, Q, C) in value's dtype; its
    backward (grad value in float32 atomics, grad offsets and grad weights)
    is one more launch. Arguments as `deform_attn_cams_plain`; value_cams in
    any layout with contiguous channels, the rest contiguous; ref_points
    float32 and carrying no gradient, offsets and weights in value's dtype."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    dims = _check(value_cams, shapes, ref_points, offsets, weights)
    return _DeformAttnK3.apply(value_cams, ref_points, offsets, weights, shapes, dims)


def deform_attn_cams(value_cams, spatial_shapes, ref_points, offsets, weights):
    """Deformable attention of every camera: K3 for tensors on the card, its
    plain version for tensors on the CPU. Arguments as
    `deform_attn_cams_plain`."""
    if value_cams.device.type == "cpu":
        return deform_attn_cams_plain(value_cams, spatial_shapes, ref_points, offsets, weights)
    return deform_attn_cams_cuda(value_cams, spatial_shapes, ref_points, offsets, weights)
