"""Augmentation of student training batches (counterpart of
`thinktwice_tpu/train/augment.py`).

- `augment_images`: brightness and contrast jitter, additive noise, a box
  blur and a channel dropout, each gated by a curriculum strength in [0, 1];
- `ida_augment`: the IDA geometric augmentation, an upscale, a random crop
  of the overflow and a horizontal flip per camera, as one affine warp
  (`ops/grid_sample.py`) of every sweep's image, of gt_depth and gt_seg
  (nearest), its 4x4 matrices added to the batch as `ida` for the model;
- `maybe_mirror`: the world mirrored about the ego's x axis, per example
  (images flipped and the left and right cameras swapped, y negated, the
  steering Beta parameters and the left/right commands swapped), with the
  Roach distillation of a mirrored example switched off by distil_weight.

The random numbers are inputs (IDA matrices, mirror coins, image draws), or
come from an explicit torch.Generator when not given (one of the two is
required; torch's global generator is not read).
"""

from __future__ import annotations

import dataclasses

import torch

from thinktwice_tpu_torch.ops.grid_sample import grid_sample_2d


def _box_blur(img, k: int = 3):
    """(..., H, W, C) mean filter of k x k with edge padding (separable)."""
    pad = k // 2

    def edge_pad(x, dim):
        n = x.shape[dim]
        idx = torch.clamp(torch.arange(-pad, n + pad, device=x.device), 0, n - 1)
        return x.index_select(dim, idx)

    x = edge_pad(edge_pad(img, -3), -2)
    x = sum(torch.roll(x, s, dims=-3) for s in range(-pad, pad + 1)) / k
    x = sum(torch.roll(x, s, dims=-2) for s in range(-pad, pad + 1)) / k
    return x[..., pad:-pad, pad:-pad, :]


@dataclasses.dataclass(frozen=True)
class ImageDraws:
    """The random numbers of augment_images: bright_u, contrast_u in [-1, 1),
    sigma_u, blur_u, drop_u in [0, 1) (scalars), channel (0, 1 or 2) and
    noise (standard normals of the images' shape)."""

    bright_u: float
    contrast_u: float
    sigma_u: float
    noise: torch.Tensor
    blur_u: float
    drop_u: float
    channel: int


def _need(generator) -> None:
    if generator is None:
        raise ValueError("pass the random numbers or a seeded torch.Generator")


def sample_image_draws(shape, generator: torch.Generator, device=None) -> ImageDraws:
    _need(generator)
    u = torch.rand(6, generator=generator, device=device).tolist()
    return ImageDraws(bright_u=2 * u[0] - 1, contrast_u=2 * u[1] - 1, sigma_u=u[2],
                      noise=torch.randn(shape, generator=generator, device=device),
                      blur_u=u[3], drop_u=u[4], channel=min(int(3 * u[5]), 2))


def augment_images(imgs, strength: float, draws: ImageDraws | None = None,
                   generator: torch.Generator | None = None):
    """imgs (..., H, W, 3) in [0, 1]; strength in [0, 1] -> perturbed images
    in [0, 1]. A blur fires with probability 0.3 x strength, a channel
    dropout (that channel halved) with 0.2 x strength."""
    if draws is None:
        draws = sample_image_draws(imgs.shape, generator, imgs.device)
    s = float(strength)
    bright = 1.0 + 0.3 * s * draws.bright_u
    contrast = 1.0 + 0.3 * s * draws.contrast_u
    out = ((imgs - 0.5) * contrast + 0.5) * bright
    out = out + 0.05 * s * draws.sigma_u * draws.noise
    if draws.blur_u < 0.3 * s:
        out = _box_blur(out)
    if draws.drop_u < 0.2 * s:
        scale = torch.ones(3, device=imgs.device)
        scale[draws.channel] = 0.5
        out = out * scale
    return torch.clamp(out, 0.0, 1.0)


def curriculum(step, ramp_steps: int = 10_000) -> float:
    """Augmentation strength ramped with training progress."""
    return min(max(step / ramp_steps, 0.0), 1.0)


# --------------------------------------------------------------------------
# IDA: the images are at their final size, so the augmentation is an
# upscale (resize_lim >= 1), a bottom-aligned vertical crop and a uniform
# horizontal crop of the overflow, and a flip:
#   x_aug = sx * x + tx, y_aug = s * y - crop_h, sx = -s and
#   tx = (W - 1) + crop_w when flipped, sx = s and tx = -crop_w otherwise.


def ida_mats(scale, crop_u, flip, H: int, W: int):
    """(B, N) scale, crop_u in [0, 1), flip (bool) -> (B, N, 4, 4)
    augmented-from-raw pixel transforms."""
    crop_h = scale * H - H
    crop_w = crop_u * (scale * W - W)
    sx = torch.where(flip, -scale, scale)
    tx = torch.where(flip, (W - 1.0) + crop_w, -crop_w)
    ida = torch.zeros((*scale.shape, 4, 4), device=scale.device)
    ida[..., 0, 0] = sx
    ida[..., 1, 1] = scale
    ida[..., 0, 3] = tx
    ida[..., 1, 3] = -crop_h
    ida[..., 2, 2] = 1.0
    ida[..., 3, 3] = 1.0
    return ida


def sample_ida_mats(B: int, N: int, H: int, W: int, resize_lim=(1.0, 1.15),
                    flip_p: float = 0.5, generator: torch.Generator | None = None,
                    device=None):
    """-> (B, N, 4, 4) drawn from generator."""
    _need(generator)
    lo, hi = resize_lim
    scale = lo + torch.rand((B, N), generator=generator, device=device) * (hi - lo)
    crop_u = torch.rand((B, N), generator=generator, device=device)
    flip = torch.rand((B, N), generator=generator, device=device) < flip_p
    return ida_mats(scale, crop_u, flip, H, W)


def _warp_affine(img, ida, ds: float = 1.0, nearest: bool = False):
    """Warp images (M, H, W, C) into augmented space by their ida (M, 4, 4):
    output pixel p (at 1/ds of the ida's pixel units) samples the input at
    ida^-1 p."""
    M, H, W, _ = img.shape
    A = ida
    det = A[:, 0, 0] * A[:, 1, 1]
    inv00 = (A[:, 1, 1] / det)[:, None, None]
    inv11 = (A[:, 0, 0] / det)[:, None, None]
    dev = img.device
    ys = (torch.arange(H, device=dev) + 0.5) * ds - 0.5
    xs = (torch.arange(W, device=dev) + 0.5) * ds - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    rx = inv00 * (gx - A[:, 0, 3, None, None])
    ry = inv11 * (gy - A[:, 1, 3, None, None])
    coords = torch.stack([rx, ry], dim=-1) / ds
    if nearest:
        coords = torch.round(coords)
    return grid_sample_2d(img, coords)


def ida_augment(batch: dict, ida=None, resize_lim=(1.0, 1.15), flip_p: float = 0.5,
                generator: torch.Generator | None = None) -> dict:
    """Warp imgs (every sweep by its camera's matrix), gt_depth and gt_seg
    by ida (B, N, 4, 4) (drawn from generator when not given) and add it to
    the batch as `ida`."""
    out = dict(batch)
    imgs = batch["imgs"]                                    # (B, T, N, H, W, 3)
    B, T, N, H, W, C = imgs.shape
    if ida is None:
        ida = sample_ida_mats(B, N, H, W, resize_lim, flip_p, generator, imgs.device)
    per_img = ida[:, None].expand(B, T, N, 4, 4).reshape(-1, 4, 4)
    out["imgs"] = _warp_affine(imgs.reshape(-1, H, W, C), per_img).reshape(imgs.shape)
    flat = ida.reshape(B * N, 4, 4)
    if batch.get("gt_depth") is not None:
        out["gt_depth"] = _warp_affine(batch["gt_depth"][..., None], flat,
                                       nearest=True)[..., 0]
    if batch.get("gt_seg") is not None:
        g = batch["gt_seg"]
        out["gt_seg"] = _warp_affine(g[..., None].to(torch.float32), flat, ds=H / g.shape[1],
                                     nearest=True)[..., 0].to(g.dtype)
    out["ida"] = ida
    return out


# --------------------------------------------------------------------------
# mirror about the ego's x axis (a laterally symmetric rig: cameras front,
# left, right, back)

_CAM_SWAP = [0, 2, 1, 3]
_CMD_SWAP = [1, 0, 2, 3, 5, 4]     # LEFT <-> RIGHT, CHANGELEFT <-> CHANGERIGHT


def _flip_y(x):
    x = x.clone()
    x[..., 1] = -x[..., 1]
    return x


def _swap_steer(a, b):
    a2, b2 = a.clone(), b.clone()
    a2[..., 1], b2[..., 1] = b[..., 1], a[..., 1]
    return a2, b2


def mirror_batch(batch: dict) -> dict:
    """The batch mirrored about the ego x axis; mirror(mirror(b)) == b but
    for distil_weight, which it sets to 0 (conv features of a mirrored input
    are not the mirrored features)."""
    out = dict(batch)
    out["imgs"] = batch["imgs"][:, :, _CAM_SWAP].flip(-2)
    for key in ("points", "target_point", "gt_waypoints", "teacher_wp"):
        if batch.get(key) is not None:
            out[key] = _flip_y(batch[key])
    # the steering Beta on [0, 1] is (s + 1) / 2: negating s swaps its
    # (alpha, beta); the accel dimension stays
    for ka, kb in (("action_alpha", "action_beta"),
                   ("future_action_alpha", "future_action_beta")):
        if ka in batch:
            out[ka], out[kb] = _swap_steer(batch[ka], batch[kb])
    if batch.get("teacher_ctrl_sp") is not None:          # a_acc a_st b_acc b_st
        out["teacher_ctrl_sp"] = batch["teacher_ctrl_sp"][..., [0, 3, 2, 1]]
    if "command" in batch:
        out["command"] = batch["command"][..., _CMD_SWAP]
    if "sweep2key" in batch:
        Fm = torch.diag(torch.tensor([1.0, -1.0, 1.0, 1.0], device=batch["imgs"].device))
        out["sweep2key"] = torch.einsum("ij,...jk,kl->...il", Fm, batch["sweep2key"], Fm)
    for key in ("gt_depth", "gt_seg"):                    # (B*4, h, w[, ...])
        if batch.get(key) is not None:
            g = batch[key]
            g = g.reshape(g.shape[0] // 4, 4, *g.shape[1:])[:, _CAM_SWAP].flip(3)
            out[key] = g.reshape(-1, *g.shape[2:])
    out["distil_weight"] = torch.zeros((), device=batch["imgs"].device)
    return out


def maybe_mirror(batch: dict, do=None, per_example: bool = True,
                 generator: torch.Generator | None = None) -> dict:
    """Mirror each example where do (B,) bool is set (drawn with p = 0.5 per
    example, or one coin for the batch with per_example False, when not
    given). distil_weight becomes per example: 0 where mirrored, else the
    batch's (1 when it has none)."""
    batch = dict(batch)
    B = batch["imgs"].shape[0]
    dev = batch["imgs"].device
    prev_dw = torch.broadcast_to(
        torch.as_tensor(batch.pop("distil_weight", 1.0), dtype=torch.float32, device=dev),
        (B,))
    if do is None:
        _need(generator)
        n = B if per_example else 1
        do = (torch.rand(n, generator=generator, device=dev) < 0.5).expand(B)
    mirrored = mirror_batch(batch)

    def sel(a, b):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(sel(x, y) for x, y in zip(a, b))
        if a.dim() > 0 and a.shape[0] == B:
            m = do
        elif a.dim() > 0 and a.shape[0] == 4 * B:         # per camera: gt_depth, gt_seg
            m = do.repeat_interleave(4)
        else:                                             # shared by the batch
            return a
        return torch.where(m.reshape(-1, *([1] * (a.dim() - 1))), b, a)

    out = {k: sel(batch[k], mirrored[k]) for k in batch}
    out["distil_weight"] = torch.where(do, torch.zeros_like(prev_dw), prev_dw)
    return out
