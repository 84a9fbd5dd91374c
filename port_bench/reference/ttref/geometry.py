"""SE(2) and box geometry shared by the world step, the sensors and the
criteria (counterpart of `thinktwice_tpu/geometry.py`).

Every function broadcasts over leading batch axes, so the same code serves
one world or a leading world axis.
"""

from __future__ import annotations

import torch


def wrap_angle(a):
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def rot2d(yaw):
    """(...,) yaw -> (..., 2, 2) rotation matrix (world_from_local)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def _apply_rot(R, pts):
    """(..., 2, 2) x (..., N, 2) -> (..., N, 2) as two products and one sum
    per coordinate, the order in which XLA evaluates the 2-term einsum."""
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack(
        [
            R[..., 0, 0, None] * x + R[..., 0, 1, None] * y,
            R[..., 1, 0, None] * x + R[..., 1, 1, None] * y,
        ],
        dim=-1,
    )


def world_from_local(pos, yaw, pts_local):
    """Local (..., N, 2) points into the world frame at pose (..., 2), (...,)."""
    return pos[..., None, :] + _apply_rot(rot2d(yaw), pts_local)


def sweep_to_key(pos_sweep, yaw_sweep, pos_key, yaw_key):
    """SE(3) 4x4 taking sweep-ego coordinates into key-ego coordinates:
    x_key = R(yaw_key)^T (R(yaw_sweep) x_sweep + pos_sweep - pos_key); z is
    untouched. Broadcasts over leading dims."""
    dyaw = yaw_sweep - yaw_key
    c, s = torch.cos(dyaw), torch.sin(dyaw)
    dp = pos_sweep - pos_key
    ck, sk = torch.cos(yaw_key), torch.sin(yaw_key)
    tx = dp[..., 0] * ck + dp[..., 1] * sk
    ty = -dp[..., 0] * sk + dp[..., 1] * ck
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zero, tx], dim=-1),
            torch.stack([s, c, zero, ty], dim=-1),
            torch.stack([zero, zero, one, zero], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def box_corners(pos, yaw, extent):
    """OBB corners: pos (..., 2), yaw (...,), extent (..., 2) half-sizes ->
    (..., 4, 2) counter-clockwise corners."""
    ex, ey = extent[..., 0], extent[..., 1]
    local = torch.stack(
        [
            torch.stack([ex, ey], dim=-1),
            torch.stack([-ex, ey], dim=-1),
            torch.stack([-ex, -ey], dim=-1),
            torch.stack([ex, -ey], dim=-1),
        ],
        dim=-2,
    )
    return world_from_local(pos, yaw, local)


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def obb_overlap(pos_a, yaw_a, ext_a, pos_b, yaw_b, ext_b):
    """Separating-axis OBB-vs-OBB intersection; all args broadcastable ->
    bool (...,)."""
    d = pos_b - pos_a

    def axes(yaw):
        c, s = torch.cos(yaw), torch.sin(yaw)
        return torch.stack([c, s], dim=-1), torch.stack([-s, c], dim=-1)

    axa, aya = axes(yaw_a)
    axb, ayb = axes(yaw_b)

    def sep(axis):
        ra = (torch.abs(_dot2(axa, axis)) * ext_a[..., 0]
              + torch.abs(_dot2(aya, axis)) * ext_a[..., 1])
        rb = (torch.abs(_dot2(axb, axis)) * ext_b[..., 0]
              + torch.abs(_dot2(ayb, axis)) * ext_b[..., 1])
        return torch.abs(_dot2(d, axis)) > ra + rb

    separated = sep(axa) | sep(aya) | sep(axb) | sep(ayb)
    return ~separated


def segments_intersect(p1, p2, q1, q2):
    """Proper segment intersection (stop-line crossing test)."""

    def cross(o, a, b):
        return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
            a[..., 1] - o[..., 1]
        ) * (b[..., 0] - o[..., 0])

    d1 = cross(q1, q2, p1)
    d2 = cross(q1, q2, p2)
    d3 = cross(p1, p2, q1)
    d4 = cross(p1, p2, q2)
    return ((d1 * d2) < 0) & ((d3 * d4) < 0)
