"""The command class and the camera normalisation of the port's dataset
collection (counterpart of `route_command`, `IMAGENET_MEAN` and
`IMAGENET_STD` in `thinktwice_tpu/train/collect.py`), which the student's
driver shares."""

from __future__ import annotations

import torch

from port_bench.reference.ttref.maps.town import TownMap

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# command classes (RoadOption - 1)
CMD_LEFT, CMD_RIGHT, CMD_STRAIGHT = 0, 1, 2
CMD_LANEFOLLOW, CMD_CHANGELEFT, CMD_CHANGERIGHT = 3, 4, 5


def route_command(town: TownMap, route, route_idx, lookahead_pts: int = 35):
    """6-way command class of B worlds from the route geometry ahead: route
    (B, R, 3), route_idx (B,) -> (B,) int64.

    The heading change over the next lookahead_pts points classifies turns;
    a small heading change with a large lateral displacement classifies lane
    changes; a small change near a signalized junction is STRAIGHT, else
    LANEFOLLOW."""
    B, R, _ = route.shape
    b = torch.arange(B, device=route.device)
    j = torch.clamp(route_idx + lookahead_pts, 0, R - 1)
    mid = torch.clamp(route_idx + lookahead_pts // 2, 0, R - 1)
    hdg0 = route[b, route_idx, 2]
    hdg1 = route[b, j, 2]
    dh = torch.atan2(torch.sin(hdg1 - hdg0), torch.cos(hdg1 - hdg0))
    rel = route[b, j, :2] - route[b, route_idx, :2]
    lat = -torch.sin(hdg0) * rel[:, 0] + torch.cos(hdg0) * rel[:, 1]
    dist = torch.linalg.norm(town.tl_pos[None] - route[b, mid, :2][:, None], dim=-1)
    d_junction = torch.min(torch.where(town.tl_valid[None], dist,
                                       torch.full_like(dist, 1e9)), dim=1).values
    turning = torch.abs(dh) > 0.35
    changing = ~turning & (torch.abs(dh) < 0.15) & (torch.abs(lat) > 2.5)

    def pick(cond, a, c):
        return torch.where(cond, torch.as_tensor(a, device=route.device), c)

    lanefollow = torch.full((B,), CMD_LANEFOLLOW, dtype=torch.int64, device=route.device)
    cmd = pick(d_junction < 15.0, CMD_STRAIGHT, lanefollow)
    cmd = torch.where(changing, pick(lat < 0, CMD_CHANGELEFT,
                                     torch.full_like(cmd, CMD_CHANGERIGHT)), cmd)
    return torch.where(turning, pick(dh < 0, CMD_LEFT, torch.full_like(cmd, CMD_RIGHT)),
                       cmd)

