"""Roach privileged expert policy as a torch module (counterpart of
`thinktwice_tpu/agents/roach.py`).

XtMaCNN trunk over the 15-channel birdview: six VALID convs
(8,5,s2) -> (16,5,s2) -> (32,5,s2) -> (64,3,s2) -> (128,3,s2) ->
(256,3,s1), ReLU after each; 192 x 192 in -> 2 x 2 x 256 -> 1024 features,
flattened in the JAX package's (H, W, C) order so its Dense weights load
as they are. A state MLP 6 -> 256, then 1280 -> 512 -> 256. Policy head
[256, 256] -> softplus alpha and beta per action dim (acc, steer); value
head [256, 256] -> 1. Inputs are NCHW (B, 15, 192, 192) in [0, 1] and the
state vector [throttle, steer, brake, gear, vel_x, vel_y].
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

TRUNC_STD = 0.87962566103423978   # std of a standard normal truncated to [-2, 2]
CONV_SPECS = ((8, 5, 2), (16, 5, 2), (32, 5, 2), (64, 3, 2), (128, 3, 2),
              (256, 3, 1))


class XtMaCNN(nn.Module):
    def __init__(self, in_channels: int = 15, features_dim: int = 256,
                 states_neurons: Sequence[int] = (256,), state_dim: int = 6,
                 cnn_out: int = 1024):
        super().__init__()
        convs, ch_in = [], in_channels
        for ch, k, s in CONV_SPECS:
            convs.append(nn.Conv2d(ch_in, ch, k, stride=s))
            ch_in = ch
        self.convs = nn.ModuleList(convs)
        states, n_in = [], state_dim
        for n in states_neurons:
            states.append(nn.Linear(n_in, n))
            n_in = n
        self.states = nn.ModuleList(states)
        self.linear0 = nn.Linear(cnn_out + n_in, 512)
        self.linear1 = nn.Linear(512, features_dim)

    def forward(self, birdview, state):
        """-> (features (B, features_dim), list of per-conv NCHW maps)."""
        x = birdview
        cnn_feats = []
        for conv in self.convs:
            x = F.relu(conv(x))
            cnn_feats.append(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C) order
        s = state
        for lin in self.states:
            s = F.relu(lin(s))
        x = F.relu(self.linear0(torch.cat([x, s], dim=-1)))
        x = F.relu(self.linear1(x))
        return x, cnn_feats


class RoachPolicy(nn.Module):
    def __init__(self, features_dim: int = 256,
                 states_neurons: Sequence[int] = (256,),
                 policy_head_arch: Sequence[int] = (256, 256),
                 value_head_arch: Sequence[int] = (256, 256),
                 action_dim: int = 2, in_channels: int = 15,
                 state_dim: int = 6):
        super().__init__()
        self.features_extractor = XtMaCNN(in_channels, features_dim,
                                          states_neurons, state_dim)
        pi, n_in = [], features_dim
        for n in policy_head_arch:
            pi.append(nn.Linear(n_in, n))
            n_in = n
        self.policy_head = nn.ModuleList(pi)
        self.dist_alpha = nn.Linear(n_in, action_dim)
        self.dist_beta = nn.Linear(n_in, action_dim)
        vf, n_in = [], features_dim
        for n in value_head_arch:
            vf.append(nn.Linear(n_in, n))
            n_in = n
        self.value_head = nn.ModuleList(vf)
        self.value_out = nn.Linear(n_in, 1)

    @classmethod
    def from_config(cls, cfg) -> "RoachPolicy":
        return cls(
            features_dim=cfg.roach.features_dim,
            states_neurons=cfg.roach.states_neurons,
            policy_head_arch=cfg.roach.policy_head,
            value_head_arch=cfg.roach.value_head,
            action_dim=cfg.roach.action_dim,
            in_channels=cfg.birdview.n_channels,
            state_dim=cfg.roach.state_dim,
        )

    def forward(self, birdview, state):
        """-> dict of alpha, beta (B, A), value (B, 1), features (B, F) and
        cnn_features (list of NCHW maps)."""
        features, cnn_feats = self.features_extractor(birdview, state)
        pi = features
        for lin in self.policy_head:
            pi = F.relu(lin(pi))
        alpha = F.softplus(self.dist_alpha(pi))
        beta = F.softplus(self.dist_beta(pi))
        vf = features
        for lin in self.value_head:
            vf = F.relu(lin(vf))
        return {
            "alpha": alpha,
            "beta": beta,
            "value": self.value_out(vf),
            "features": features,
            "cnn_features": cnn_feats,
        }


def beta_mode(alpha, beta):
    """Deterministic action from Beta(alpha, beta) on [0, 1], rescaled to
    [-1, 1]: the mode inside (1, inf)^2, else 0, 1 or the mean."""
    mode = (alpha - 1) / torch.clamp_min(alpha + beta - 2, 1e-9)
    mean = alpha / torch.clamp_min(alpha + beta, 1e-5)
    x = torch.where(
        (alpha > 1) & (beta > 1), mode,
        torch.where(
            (alpha <= 1) & (beta > 1), torch.zeros_like(mode),
            torch.where((alpha > 1) & (beta <= 1), torch.ones_like(mode), mean),
        ),
    )
    return x * 2.0 - 1.0


def acc_to_control(action_pm1):
    """(acc, steer) in [-1, 1] -> (steer, throttle, brake) controls."""
    acc = action_pm1[..., 0]
    steer = torch.clamp(action_pm1[..., 1], -1.0, 1.0)
    throttle = torch.clamp(acc, 0.0, 1.0)
    brake = torch.clamp(-acc, 0.0, 1.0)
    return torch.stack([steer, throttle, brake], dim=-1)
