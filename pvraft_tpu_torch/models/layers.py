"""Shared neural building blocks (port of ``pvraft_tpu/models/layers.py``).

Channel-last ``(B, N, ..., C)`` layout throughout: every 1x1 conv is a
``Linear``, and GroupNorm reduces over all non-batch axes with the
channels grouped. The GroupNorm statistics follow flax's ``GroupNorm``:
variance as ``E[x^2] - E[x]^2`` clipped at 0, and with a mask only the
valid positions enter the mean and the variance.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pvraft_tpu_torch.ops.geometry import Graph, gather_neighbors


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope ``alpha`` (init 0.25)."""

    def __init__(self, slope_init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), slope_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 8, eps: float = 1e-5,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over a channel-last x (B, ..., C).

    ``mask`` (B, N) bool, True = valid, covers x's first non-batch axis;
    masked-out positions are excluded from the statistics (serve bucket
    padding), and are normalized with the valid positions' statistics.
    """
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups)
    if mask is None:
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    else:
        m = mask.reshape(b, mask.shape[1], *([1] * (x.dim() - 3)))
        m = m.expand(*x.shape[:-1]).reshape(b, -1, 1, 1)
        count = m.sum(dim=1, keepdim=True) * (c // groups)
        mean = torch.where(m, xg, 0.0).sum(dim=(1, 3), keepdim=True) / count
        mean2 = torch.where(m, xg * xg, 0.0).sum(dim=(1, 3),
                                                 keepdim=True) / count
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight.reshape(groups, c // groups)
    return ((xg - mean) * mul).reshape(x.shape) + bias


class GroupNorm(nn.Module):
    """GroupNorm(8, eps 1e-5) with affine ``weight``/``bias`` (flax
    ``scale``/``bias``), channel-last, optionally masked."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps,
                          mask)


class SetConv(nn.Module):
    """DGCNN-style edge convolution: per-edge (neighbour - centre feature,
    relative xyz) -> fc1 -> GN -> LeakyReLU(0.1) -> max over k -> fc2 ->
    GN -> LeakyReLU -> fc3 -> GN -> LeakyReLU. Bias-free projections."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        mid = (out_ch + in_ch) // 2 if in_ch % 2 == 0 else out_ch // 2
        self.fc1 = nn.Linear(in_ch + 3, mid, bias=False)
        self.gn1 = GroupNorm(mid)
        self.fc2 = nn.Linear(mid, out_ch, bias=False)
        self.gn2 = GroupNorm(out_ch)
        self.fc3 = nn.Linear(out_ch, out_ch, bias=False)
        self.gn3 = GroupNorm(out_ch)

    def forward(self, x: torch.Tensor, graph: Graph,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        nb = gather_neighbors(x, graph.neighbors)             # (B, N, k, C)
        edge = nb - x[:, :, None, :]
        h = torch.cat([edge, graph.rel_pos.to(x.dtype)], dim=-1)
        h = F.leaky_relu(self.gn1(self.fc1(h), mask), 0.1)
        h = torch.amax(h, dim=2)                              # pool over k
        h = F.leaky_relu(self.gn2(self.fc2(h), mask), 0.1)
        h = F.leaky_relu(self.gn3(self.fc3(h), mask), 0.1)
        return h
