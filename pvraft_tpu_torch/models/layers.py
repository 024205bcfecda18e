"""Shared neural building blocks (port of ``pvraft_tpu/models/layers.py``).

Channel-last ``(B, N, ..., C)`` layout throughout: every 1x1 conv is a
:class:`Dense`, and GroupNorm reduces over all non-batch axes with the
channels grouped. The GroupNorm statistics follow flax's ``GroupNorm``:
variance as ``E[x^2] - E[x]^2`` clipped at 0, and with a mask only the
valid positions enter the mean and the variance.

The compute dtype follows flax's rules, so that a bfloat16 model rounds
where the JAX package's does: parameters stay float32; a :class:`Dense`
casts its input, kernel and bias to its ``compute_dtype`` and returns
that dtype; GroupNorm computes in float32 and returns float32 (flax's
``GroupNorm`` with no dtype promotes to its float32 scale); PReLU casts
its slope to the input's dtype.

Sequence parallelism (``parallel/``): with a ``seq_group``, a rank holds
a contiguous slice of each cloud's points. GroupNorm then sums its
count, sum and sum of squares over the group before it forms the mean and
the variance, and a SetConv gathers its neighbours' features from its
input joined over the group, since the graph's indices are global
(``parallel/collectives.py``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pvraft_tpu_torch.ops.geometry import Graph, gather_neighbors
from pvraft_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    gather_points,
    group_size,
)


class Dense(nn.Linear):
    """flax's ``nn.Dense(dtype=compute_dtype)`` on a ``Linear``'s float32
    parameters: input, kernel and bias cast to ``compute_dtype``, the
    product (accumulated in float32 by the backend) rounded to it, then
    the bias added in it. At float32 it is ``Linear`` on a float32
    input."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if d == torch.float32:
            return super().forward(x.float())
        y = F.linear(x.to(d), self.weight.to(d))
        return y if self.bias is None else y + self.bias.to(d)


class PReLU(nn.Module):
    """Parametric ReLU with one shared slope ``alpha`` (init 0.25)."""

    def __init__(self, slope_init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), slope_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 8, eps: float = 1e-5,
               mask: Optional[torch.Tensor] = None,
               seq_group: Any = None) -> torch.Tensor:
    """GroupNorm over a channel-last x (B, ..., C), computed and returned
    in float32 whatever x's dtype.

    ``mask`` (B, N) bool, True = valid, covers x's first non-batch axis;
    masked-out positions are excluded from the statistics (serve bucket
    padding), and are normalized with the valid positions' statistics.
    ``seq_group``: x holds this rank's rows of the points, and the
    statistics are the group's (:func:`_group_stats`).
    """
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    if seq_group is not None:
        mean, mean2 = _group_stats(xg, mask, x.shape, seq_group)
    elif mask is None:
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    else:
        m = _stat_mask(mask, x.shape)
        count = m.sum(dim=1, keepdim=True) * (c // groups)
        mean = torch.where(m, xg, 0.0).sum(dim=(1, 3), keepdim=True) / count
        mean2 = torch.where(m, xg * xg, 0.0).sum(dim=(1, 3),
                                                 keepdim=True) / count
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * weight.reshape(groups, c // groups)
    return ((xg - mean) * mul).reshape(x.shape) + bias


def _stat_mask(mask: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """The (B, N) mask over the positions of an x of ``shape`` (B, N,
    ..., C), as (B, positions, 1, 1)."""
    b = shape[0]
    m = mask.reshape(b, mask.shape[1], *([1] * (len(shape) - 3)))
    return m.expand(*shape[:-1]).reshape(b, -1, 1, 1)


def _group_stats(xg: torch.Tensor, mask: Optional[torch.Tensor],
                 shape: torch.Size, seq_group: Any):
    """The mean and mean square of the grouped xg (B, positions, G, C/G)
    of an x of ``shape`` over every rank of ``seq_group``: this rank's
    sums, and with a mask its count, summed over the group in one
    collective, then divided."""
    per = xg.shape[-1]
    if mask is None:
        sums = torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))])
        sums = all_reduce_sum(sums, seq_group)
        count = xg.shape[1] * per * group_size(seq_group)
    else:
        m = _stat_mask(mask, shape)
        n = (m.sum(dim=(1, 2, 3)) * per).to(xg.dtype)
        sums = torch.stack([torch.where(m, xg, 0.0).sum(dim=(1, 3)),
                            torch.where(m, xg * xg, 0.0).sum(dim=(1, 3)),
                            n[:, None].expand(-1, xg.shape[2])])
        sums = all_reduce_sum(sums, seq_group)
        count = sums[2]
    return ((sums[0] / count)[:, None, :, None],
            (sums[1] / count)[:, None, :, None])


class GroupNorm(nn.Module):
    """GroupNorm(8, eps 1e-5) with affine ``weight``/``bias`` (flax
    ``scale``/``bias``), channel-last, optionally masked; statistics over
    a ``seq_group``'s ranks where one is given."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-5,
                 seq_group: Any = None):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.seq_group = seq_group
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps,
                          mask, self.seq_group)


class SetConv(nn.Module):
    """DGCNN-style edge convolution: per-edge (neighbour - centre feature,
    relative xyz) -> fc1 -> GN -> LeakyReLU(0.1) -> max over k -> fc2 ->
    GN -> LeakyReLU -> fc3 -> GN -> LeakyReLU. Bias-free projections at
    ``compute_dtype``; the GroupNorms return float32, and so does the
    layer. With a ``seq_group`` x holds this rank's rows, the graph's
    indices are global, and the neighbours come from x joined over the
    group."""

    def __init__(self, in_ch: int, out_ch: int,
                 compute_dtype: torch.dtype = torch.float32,
                 seq_group: Any = None):
        super().__init__()
        mid = (out_ch + in_ch) // 2 if in_ch % 2 == 0 else out_ch // 2
        self.seq_group = seq_group
        self.fc1 = Dense(in_ch + 3, mid, False, compute_dtype)
        self.gn1 = GroupNorm(mid, seq_group=seq_group)
        self.fc2 = Dense(mid, out_ch, False, compute_dtype)
        self.gn2 = GroupNorm(out_ch, seq_group=seq_group)
        self.fc3 = Dense(out_ch, out_ch, False, compute_dtype)
        self.gn3 = GroupNorm(out_ch, seq_group=seq_group)

    def forward(self, x: torch.Tensor, graph: Graph,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        whole = x if self.seq_group is None else gather_points(
            x, self.seq_group)
        nb = gather_neighbors(whole, graph.neighbors)         # (B, N, k, C)
        edge = nb - x[:, :, None, :]
        h = torch.cat([edge, graph.rel_pos.to(x.dtype)], dim=-1)
        h = F.leaky_relu(self.gn1(self.fc1(h), mask), 0.1)
        h = torch.amax(h, dim=2)                              # pool over k
        h = F.leaky_relu(self.gn2(self.fc2(h), mask), 0.1)
        h = F.leaky_relu(self.gn3(self.fc3(h), mask), 0.1)
        return h
