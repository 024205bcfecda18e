"""Point-cloud geometry primitives (port of ``pvraft_tpu/ops/geometry.py``).

The kNN graph is a dense ``(B, N, k)`` index tensor; the distance matrix
uses the quadratic expansion ``|a|^2 + |b|^2 - 2 a.b`` with an fp32
batched product, the same arithmetic as the JAX package, so the
self-neighbour and near-tie order follow it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances. a: (B, N, 3), b: (B, M, 3) -> (B, N, M)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)             # (B, N, 1)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)             # (B, M, 1)
    cross = torch.bmm(a.float(), b.float().transpose(1, 2))
    return a2 + b2.transpose(1, 2) - 2.0 * cross


def knn_indices(query: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k nearest ``points`` for each ``query`` point, nearest
    first. query: (B, N, 3), points: (B, M, 3) -> (B, N, k) int64."""
    d = pairwise_sqdist(query, points)
    return torch.topk(d, k, dim=-1, largest=False, sorted=True).indices


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats: (B, M, C), idx: (B, N, k) -> (B, N, k, C)."""
    b, n, k = idx.shape
    flat = idx.reshape(b, n * k, 1).expand(b, n * k, feats.shape[-1])
    return torch.gather(feats, 1, flat).reshape(b, n, k, feats.shape[-1])


class Graph(NamedTuple):
    """Directed kNN graph on a point cloud."""

    neighbors: torch.Tensor   # (B, N, k) int64
    rel_pos: torch.Tensor     # (B, N, k, 3) = xyz[neighbor] - xyz[center]

    @property
    def k(self) -> int:
        return self.neighbors.shape[-1]


def build_graph(pc: torch.Tensor, k: int) -> Graph:
    """The kNN graph of a cloud with itself. pc: (B, N, 3)."""
    idx = knn_indices(pc, pc, k)
    nb = gather_neighbors(pc, idx)
    return Graph(neighbors=idx, rel_pos=nb - pc[:, :, None, :])
