"""Point-cloud geometry primitives (port of ``pvraft_tpu/ops/geometry.py``).

The kNN graph is a dense ``(B, N, k)`` index tensor; the distance matrix
uses the quadratic expansion ``|a|^2 + |b|^2 - 2 a.b`` with an fp32
batched product, the same arithmetic as the JAX package, so the
self-neighbour and near-tie order follow it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances. a: (B, N, 3), b: (B, M, 3) -> (B, N, M)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)             # (B, N, 1)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)             # (B, M, 1)
    cross = torch.bmm(a.float(), b.float().transpose(1, 2))
    return a2 + b2.transpose(1, 2) - 2.0 * cross


def knn_indices(query: torch.Tensor, points: torch.Tensor, k: int,
                chunk: Optional[int] = None, approx: bool = False
                ) -> torch.Tensor:
    """Indices of the k nearest ``points`` for each ``query`` point, nearest
    first. query: (B, N, 3), points: (B, M, 3) -> (B, N, k) int64.

    ``chunk`` streams the M axis ``chunk`` points at a time with a running
    top-k (the running best concatenated with the chunk's candidates,
    then ``topk``), so the (N, M) distance matrix is never formed: memory
    O(N (k + chunk)). ``chunk >= M`` takes the dense path; otherwise it
    must divide M. ``approx`` (the JAX ``lax.approx_max_k``) computes the
    exact top-k, as XLA does off the TPU; it is refused with ``chunk``,
    before the size check, as in JAX."""
    if approx and chunk is not None:
        raise ValueError("approx kNN is not supported with chunked "
                         "streaming (the running top-k is exact by "
                         "construction)")
    m = points.shape[1]
    if chunk is not None and chunk >= m:
        chunk = None
    if chunk is None:
        d = pairwise_sqdist(query, points)
        return torch.topk(d, k, dim=-1, largest=False, sorted=True).indices
    if m % chunk:
        raise ValueError(f"chunk {chunk} must divide M={m}")
    q2 = torch.sum(query * query, dim=-1, keepdim=True)      # (B, N, 1)

    def negd(start: int) -> torch.Tensor:                    # (B, N, chunk)
        pts = points[:, start:start + chunk]
        p2 = torch.sum(pts * pts, dim=-1)[:, None, :]
        cross = torch.bmm(query.float(), pts.float().transpose(1, 2))
        return -(q2 + p2 - 2.0 * cross)

    return streamed_topk(negd, m, chunk, k)[1]


def streamed_topk(score: Callable[[int], torch.Tensor], m: int, chunk: int,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores over ``score(start)`` (B, N, chunk) for start =
    0, chunk, ..., m - chunk, and their indices in [0, m), largest
    first: a running top-k, started from -inf values, over the running
    best concatenated with each chunk's scores. Memory O(N (k + chunk))."""
    best_v = best_i = None
    for start in range(0, m, chunk):
        part = score(start)
        if best_v is None:
            b, n = part.shape[:2]
            best_v = part.new_full((b, n, k), -torch.inf)
            best_i = torch.zeros((b, n, k), dtype=torch.int64,
                                 device=part.device)
        idx = torch.arange(start, start + chunk, device=part.device)
        best_v, sel = torch.topk(torch.cat([best_v, part], dim=-1), k,
                                 dim=-1, largest=True, sorted=True)
        best_i = torch.gather(
            torch.cat([best_i, idx.expand(b, n, chunk)], dim=-1), -1, sel)
    return best_v, best_i


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


def build_graph(pc: torch.Tensor, k: int, chunk: Optional[int] = None,
                approx: bool = False) -> Graph:
    """The kNN graph of a cloud with itself. pc: (B, N, 3); ``chunk`` and
    ``approx`` as in :func:`knn_indices`."""
    idx = knn_indices(pc, pc, k, chunk=chunk, approx=approx)
    nb = gather_neighbors(pc, idx)
    return Graph(neighbors=idx, rel_pos=nb - pc[:, :, None, :])
