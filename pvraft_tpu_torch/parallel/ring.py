"""The sequence-parallel ring (port of ``pvraft_tpu/parallel/ring.py``).

Both point axes of a scene are sharded over the ranks of a seq group
(``Mesh.seq_group``): each rank holds a contiguous slice of N/P points of
each cloud. A rank keeps its query rows and folds one candidate chunk at
a time into a running top-k, then sends the chunk on to the next rank of
the ring and receives the previous rank's (``parallel/collectives.py::
ring_shift``, the JAX ``lax.ppermute``): P - 1 shifts, the final fold
outside the loop, so that the last chunk is never sent on. Indices are
global: the chunk that started on rank ``src`` holds points ``src *
chunk + arange(chunk)``. Neither the (N, N) distance matrix nor the
(N, N) correlation volume is ever formed on one rank: a fold holds
(N/P, K + N/P).

The candidates' products accumulate in float32 whatever the inputs'
dtype, as the JAX ring pins them. The running top-k is the JAX
``merge_topk_xyz`` carrying each candidate's global index where JAX
carries its xyz (:func:`merge_topk`); the xyz is gathered once, at the
end, from the cloud joined over the group, as ``ops/corr.py::
corr_init``'s chunked path does.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from pvraft_tpu_torch.ops.corr import CorrState, corr_volume
from pvraft_tpu_torch.ops.geometry import Graph, gather_neighbors
from pvraft_tpu_torch.parallel.collectives import (
    gather_points,
    group_size,
    ring_shift,
)


def merge_topk(best_v: torch.Tensor, best_i: torch.Tensor,
               part_v: torch.Tensor, part_i: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a candidate block (values (B, N, C), global indices) into the
    running top-k (B, N, k) over the last axis, largest first: the JAX
    ``merge_topk_xyz`` with indices in place of positions."""
    cand_v = torch.cat([best_v, part_v], dim=-1)
    cand_i = torch.cat([best_i, part_i.expand(*part_v.shape)], dim=-1)
    new_v, sel = torch.topk(cand_v, k, dim=-1, largest=True, sorted=True)
    return new_v, torch.gather(cand_i, -1, sel)


def _ring_topk(score: Callable[[torch.Tensor], torch.Tensor],
               chunk: torch.Tensor, k: int, group: Any
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest ``score(chunk)`` (B, N, n) over every rank's chunk
    (B, n, ...), and their global indices: P folds and P - 1 shifts."""
    p = group_size(group)
    me = torch.distributed.get_rank(group)
    n = chunk.shape[1]
    best_v = best_i = None

    def fold(i, best_v, best_i, c):
        part = score(c)
        if best_v is None:
            b, rows = part.shape[:2]
            best_v = part.new_full((b, rows, k), -torch.inf)
            best_i = torch.zeros((b, rows, k), dtype=torch.int64,
                                 device=part.device)
        src = (me - i) % p            # the rank this chunk started on
        idx = torch.arange(src * n, (src + 1) * n, device=part.device)
        return merge_topk(best_v, best_i, part, idx, k)

    for i in range(p - 1):
        best_v, best_i = fold(i, best_v, best_i, chunk)
        chunk = ring_shift(chunk, group)
    return fold(p - 1, best_v, best_i, chunk)


def ring_knn_indices(query: torch.Tensor, db: torch.Tensor, k: int,
                     group: Any) -> torch.Tensor:
    """Global kNN indices over the ring, nearest first: the
    sequence-parallel ``ops/geometry.py::knn_indices``. query: (B, Nq/P,
    3), this rank's rows; db: (B, Nd/P, 3), this rank's chunk. Returns
    (B, Nq/P, k) int64 indices into the whole ``db`` (self included when
    ``query`` is ``db``)."""
    q2 = torch.sum(query * query, dim=-1, keepdim=True)      # (B, Nq, 1)

    def negd(c):                                             # (B, Nq, n)
        p2 = torch.sum(c * c, dim=-1)[:, None, :]
        cross = torch.bmm(query.float(), c.float().transpose(1, 2))
        return -(q2 + p2 - 2.0 * cross)

    return _ring_topk(negd, db, k, group)[1]


def seq_sharded_graph(pc: torch.Tensor, k: int, group: Any) -> Graph:
    """The kNN graph of a cloud with itself, sequence-parallel: this
    rank's rows (B, N/P, 3) of the cloud, their global neighbour indices
    and their neighbours' offsets, from the cloud joined over the
    group. The rows of ``ops/geometry.py::build_graph``'s graph."""
    idx = ring_knn_indices(pc, pc, k, group)
    nb = gather_neighbors(gather_points(pc, group), idx)
    return Graph(neighbors=idx, rel_pos=nb - pc[:, :, None, :])


def ring_corr_init(fmap1: torch.Tensor, fmap2: torch.Tensor,
                   xyz2: torch.Tensor, truncate_k: int, group: Any
                   ) -> CorrState:
    """The truncated correlation cache of this rank's rows over the ring.
    fmap1: (B, N1/P, D) this rank's query rows; fmap2: (B, N2/P, D) and
    xyz2: (B, N2/P, 3) this rank's candidate chunk. The top-k is global
    over all of pc2, and equal to ``ops/corr.py::corr_init``'s rows up to
    the order of near-ties. The gradient reaches ``fmap1`` and, back
    round the ring, every rank's ``fmap2`` through the kept values."""
    vals, idx = ring_truncation(fmap1, fmap2, truncate_k, group)
    return CorrState(corr=vals,
                     xyz=gather_neighbors(gather_points(xyz2, group), idx))


def ring_truncation(fmap1: torch.Tensor, fmap2: torch.Tensor,
                    truncate_k: int, group: Any
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring's truncation of :func:`ring_corr_init`: this rank's rows'
    top-``truncate_k`` correlations over every rank's chunk, (B, N1/P, K)
    values, largest first, and their global indices into pc2."""
    n2 = fmap2.shape[1] * group_size(group)
    if truncate_k > n2:
        raise ValueError(
            f"truncate_k ({truncate_k}) must be <= the number of candidate "
            f"points N2 ({n2})")
    return _ring_topk(lambda f2: corr_volume(fmap1, f2), fmap2, truncate_k,
                      group)
