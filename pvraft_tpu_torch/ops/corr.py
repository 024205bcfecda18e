"""Truncated all-pairs correlation volume (port of ``pvraft_tpu/ops/corr.py``).

The (B, N, M) product and the top-k truncation stay library calls, as
the JAX package leaves them to XLA outside any Pallas kernel; with
``chunk`` they stream over the second cloud (:func:`corr_init`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from pvraft_tpu_torch.ops.geometry import gather_neighbors, streamed_topk


class CorrState(NamedTuple):
    """Per-pair correlation cache."""

    corr: torch.Tensor   # (B, N1, K) top-k correlation values, descending
    xyz: torch.Tensor    # (B, N1, K, 3) positions of the top-k pc2 points


def corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """fmap1: (B, N, D), fmap2: (B, M, D) -> (B, N, M), scaled by 1/sqrt(D)."""
    d = fmap1.shape[-1]
    out = torch.bmm(fmap1.float(), fmap2.float().transpose(1, 2))
    return out / math.sqrt(d)


def corr_init(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    xyz2: torch.Tensor,
    truncate_k: int,
    chunk: Optional[int] = None,
    approx: bool = False,
    valid2: Optional[torch.Tensor] = None,
) -> CorrState:
    """Build the truncated correlation cache.

    With ``chunk=None`` the (B, N, M) volume is formed and truncated with
    one ``topk``. With ``chunk`` the M axis is streamed ``chunk`` points
    at a time: a running top-k, started from -inf values, takes the
    running best concatenated with the chunk's correlations, so memory is
    O(N (K + chunk)). The running top-k carries the candidates' global
    indices and gathers their xyz once, at the end, where the JAX package
    broadcasts each chunk's xyz to (B, N, chunk, 3) and carries it: the
    same xyz, without the (B, N, K + chunk, 3) copies. The gradient
    reaches ``fmap1`` and ``fmap2`` through the selected values, as in
    JAX. ``approx`` (``lax.approx_max_k`` in JAX) computes the exact
    top-k, which is what XLA computes off the TPU.

    ``valid2`` (B, M) bool, True = real pc2 point: padding candidates are
    set to ``finfo.min`` before the truncation, so the kept top-k is the
    unpadded one whenever each scene has >= ``truncate_k`` real points.

    The checks run in the JAX package's order: ``truncate_k > M``;
    ``valid2`` with ``approx``; ``approx`` with ``chunk`` (before the size
    fallback); ``chunk >= M`` takes the dense path; ``valid2`` with a
    chunk still in force; ``M % chunk``.
    """
    m = fmap2.shape[1]
    if truncate_k > m:
        raise ValueError(
            f"truncate_k ({truncate_k}) must be <= the number of candidate "
            f"points N2 ({m})"
        )
    if valid2 is not None and approx:
        raise ValueError(
            "valid2 masking is not supported with approx_topk: approximate "
            "recall could let padding candidates into the kept top-k")
    if approx and chunk is not None:
        raise ValueError(
            "approx_topk is not supported with corr_chunk: the chunked "
            "scan keeps an exact running top-k (use one or the other)")
    if chunk is not None and chunk >= m:
        chunk = None
    if valid2 is not None and chunk is not None:
        raise ValueError(
            "valid2 masking is not supported with corr_chunk: the serve "
            "path uses the dense truncation (chunking exists for training "
            "at 16k+ points, beyond the serve buckets)")
    if chunk is None:
        corr = corr_volume(fmap1, fmap2)
        if valid2 is not None:
            corr = torch.where(valid2[:, None, :], corr,
                               torch.finfo(corr.dtype).min)
        vals, idx = torch.topk(corr, truncate_k, dim=-1, largest=True,
                               sorted=True)
        return CorrState(corr=vals, xyz=gather_neighbors(xyz2, idx))
    if m % chunk:
        raise ValueError(f"chunk {chunk} must divide N2={m}")
    vals, idx = streamed_topk(
        lambda start: corr_volume(fmap1, fmap2[:, start:start + chunk]),
        m, chunk, truncate_k)
    return CorrState(corr=vals, xyz=gather_neighbors(xyz2, idx))


def knn_select(rel: torch.Tensor, k: int) -> torch.Tensor:
    """The k candidates nearest to the coordinate estimate, nearest first;
    among equal distances the lowest candidate index wins (the rule of
    ``lax.top_k`` and of the fused lookup kernel). rel: (B, N, K, 3) ->
    (B, N, k) int64."""
    dist = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1] \
        + rel[..., 2] * rel[..., 2]
    return torch.sort(dist, dim=-1, stable=True).indices[..., :k]


def take_candidates(corr: torch.Tensor, rel: torch.Tensor, nbr: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selected candidates' correlation (B, N, k) and offsets
    (B, N, k, 3). corr: (B, N, K), rel: (B, N, K, 3), nbr: (B, N, k)."""
    knn_corr = torch.gather(corr, -1, nbr)
    rel_xyz = torch.gather(rel, 2, nbr[..., None].expand(*nbr.shape, 3))
    return knn_corr, rel_xyz


def knn_lookup(state: CorrState, rel: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-branch lookup. rel: (B, N, K, 3) candidate positions relative
    to the current coords. Returns knn_corr (B, N, k) and rel_xyz
    (B, N, k, 3)."""
    return take_candidates(state.corr, rel, knn_select(rel, k))
