"""Truncated all-pairs correlation volume (port of ``pvraft_tpu/ops/corr.py``).

The (B, N, M) product and the top-k truncation stay library calls, as
the JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from pvraft_tpu_torch.ops.geometry import gather_neighbors


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
    valid2: Optional[torch.Tensor] = None,
) -> CorrState:
    """Build the truncated correlation cache (dense path).

    ``valid2`` (B, M) bool, True = real pc2 point: padding candidates are
    set to ``finfo.min`` before the truncation, so the kept top-k is the
    unpadded one whenever each scene has >= ``truncate_k`` real points.
    """
    if truncate_k > fmap2.shape[1]:
        raise ValueError(
            f"truncate_k ({truncate_k}) must be <= the number of candidate "
            f"points N2 ({fmap2.shape[1]})"
        )
    corr = corr_volume(fmap1, fmap2)
    if valid2 is not None:
        corr = torch.where(valid2[:, None, :], corr,
                           torch.finfo(corr.dtype).min)
    vals, idx = torch.topk(corr, truncate_k, dim=-1, largest=True, sorted=True)
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
