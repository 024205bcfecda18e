"""Voxel-branch correlation pooling (port of ``pvraft_tpu/ops/voxel.py``).

For each query point and pyramid level, the mean truncated correlation of
the candidates that fall into each cell of a ``resolution^3`` cube
centred on the coordinate estimate:

  * cell index = round((candidate - coord) / r) per axis, rounding half
    to even; valid iff all three components lie within
    +/- floor(resolution/2) and the flat index is below resolution^3;
  * invalid candidates contribute nothing;
  * counts are clamped to [1, N] (N = query points) before the division.

:func:`voxel_bwd` is the gradient of :func:`voxel_bin_means` with respect
to ``corr`` (port of ``_voxel_bwd``, ``pvraft_tpu/ops/pallas/voxel_corr.py``):
the backward of the voxel kernel and the voxel half of the fused
lookup's backward.
"""

from __future__ import annotations

from typing import Tuple

import torch


def voxel_cells(rel: torch.Tensor, scale: float, resolution: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each candidate's cell index at one level (int64, 0 where invalid)
    and its validity. rel: (B, N, K, 3) -> (B, N, K), (B, N, K)."""
    half = resolution // 2
    # A 0-dim tensor on the same device keeps this a true division
    # (a host scalar divisor becomes a reciprocal multiply on CUDA); filled
    # on the device, not copied from the host, so a CUDA graph can hold it.
    r = torch.full((), scale, dtype=rel.dtype, device=rel.device)
    dv = torch.round(rel / r)
    valid = torch.all(torch.abs(dv) <= half, dim=-1)
    cell = ((dv[..., 0] + half) * (resolution**2)
            + (dv[..., 1] + half) * resolution
            + (dv[..., 2] + half)).to(torch.int64)
    if resolution % 2 == 0:
        # An even resolution's range spans resolution + 1 offsets per axis,
        # so an index can pass the last of the resolution^3 cells: such a
        # candidate is dropped, as the JAX package's per-cell sums over
        # range(resolution^3) drop it.
        valid = valid & (cell < resolution**3)
    return torch.where(valid, cell, 0), valid


def voxel_bin_means(
    corr: torch.Tensor,
    rel: torch.Tensor,
    num_levels: int,
    base_scale: float,
    resolution: int = 3,
) -> torch.Tensor:
    """corr: (B, N, K), rel: (B, N, K, 3) -> (B, N, num_levels * resolution**3)."""
    r3 = resolution**3
    b, n_pts, _ = corr.shape
    feats = []
    for lvl in range(num_levels):
        cell, valid = voxel_cells(rel, base_scale * (2**lvl), resolution)
        # Invalid candidates go to a dump bin r3 that is dropped.
        cell = torch.where(valid, cell, r3)
        w = torch.where(valid, corr, 0.0)
        sums = torch.zeros(b, n_pts, r3 + 1, dtype=corr.dtype,
                           device=corr.device).scatter_add_(-1, cell, w)
        cnts = torch.zeros_like(sums).scatter_add_(-1, cell,
                                                   valid.to(corr.dtype))
        feats.append(sums[..., :r3] / torch.clamp(cnts[..., :r3], 1, n_pts))
    return torch.cat(feats, dim=-1)


def voxel_bwd(corr: torch.Tensor, rel: torch.Tensor, g: torch.Tensor,
              num_levels: int, base_scale: float, resolution: int = 3
              ) -> torch.Tensor:
    """The gradient of :func:`voxel_bin_means` with respect to ``corr``
    for the output cotangent g (B, N, L * R^3): per level, each valid
    candidate receives g[cell] / count[cell]. ``rel`` gets none."""
    r3 = resolution**3
    b, n_pts, _ = corr.shape
    dcorr = torch.zeros_like(corr)
    for lvl in range(num_levels):
        cell, valid = voxel_cells(rel, base_scale * (2**lvl), resolution)
        vf = valid.to(corr.dtype)
        cnts = torch.zeros(b, n_pts, r3, dtype=corr.dtype,
                           device=corr.device).scatter_add_(-1, cell, vf)
        g_over_c = g[..., lvl * r3:(lvl + 1) * r3] / torch.clamp(cnts, 1, n_pts)
        dcorr = dcorr + vf * torch.gather(g_over_c, -1, cell)
    return dcorr
