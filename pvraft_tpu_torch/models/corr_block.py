"""Learned heads over the point-voxel correlation lookup (port of
``pvraft_tpu/models/corr_block.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from pvraft_tpu_torch.config import (
    ModelConfig,
    compute_dtype,
    resolve_use_pallas,
)
from pvraft_tpu_torch.models.layers import Dense, GroupNorm, PReLU
from pvraft_tpu_torch.ops.corr import CorrState
from pvraft_tpu_torch.ops.cuda.corr_lookup import (
    corr_lookup_plain,
    fused_corr_lookup,
)


class CorrLookup(nn.Module):
    """Queries the cached candidates at the coordinate estimate through
    the voxel and kNN branches, projects each to 64 channels and sums.
    The lookup is the CUDA kernel when ``use_pallas`` resolves True for
    it, else its plain PyTorch version. ``mask`` (B, N) excludes padding
    rows from the head GroupNorms. The lookup runs in float32 at every
    compute dtype (its operands, ``CorrState`` and the coordinates, are
    float32); the heads' Denses run at ``cfg.compute_dtype``, so the
    result is in it. With a ``seq_group`` the lookup runs on this rank's
    rows and the head GroupNorms take the group's statistics."""

    def __init__(self, cfg: ModelConfig, seq_group: Any = None):
        super().__init__()
        self.cfg = cfg
        d = compute_dtype(cfg)
        n_vox = cfg.corr_levels * cfg.resolution**3
        self.out_conv1 = Dense(n_vox, 128, compute_dtype=d)
        self.out_gn = GroupNorm(128, seq_group=seq_group)
        self.out_prelu = PReLU()
        self.out_conv2 = Dense(128, 64, compute_dtype=d)
        self.knn_conv = Dense(4, 64, compute_dtype=d)
        self.knn_gn = GroupNorm(64, seq_group=seq_group)
        self.knn_prelu = PReLU()
        self.knn_out = Dense(64, 64, compute_dtype=d)

    def forward(self, state: CorrState, coords: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        kernel = resolve_use_pallas(cfg, coords, "corr_lookup")
        lookup = fused_corr_lookup if kernel else corr_lookup_plain
        vox, knn_corr, rel_xyz, _ = lookup(
            state.corr, state.xyz, coords, cfg.corr_levels, cfg.base_scale,
            cfg.resolution, cfg.corr_knn)

        v = self.out_prelu(self.out_gn(self.out_conv1(vox), mask))
        v = self.out_conv2(v)

        kf = torch.cat([knn_corr[..., None], rel_xyz], dim=-1)
        kf = self.knn_prelu(self.knn_gn(self.knn_conv(kf), mask))
        kf = self.knn_out(torch.amax(kf, dim=2))
        return v + kf
