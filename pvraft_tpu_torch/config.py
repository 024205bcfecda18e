"""Model configuration of the port.

``ModelConfig`` keeps the field names, defaults and contradictory-option
rejections of the JAX package's ``ModelConfig``, so one dict of keyword
arguments builds both. Fields whose feature a later slice of the port
brings raise ``NotImplementedError`` at construction: a knob is never
silently ignored.

``use_pallas`` keeps its name. In the port it means "the hand-written
CUDA kernels" (``ops/cuda/``); ``None`` resolves per tensor: True on a
CUDA tensor, False on a CPU tensor (:func:`resolve_use_pallas`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch", "save_corr")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the PV-RAFT flagship model."""

    truncate_k: int = 512
    corr_levels: int = 3
    base_scale: float = 0.25
    resolution: int = 3
    corr_knn: int = 32

    graph_k: int = 32
    encoder_width: int = 32
    hidden_dim: int = 64
    context_dim: int = 64
    feature_dim: int = 128

    compute_dtype: str = "float32"
    use_pallas: Optional[bool] = None
    corr_chunk: Optional[int] = None
    remat: bool = False
    remat_policy: str = "none"
    scatter_free_vjp: bool = False
    fused_gru: bool = False
    approx_topk: bool = False
    scan_unroll: int = 1
    graph_chunk: Optional[int] = None
    approx_knn: bool = False
    seq_shard: bool = False

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {REMAT_POLICIES}, "
                f"got {self.remat_policy!r}"
            )
        if self.corr_knn > self.truncate_k:
            raise ValueError(
                f"corr_knn ({self.corr_knn}) must be <= truncate_k "
                f"({self.truncate_k}): the kNN branch selects among the "
                f"truncated correlation candidates"
            )
        if self.approx_topk and self.seq_shard:
            raise ValueError("approx_topk is not supported with seq_shard")
        if self.corr_chunk is not None and self.seq_shard:
            raise ValueError("corr_chunk is not supported with seq_shard")
        if self.approx_knn and self.graph_chunk is not None:
            raise ValueError("approx_knn is not supported with graph_chunk")
        if self.approx_knn and self.seq_shard:
            raise ValueError("approx_knn is not supported with seq_shard")
        # Knobs of features a later slice of the port brings.
        later = (
            ("corr_chunk", self.corr_chunk is not None,
             "the streaming correlation slice"),
            ("graph_chunk", self.graph_chunk is not None,
             "the streaming graph slice"),
            ("approx_topk", self.approx_topk, "the approximate top-k slice"),
            ("approx_knn", self.approx_knn, "the approximate top-k slice"),
            ("seq_shard", self.seq_shard, "the parallel slice"),
            ("remat", self.remat, "the training slice"),
            ("remat_policy", self.remat_policy != "none",
             "the training slice"),
            ("scatter_free_vjp", self.scatter_free_vjp,
             "the training slice"),
            ("compute_dtype", self.compute_dtype not in ("float32", "f32"),
             "the bf16 slice"),
            ("scan_unroll", self.scan_unroll != 1, "the CUDA-graph slice"),
        )
        for name, armed, where in later:
            if armed:
                raise NotImplementedError(
                    f"ModelConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet: it arrives with {where}"
                )


def resolve_use_pallas(cfg: ModelConfig, like: torch.Tensor) -> bool:
    """``use_pallas`` with the auto default resolved for ``like``'s
    device: ``None`` means the CUDA kernels on a CUDA tensor and the plain
    PyTorch path on a CPU tensor."""
    if cfg.use_pallas is None:
        return like.is_cuda
    return cfg.use_pallas
