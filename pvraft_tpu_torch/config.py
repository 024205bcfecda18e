"""Configuration of the port.

``ModelConfig``, ``DataConfig``, ``TrainConfig`` and ``Config`` keep the
field names, defaults and contradictory-option rejections of the JAX
package's dataclasses, so one dict of keyword arguments builds both.
Fields whose feature a later slice of the port brings raise
``NotImplementedError`` at construction when set to anything but their
default: a knob is never silently ignored.

``use_pallas`` keeps its name. In the port it means "the hand-written
CUDA kernels" (``ops/cuda/``); ``None`` resolves per tensor and per
kernel (:func:`resolve_use_pallas`): the plain PyTorch version on a CPU
tensor, the kernel on a CUDA tensor. A configuration that a kernel does
not take (``ops/cuda/__init__.py::kernel_takes``) raises on a CUDA
tensor and names ``use_pallas=False``: the plain version runs on the
card only where the caller chose it.

``ModelConfig.scan_unroll`` is accepted, so that configs shared with the
JAX package load, and changes nothing: the JAX package unrolls its
``nn.scan`` over the GRU iterations by it, and the result is the same for
every value; the port's iterations are a Python loop, which a captured
CUDA graph holds fully unrolled whatever the value. The train CLI
refuses ``--scan_unroll`` for that reason. ``TrainConfig.strict_retrace`` makes a graphed step raise
``obs/retrace.py::RetraceError`` when it meets an input signature it has
not captured.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Tuple

import torch

from pvraft_tpu_torch.ops.cuda import kernel_takes

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
            ("remat", self.remat, "the memory levers (torch.utils."
             "checkpoint), ROADMAP queue 1 item 7"),
            ("remat_policy", self.remat_policy != "none",
             "the memory levers (torch.utils.checkpoint), ROADMAP queue 1 "
             "item 7"),
            ("scatter_free_vjp", self.scatter_free_vjp,
             "its recorded disposition (ROADMAP queue 1 item 7): a "
             "TPU-motivated VJP whose forward equals the default path's"),
            ("compute_dtype", self.compute_dtype not in ("float32", "f32"),
             "the bf16 slice"),
        )
        reject_later(self, later)


def reject_later(cfg: Any, later: Iterable[Tuple[str, bool, str]]) -> None:
    """Raise ``NotImplementedError`` for the first armed ``(field, armed,
    slice)`` row: the field's feature arrives with that slice."""
    for name, armed, where in later:
        if armed:
            raise NotImplementedError(
                f"{type(cfg).__name__}.{name}={getattr(cfg, name)!r} is not "
                f"ported yet: it arrives with {where}"
            )


def non_default(cfg: Any, names: Iterable[str], where: str):
    """``(field, armed, slice)`` rows arming every named field of ``cfg``
    whose value differs from its default."""
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    return [(n, getattr(cfg, n) != defaults[n], where) for n in names]


DATASETS = ("FT3D", "KITTI", "synthetic")
LR_SCHEDULES = ("parity", "cosine", "constant")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection and sampling (the JAX ``DataConfig``). This slice
    trains on ``synthetic`` scenes only; FT3D and KITTI raise when the
    trainer builds its datasets."""

    dataset: str = "FT3D"
    root: str = ""
    max_points: int = 8192
    num_workers: int = 8
    synthetic_size: int = 64
    synthetic_objects: int = 1
    native_loader: bool = True
    strict_sizes: bool = True

    def __post_init__(self):
        if self.dataset not in DATASETS:
            raise ValueError(f"dataset must be one of {DATASETS}, "
                             f"got {self.dataset!r}")
        reject_later(self, non_default(
            self, ("root", "num_workers", "native_loader", "strict_sizes"),
            "the data slice (FT3D, KITTI, PrefetchLoader, the native "
            "assembler); this slice loads synthetic scenes serially"))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (the JAX ``TrainConfig``)."""

    batch_size: int = 2
    num_epochs: int = 20
    lr: float = 1e-3
    gamma: float = 0.8
    iters: int = 8
    eval_iters: int = 32
    eval_batch: int = 0
    eval_scan: int = 1
    checkpoint_interval: int = 5
    ckpt_backend: str = "msgpack"
    refine: bool = False
    seed: int = 0
    lr_schedule: str = "parity"
    profile_dir: str = ""
    grad_dtype: str = "float32"
    telemetry: bool = False
    divergence_window: int = 64
    divergence_zscore: float = 6.0
    max_snapshots: int = 3
    halt_on_divergence: bool = False
    strict_retrace: bool = False

    def __post_init__(self):
        if self.ckpt_backend not in ("msgpack", "orbax"):
            raise ValueError(f"ckpt_backend must be 'msgpack' or 'orbax', "
                             f"got {self.ckpt_backend!r}")
        if self.grad_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"grad_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.grad_dtype!r}")
        if self.lr_schedule not in LR_SCHEDULES:
            raise ValueError(f"lr_schedule must be one of {LR_SCHEDULES}, "
                             f"got {self.lr_schedule!r}")
        later = [
            # One card evaluates one scene per step: 0 (one scene per
            # data device) and 1 are the same here.
            ("eval_batch", self.eval_batch not in (0, 1),
             "the parallel slice"),
            ("refine", self.refine, "the stage-2 slice"),
            ("grad_dtype", self.grad_dtype != "float32", "the bf16 slice"),
            ("eval_scan", self.eval_scan != 1,
             "the evaluator (ROADMAP queue 1 item 2)"),
        ]
        later += non_default(self, ("checkpoint_interval", "ckpt_backend"),
                             "the trainer slice (checkpoints and resume)")
        later += non_default(
            self, ("profile_dir", "telemetry", "divergence_window",
                   "divergence_zscore", "max_snapshots",
                   "halt_on_divergence"),
            "the observability slice")
        reject_later(self, later)


@dataclasses.dataclass(frozen=True)
class Config:
    """Model, data and training configuration (the JAX ``Config`` without
    its ``parallel`` part, which arrives with the parallel slice)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    exp_path: str = "experiments/default"

    def __post_init__(self):
        reject_later(self, non_default(
            self, ("exp_path",),
            "the trainer slice (checkpoints, logs and TensorBoard)"))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def resolve_use_pallas(cfg: ModelConfig, like: torch.Tensor,
                       kernel: str) -> bool:
    """Whether ``kernel`` ("corr_lookup", "voxel_corr" or "gru_iter")
    runs for ``like``'s device: ``use_pallas`` where it is set (True on a
    configuration the kernel does not take raises in the kernel's
    wrapper); ``None`` means the plain version on a CPU tensor and the
    CUDA kernel on a CUDA tensor, where a configuration the kernel does
    not take (``kernel_takes``) raises."""
    if cfg.use_pallas is not None:
        return cfg.use_pallas
    if not like.is_cuda:
        return False
    if not kernel_takes(cfg)[kernel]:
        raise ValueError(
            f"the CUDA kernel {kernel} does not take this configuration "
            f"(truncate_k={cfg.truncate_k}, corr_knn={cfg.corr_knn}, "
            f"resolution={cfg.resolution}, hidden_dim={cfg.hidden_dim}, "
            f"context_dim={cfg.context_dim}; ops/cuda/__init__.py::"
            f"kernel_takes); set use_pallas=False to run its plain PyTorch "
            f"version on the card")
    return True
