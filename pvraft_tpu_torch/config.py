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
tensor, a CUDA kernel on a CUDA tensor: the tuned kernel where it takes
the configuration, else the general one
(``ops/cuda/__init__.py::kernel_takes``). The plain version runs on the
card only where the caller chose it (``use_pallas=False``).

``ModelConfig``'s memory levers run as in the JAX package:
``corr_chunk`` and ``graph_chunk`` stream the correlation truncation and
the kNN graph over chunks of the second cloud with a running top-k
(``ops/corr.py``, ``ops/geometry.py``), and ``remat``/``remat_policy``
checkpoint each GRU iteration (``models/raft.py``). ``approx_topk`` and
``approx_knn`` are accepted and compute the exact top-k: approx = exact
off the TPU. ``lax.approx_max_k`` has no PyTorch twin, and XLA computes
it exactly on a CPU or a GPU, so the exact ``torch.topk`` is what the
JAX package computes there; every error the knobs raise in JAX, they
raise here.

``ParallelConfig`` keeps the JAX fields. ``packed_state``,
``steps_per_dispatch`` and ``host_roundtrip`` drive the packed train
state and the K-step train graph (``engine/steps.py``);
``device_prefetch`` is the depth of the batches' copies in flight to the
device. ``donate`` is accepted and changes nothing: a captured graph
writes into its own buffers, so there is no input buffer to give away.
``data_axis`` is the data-parallel ranks (-1: every rank of the process
group; ``parallel/mesh.py::make_mesh`` holds it to the world size);
``seq_axis`` is the ranks each scene's points are sharded over, and
``ModelConfig.seq_shard`` makes a model on such a mesh sequence-parallel
(``parallel/ring.py``, ``models/raft.py``), stage 2's head included.

``ModelConfig.scan_unroll`` is accepted, so that configs shared with the
JAX package load, and changes nothing: the JAX package unrolls its
``nn.scan`` over the GRU iterations by it, and the result is the same for
every value; the port's iterations are a Python loop, which a captured
CUDA graph holds fully unrolled whatever the value. The train CLI
refuses ``--scan_unroll`` for that reason. ``TrainConfig.eval_scan`` is
accepted likewise and changes nothing: the JAX ``Evaluator`` scans S
scenes per dispatch to save dispatches, and a replay of the port's
captured eval step is one launch per batch already
(``engine/evaluator.py``). ``TrainConfig.strict_retrace`` makes a graphed step raise
``obs/retrace.py::RetraceError`` when it meets an input signature it has
not captured.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Tuple

import torch

from pvraft_tpu_torch.ops.cuda import kernel_takes

# The JAX package's remat policies (its config.py's REMAT_POLICIES),
# checkpointed in models/raft.py.
REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch", "save_corr")
# ModelConfig.compute_dtype -> the dtype of the model's Dense products and
# of the fused GRU update's arithmetic (``compute_dtype``).
COMPUTE_DTYPES = {"float32": torch.float32, "f32": torch.float32,
                  "bfloat16": torch.bfloat16}


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
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{tuple(COMPUTE_DTYPES)}, got "
                             f"{self.compute_dtype!r}")
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
            ("scatter_free_vjp", self.scatter_free_vjp,
             "its recorded disposition (ROADMAP queue 1 item 7): a "
             "TPU-motivated VJP whose forward equals the default path's"),
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


DATASETS = ("FT3D", "KITTI", "synthetic")
LR_SCHEDULES = ("parity", "cosine", "constant")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection and sampling (the JAX ``DataConfig``): ``root``
    of a preprocessed FT3D or KITTI tree, ``strict_sizes`` (the datasets'
    full scene counts), the loader's ``num_workers`` threads and
    ``native_loader`` (the C++ batch assembler for FT3D and KITTI, built
    at first use; where it cannot be built the loader raises, and
    ``native_loader=False`` takes the threaded numpy loader)."""

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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (the JAX ``TrainConfig``). ``telemetry``
    arms the in-step monitors and the divergence detector
    (``divergence_window``, ``divergence_zscore``; snapshots up to
    ``max_snapshots``; ``halt_on_divergence``); ``profile_dir`` profiles
    the first epoch (``engine/trainer.py``)."""

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
        if self.divergence_window < 2:
            raise ValueError(f"divergence_window must be >= 2, "
                             f"got {self.divergence_window}")
        if self.divergence_zscore < 0:
            raise ValueError(f"divergence_zscore must be >= 0 (0 disables), "
                             f"got {self.divergence_zscore}")
        reject_later(self, (
            ("ckpt_backend", self.ckpt_backend == "orbax",
             "its recorded disposition (ROADMAP queue 1 item 2): Orbax is "
             "not installed where the port runs, so the port writes and "
             "reads msgpack checkpoints only"),
        ))


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The JAX ``ParallelConfig``.

    ``packed_state``: the trained parameters and Adam's state live in one
    flat float32 buffer (``engine/steps.py::make_packed_train_step``).
    ``host_roundtrip`` (with ``packed_state``): that buffer goes to pinned
    host memory and back before each step, bitwise. ``steps_per_dispatch``
    K > 1 (with ``packed_state``): K train steps in one captured graph,
    the epoch's tail through the single packed step. ``device_prefetch``:
    batches whose copies to the device are in flight (1: none ahead).
    ``donate`` is accepted and changes nothing: a captured graph writes
    into its own buffers. ``data_axis``: the ranks of the data axis (-1:
    every rank; checked against the world size by ``make_mesh``);
    ``seq_axis``: the ranks of the sequence axis (each scene's points
    sharded over them, with ``ModelConfig.seq_shard``)."""

    data_axis: int = -1
    seq_axis: int = 1
    donate: bool = True
    packed_state: bool = False
    host_roundtrip: bool = False
    steps_per_dispatch: int = 1
    device_prefetch: int = 2

    def __post_init__(self):
        if self.host_roundtrip and not self.packed_state:
            raise ValueError("host_roundtrip requires packed_state (the "
                             "round trip moves the single flat state "
                             "buffer)")
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.steps_per_dispatch > 1 and not self.packed_state:
            raise ValueError("steps_per_dispatch > 1 requires packed_state "
                             "(the fused steps carry the single flat state "
                             "buffer)")
        if self.steps_per_dispatch > 1 and self.host_roundtrip:
            raise ValueError("steps_per_dispatch > 1 already removes the "
                             "per-step dispatches; host_roundtrip (a "
                             "per-step host sync) would put them back")


@dataclasses.dataclass(frozen=True)
class Config:
    """Model, data, training and parallel configuration: the
    JAX ``Config``. ``exp_path`` holds the run's checkpoints
    (``exp_path/checkpoints``)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    exp_path: str = "experiments/default"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def resolve_remat_policy(cfg: ModelConfig) -> Optional[str]:
    """The remat policy in force, or None for none: ``remat_policy`` where
    it is set, else "full" for the ``remat`` bool (the JAX
    ``resolve_remat_policy``)."""
    if cfg.remat_policy != "none":
        return cfg.remat_policy
    return "full" if cfg.remat else None


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.compute_dtype`` (the JAX
    ``config.compute_dtype``). Parameters stay float32 whatever it is:
    each Dense casts its input, kernel and bias to it where it runs, as
    flax's ``nn.Dense(dtype=...)`` does."""
    return COMPUTE_DTYPES[cfg.compute_dtype]


def resolve_use_pallas(cfg: ModelConfig, like: torch.Tensor,
                       kernel: str) -> bool:
    """Whether ``kernel`` ("corr_lookup", "voxel_corr" or "gru_iter")
    runs for ``like``'s device: ``use_pallas`` where it is set; ``None``
    means the plain version on a CPU tensor and the CUDA kernel on a CUDA
    tensor, tuned or general (``kernel_takes(cfg)[kernel]``)."""
    if kernel not in kernel_takes(cfg):
        raise KeyError(f"unknown kernel {kernel!r}")
    if cfg.use_pallas is not None:
        return cfg.use_pallas
    return bool(like.is_cuda)
