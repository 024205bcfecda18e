"""Bucketed scene-flow inference engine (port of the device side of
``pvraft_tpu/serve/engine.py``).

Every request is padded up to the smallest bucket that holds it, with the
padding points on a far diagonal ray beyond ``ServeConfig.coord_limit``
so that a real point's kNN sets are the unpadded ones; boolean validity
masks exclude the padding from every GroupNorm statistic and from the
correlation truncation. Unused batch slots repeat request 0 (every model
op is batch-parallel). The stage-1 forward runs under
``torch.inference_mode()``, fp32.

Not in this slice: HTTP, the micro-batcher, replicas, CUDA-graph capture
and weight hot-swap.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.device import resolve_device
from pvraft_tpu_torch.models.raft import PVRaft
from pvraft_tpu_torch.weights import params_from_jax

SERVE_DEFAULT_BUCKETS = (2048, 4096, 8192)
SERVE_DEFAULT_BATCH_SIZES = (1, 4)
SERVE_DEFAULT_ITERS = 8


class RequestError(ValueError):
    """A request the engine cannot serve. ``reason`` is "too_large",
    "too_small" or "bad_request"."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs on top of the model architecture."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    buckets: Tuple[int, ...] = SERVE_DEFAULT_BUCKETS
    batch_sizes: Tuple[int, ...] = SERVE_DEFAULT_BATCH_SIZES
    num_iters: int = SERVE_DEFAULT_ITERS
    refine: bool = False
    coord_limit: float = 100.0
    dtype: str = "float32"
    replicas: int = 1

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("at least one bucket is required")
        if tuple(sorted(set(self.buckets))) != tuple(self.buckets):
            raise ValueError(
                f"buckets must be ascending and distinct, got {self.buckets}")
        if not self.batch_sizes:
            raise ValueError("at least one batch size is required")
        if tuple(sorted(set(self.batch_sizes))) != tuple(self.batch_sizes):
            raise ValueError(
                f"batch_sizes must be ascending and distinct, "
                f"got {self.batch_sizes}")
        if self.buckets[0] < self.min_points:
            raise ValueError(
                f"smallest bucket ({self.buckets[0]}) is below min_points "
                f"({self.min_points}): it could never hold a valid request")
        if self.coord_limit <= 0:
            raise ValueError("coord_limit must be positive")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', "
                             f"got {self.dtype!r}")
        if self.dtype != "float32":
            raise NotImplementedError(
                "ServeConfig.dtype='bfloat16' is not ported yet: it arrives "
                "with the bf16 slice; this slice serves float32")
        if self.refine:
            raise NotImplementedError(
                "ServeConfig.refine is not ported yet: it arrives with the "
                "stage-2 slice")
        if self.replicas != 1:
            raise NotImplementedError(
                "ServeConfig.replicas != 1 is not ported yet: it arrives "
                "with the serving-tier slice")

    @property
    def min_points(self) -> int:
        """Smallest request the masked model serves exactly."""
        return max(self.model.truncate_k, self.model.graph_k + 1)

    @property
    def max_points(self) -> int:
        return self.buckets[-1]


def pad_points(pc: np.ndarray, bucket: int, coord_limit: float) -> np.ndarray:
    """Pad an (n, 3) cloud to (bucket, 3) with points on a diagonal ray at
    100x the coordinate limit, unit spacing: far from every real point and
    distinct from each other."""
    n = pc.shape[0]
    if n == bucket:
        return np.ascontiguousarray(pc, dtype=np.float32)
    base = 100.0 * coord_limit
    ray = base + np.arange(bucket - n, dtype=np.float32)
    pad = np.repeat(ray[:, None], 3, axis=1)
    return np.concatenate([np.asarray(pc, np.float32), pad], axis=0)


class InferenceEngine:
    """Weights -> a stage-1 PVRaft on ``device`` serving padded buckets.

    ``weights`` is a port state_dict (flat mapping of tensors) or the JAX
    package's flax params tree (nested mapping, mapped by
    :func:`params_from_jax`); either loads with ``strict=True``.
    """

    def __init__(self, weights: Mapping, cfg: ServeConfig,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if any(isinstance(v, Mapping) for v in weights.values()):
            weights = params_from_jax(weights)
        model_cfg = dataclasses.replace(cfg.model, compute_dtype=cfg.dtype)
        self.model = PVRaft(model_cfg)
        self.model.load_state_dict(weights, strict=True)
        self.model.to(self.device).eval()

    def bucket_for(self, n_points: int) -> Optional[int]:
        """Smallest bucket holding ``n_points``, or None if too large."""
        for b in self.cfg.buckets:
            if n_points <= b:
                return b
        return None

    def batch_size_for(self, n_requests: int) -> int:
        """Smallest batch size >= n_requests (the largest if none is)."""
        for bs in self.cfg.batch_sizes:
            if n_requests <= bs:
                return bs
        return self.cfg.batch_sizes[-1]

    def validate_request(self, pc1: np.ndarray, pc2: np.ndarray) -> int:
        """Check one request against the serve contract; returns its
        bucket. Raises :class:`RequestError`."""
        for name, pc in (("pc1", pc1), ("pc2", pc2)):
            pc = np.asarray(pc)
            if pc.ndim != 2 or pc.shape[1] != 3:
                raise RequestError(
                    "bad_request", f"{name} must be (n, 3), got {pc.shape}")
            if not np.all(np.isfinite(pc)):
                raise RequestError(
                    "bad_request", f"{name} contains non-finite values")
            if np.abs(pc).max(initial=0.0) >= self.cfg.coord_limit:
                raise RequestError(
                    "bad_request",
                    f"{name} coordinates must satisfy |x| < "
                    f"{self.cfg.coord_limit}")
            if pc.shape[0] < self.cfg.min_points:
                raise RequestError(
                    "too_small",
                    f"{name} has {pc.shape[0]} points; the masked model "
                    f"needs >= {self.cfg.min_points} real points per cloud")
        n = max(np.shape(pc1)[0], np.shape(pc2)[0])
        bucket = self.bucket_for(n)
        if bucket is None:
            raise RequestError(
                "too_large", f"request has {n} points; largest bucket is "
                f"{self.cfg.buckets[-1]}")
        return bucket

    def predict_batch(self, requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                      bucket: int) -> List[np.ndarray]:
        """Run a group of validated same-bucket requests as one batch;
        returns each request's un-padded (n1, 3) flow."""
        if not requests:
            return []
        bs = self.batch_size_for(len(requests))
        if len(requests) > bs:
            raise ValueError(
                f"{len(requests)} requests exceed the largest batch size "
                f"{bs}; split the group first")
        cl = self.cfg.coord_limit
        rows1, rows2, v1, v2 = [], [], [], []
        for pc1, pc2 in requests:
            rows1.append(pad_points(np.asarray(pc1, np.float32), bucket, cl))
            rows2.append(pad_points(np.asarray(pc2, np.float32), bucket, cl))
            m1 = np.zeros(bucket, bool)
            m1[: pc1.shape[0]] = True
            m2 = np.zeros(bucket, bool)
            m2[: pc2.shape[0]] = True
            v1.append(m1)
            v2.append(m2)
        for _ in range(bs - len(requests)):          # fill: repeat slot 0
            rows1.append(rows1[0])
            rows2.append(rows2[0])
            v1.append(v1[0])
            v2.append(v2[0])

        def put(arrays):
            return torch.from_numpy(np.stack(arrays)).to(self.device)

        with torch.inference_mode():
            flows, _ = self.model(put(rows1), put(rows2), self.cfg.num_iters,
                                  put(v1), put(v2))
            flow = flows[-1].cpu().numpy()
        return [flow[i, : requests[i][0].shape[0]]
                for i in range(len(requests))]

    def predict(self, pc1: np.ndarray, pc2: np.ndarray) -> np.ndarray:
        """Validate one request, pad it to its bucket, run it at batch
        size ``batch_size_for(1)``, un-pad."""
        pc1 = np.asarray(pc1, np.float32)
        pc2 = np.asarray(pc2, np.float32)
        bucket = self.validate_request(pc1, pc2)
        return self.predict_batch([(pc1, pc2)], bucket)[0]
