"""Bucketed scene-flow inference engine (port of the device side of
``pvraft_tpu/serve/engine.py``).

Every request is padded up to the smallest bucket that holds it, with the
padding points on a far diagonal ray beyond ``ServeConfig.coord_limit``
so that a real point's kNN sets are the unpadded ones; boolean validity
masks exclude the padding from every GroupNorm statistic and from the
correlation truncation. Unused batch slots repeat request 0 (every model
op is batch-parallel). The forward runs without autograd at the serving
dtype ``ServeConfig.dtype``, which overrides the model's
``compute_dtype`` as in the JAX engine: bfloat16 by default (the JAX
package's ``SERVE_DEFAULT_DTYPE``), float32 one argument away; the flow
is float32 either way. It returns stage 1's last flow, or with
``ServeConfig.refine`` a ``PVRaftRefine``'s refined flow, the validity
mask reaching the head's GroupNorms too.

Each replica captures the whole (bucket, batch size) table at
construction (the JAX ``_compile``): one
:class:`~pvraft_tpu_torch.serve.aot.GraphProgram` per entry, named by
:func:`~pvraft_tpu_torch.serve.aot.predict_program_name`, all in the
replica's memory pool; :meth:`InferenceEngine.compile_report` lists
replica 0's. A request copies its padded clouds and masks into the
program's static inputs, every slot included, replays the graph, and
copies the flow out. On the CPU the programs run the forward on the same
static buffers without a graph.

Replica pool (the JAX ``Replica`` and pool): one :class:`Replica` per
device, each with its own model copy, its own captured (bucket, batch)
table in its own graph pool, and its own lock. ``ServeConfig.replicas=0``
(the default) means one replica per CUDA device, replica ``i`` on
``cuda:i``; on the CPU, which only a caller that asks for it gets,
``replicas=n`` builds ``n`` replicas (0 means 1). Replicas capture one
after another. A replica's static inputs, outputs and graph pool admit
one program run at a time, so its lock covers copy-in, replay and
copy-out; host-side padding runs outside it. The micro-batcher
(``serve/batcher.py``) work-steals formed batches across the pool;
:meth:`InferenceEngine.predict_batch` runs on replica 0, as in JAX.

Weight hot-swap without recapture (:meth:`InferenceEngine.swap_params`)
is where the port differs from JAX. There the programs take the
parameters as a call argument, and a swap replaces each replica's
pointer and waits for the dispatches still holding the old one. Here
the captured graphs read the parameter tensors in place, so a swap
takes each replica's lock (that is the drain: the replay in flight
finishes first), ``copy_``s the new values into the same tensors, and
releases it. Nothing is captured again, so the program table, its
capture count and its pool bytes stay as they were, and a replay never
reads half-swapped weights.

:meth:`InferenceEngine.from_checkpoint` and
:meth:`InferenceEngine.reload_checkpoint` read msgpack checkpoints (the
port's or the JAX package's, ``engine/checkpoint.py::load_params``);
:meth:`InferenceEngine.weights_info` reports the path, the epoch, the
content digest (:func:`params_digest`, the JAX package's on the same
weights) and the swap count.

With a ``telemetry`` sink (``serve/events.py::ServeTelemetry``) the
engine writes one ``serve_compile`` record per captured program of each
replica and one ``weight_swap`` record per swap, after the swap's locks
are released.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.device import resolve_device
from pvraft_tpu_torch.engine.checkpoint import load_params
from pvraft_tpu_torch.models.raft import PVRaft, PVRaftRefine
from pvraft_tpu_torch.rng import DEFAULT_SEED, host_rng
from pvraft_tpu_torch.serve.aot import (
    GraphProgram,
    capture,
    predict_program_name,
)
from pvraft_tpu_torch.weights import params_from_jax, params_to_jax

SERVE_DEFAULT_BUCKETS = (2048, 4096, 8192)
SERVE_DEFAULT_BATCH_SIZES = (1, 4)
SERVE_DEFAULT_ITERS = 8
# The JAX package's default serving dtype, and the bound its bf16 flows
# keep against float32 on the same parameters (mean endpoint error, and
# that relative to the mean float32 flow magnitude;
# pvraft_tpu/programs/geometries.py, tests/test_serve_pool.py).
SERVE_DEFAULT_DTYPE = "bfloat16"
SERVE_BF16_EPE_BOUND = 0.13
SERVE_BF16_REL_EPE_BOUND = 0.15
# One replica per device (pvraft_tpu/programs/geometries.py).
SERVE_DEFAULT_REPLICAS = 0


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
    dtype: str = SERVE_DEFAULT_DTYPE
    # 0: one replica per CUDA device (on the CPU: one replica).
    replicas: int = SERVE_DEFAULT_REPLICAS

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
        if self.replicas < 0:
            raise ValueError("replicas must be >= 0 (0 = every CUDA device)")

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


def state_dict_of(weights: Mapping) -> Mapping[str, torch.Tensor]:
    """A port state_dict from ``weights``: itself, or a JAX flax params
    tree (nested mapping) through :func:`params_from_jax`."""
    if any(isinstance(v, Mapping) for v in weights.values()):
        return params_from_jax(weights)
    return weights


def _treedef_repr(node: Any) -> str:
    """``repr`` of the jax treedef of a tree of nested dicts: the dicts in
    sorted key order, ``*`` at each leaf."""
    if isinstance(node, Mapping):
        return "{" + ", ".join(f"{k!r}: {_treedef_repr(node[k])}"
                               for k in sorted(node)) + "}"
    return "*"


def _leaves(node: Any):
    if isinstance(node, Mapping):
        for k in sorted(node):
            yield from _leaves(node[k])
    else:
        yield node


def params_digest(weights: Mapping) -> str:
    """Content fingerprint of a set of weights (a port state_dict or a
    flax params tree): the JAX package's ``params_digest`` on the same
    weights. sha256 over the flax tree's treedef repr, then each leaf's
    dtype, shape and bytes in sorted-key order, cut to 16 hex digits, so
    hosts of both packages report one digest per set of weights."""
    tree = params_to_jax(state_dict_of(weights))
    h = hashlib.sha256()
    h.update(f"PyTreeDef({_treedef_repr(tree)})".encode())
    for leaf in _leaves(tree):
        arr = np.asarray(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


def replica_devices(device: torch.device, replicas: int
                    ) -> List[torch.device]:
    """The device of each replica: on CUDA, ``cuda:i`` for replica ``i``
    (0 replicas: every CUDA device; more than there are raises), or the
    named device when one replica is asked for on an indexed device; on
    any other device ``replicas`` copies of it (0 means 1)."""
    if device.type != "cuda":
        return [device] * (replicas or 1)
    count = torch.cuda.device_count()
    n = replicas or count
    if n > count:
        raise ValueError(f"replicas={n} exceeds the {count} CUDA devices "
                         f"(one replica per device)")
    if n == 1 and device.index is not None:
        return [device]
    return [torch.device("cuda", i) for i in range(n)]


def _on(device: torch.device):
    """The CUDA device context of ``device`` (captures and replays run on
    the current device), or nothing on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def predict_fn(model: torch.nn.Module, num_iters: int, refine: bool):
    """The function a replica captures per (bucket, batch size): padded
    clouds and validity masks in, without autograd, the last flow (or a
    PVRaftRefine's refined flow) out, as a 1-tuple."""

    def forward(xyz1, xyz2, valid1, valid2):
        with torch.no_grad():
            out = model(xyz1, xyz2, num_iters, valid1, valid2)
        return (out if refine else out[0][-1],)

    return forward


def warmup_inputs(bucket: int, bs: int) -> Tuple[torch.Tensor, ...]:
    """The capture's warm-up inputs at (bs, bucket): seeded clouds inside
    the coordinate limit, every point valid."""
    # Their values reach no output; the card's replay-vs-eager checks
    # were recorded on these clouds.
    # graftlint: disable-next=GD002 -- warm-up inputs of a capture
    gen = torch.Generator().manual_seed(bucket * 16 + bs)
    cloud = torch.rand(bs, bucket, 3, generator=gen) * 2 - 1
    valid = torch.ones(bs, bucket, dtype=torch.bool)
    return cloud, cloud.flip(1), valid, valid


class Replica:
    """One device's executor: its own model copy, captured (bucket,
    batch) table and graph pool, and the lock that admits one program
    run at a time (copy-in, replay, copy-out)."""

    def __init__(self, index: int, device: torch.device,
                 engine: "InferenceEngine",
                 state: Mapping[str, torch.Tensor]):
        self.index = index
        self.device = device
        self.device_id = device.index if device.index is not None else index
        self.engine = engine
        cfg = engine.cfg
        model_cfg = dataclasses.replace(cfg.model, compute_dtype=cfg.dtype)
        self.model = (PVRaftRefine if cfg.refine else PVRaft)(model_cfg)
        self.model.load_state_dict(state, strict=True)
        self.model.to(device).eval()
        self._lock = ordered_lock("Replica._lock")
        # What swap_params reads to count the runs it waited for; written
        # inside _lock, read by a swap that does not hold it.
        self._count_lock = ordered_lock("Replica._count_lock")
        self._runs = 0            # guarded-by: _count_lock
        self._running = False     # guarded-by: _count_lock
        self.programs: Dict[Tuple[int, int], GraphProgram] = {}
        with _on(device):
            pool = (torch.cuda.graph_pool_handle()
                    if device.type == "cuda" else None)
            for bucket in cfg.buckets:
                for bs in cfg.batch_sizes:
                    program = self.programs[(bucket, bs)] = self._compile(
                        bucket, bs, pool)
                    self._emit_compile(bucket, bs, program)

    def _emit_compile(self, bucket: int, bs: int,
                      program: GraphProgram) -> None:
        telemetry = self.engine.telemetry
        if telemetry is None:
            return
        rec = program.report()
        telemetry.emit_compile(
            bucket=bucket, batch=bs, lower_s=rec["warmup_s"],
            compile_s=rec["capture_s"],
            memory={"pool_bytes": rec["pool_bytes"]},
            dtype=self.engine.cfg.dtype, replica=self.index,
            device_id=self.device_id)

    def _compile(self, bucket: int, bs: int, pool) -> GraphProgram:
        """Capture :func:`predict_fn` at (bs, bucket), warmed up on
        :func:`warmup_inputs`."""
        cfg = self.engine.cfg
        return capture(predict_program_name(bucket, bs, cfg.dtype),
                       predict_fn(self.model, cfg.num_iters, cfg.refine),
                       warmup_inputs(bucket, bs), self.device, pool)

    def predict_batch(self, requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                      bucket: int) -> List[np.ndarray]:
        """Run a group of validated same-bucket requests as one batch on
        this replica; returns each request's un-padded (n1, 3) flow."""
        if not requests:
            return []
        inputs = self.engine.padded_batch(requests, bucket)
        program = self.programs[(bucket, inputs[0].shape[0])]
        # Every slot of every static input is overwritten, and the flow
        # is copied to the host before the lock lets the next run (or a
        # swap) in.
        with self._lock, _on(self.device):
            with self._count_lock:
                self._runs += 1
                self._running = True
            try:
                flow, = program(*(torch.from_numpy(a) for a in inputs))
                flow = flow.to("cpu", copy=True).numpy()
            finally:
                with self._count_lock:
                    self._running = False
        return [flow[i, : requests[i][0].shape[0]]
                for i in range(len(requests))]

    def swap_params(self, state: Mapping[str, torch.Tensor],
                    drain_timeout_s: float = 30.0) -> Tuple[int, bool]:
        """Copy ``state`` into this replica's parameter tensors, in place,
        under its lock: the run in flight, and any that took the lock
        before the swap did, finish on the old values first. Returns
        ``(runs waited for, lock taken within drain_timeout_s)``; past the
        timeout the copy still waits for the lock (a replay never reads
        torn weights). The fused GRU packs its weights inside the forward
        (``models/update.py``), so the copy reaches kernels 2 and 2b."""
        with self._count_lock:
            runs, running = self._runs, self._running
        in_time = self._lock.acquire(timeout=max(drain_timeout_s, 0.0))
        if not in_time:
            self._lock.acquire()
        try:
            with self._count_lock:
                waited = self._runs - runs + int(running)
            with torch.no_grad(), _on(self.device):
                for name, t in self.model.state_dict().items():
                    t.copy_(state[name])
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            self._lock.release()
        return waited, in_time


class InferenceEngine:
    """Weights -> a pool of replicas, each a PVRaft (``cfg.refine``: a
    PVRaftRefine) on its device serving padded buckets.

    ``weights`` is a port state_dict (flat mapping of tensors) or the JAX
    package's flax params tree (nested mapping, mapped by
    :func:`params_from_jax`); either loads with ``strict=True``. The
    constructor captures every (bucket, batch size) program of every
    replica; a failed capture raises. Thread-safe: each replica's lock
    admits one program run at a time (module docstring). ``telemetry``
    receives the ``serve_compile`` and ``weight_swap`` records.
    """

    def __init__(self, weights: Mapping, cfg: ServeConfig,
                 device: Union[str, torch.device, None] = None,
                 telemetry=None):
        self.cfg = cfg
        self.telemetry = telemetry
        state = state_dict_of(weights)
        devices = replica_devices(resolve_device(device), cfg.replicas)
        # Weights provenance (the /healthz weights block): checkpoint
        # path (None: in-memory weights), content digest, epoch (-1: none)
        # and swap count. One swap at a time, behind _swap_lock.
        self._swap_lock = ordered_lock("InferenceEngine._swap_lock")
        self._weights: Dict[str, Any] = {
            "path": None, "digest": params_digest(state), "epoch": -1,
            "swaps": 0}  # guarded-by: _swap_lock
        self.replicas = [Replica(i, d, self, state)
                         for i, d in enumerate(devices)]

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ServeConfig,
                        device: Union[str, torch.device, None] = None,
                        telemetry=None) -> "InferenceEngine":
        """An engine serving the parameters of the msgpack checkpoint at
        ``path`` (``engine/checkpoint.py::load_params``); keeps ``path``
        and the checkpoint's epoch (-1 when it has none) as its weights
        provenance."""
        variables, epoch = load_params(path)
        engine = cls(variables, cfg, device, telemetry=telemetry)
        with engine._swap_lock:
            engine._weights["path"] = path
            engine._weights["epoch"] = int(epoch)
        return engine

    # Replica 0 stands for the engine where one model is meant (the
    # eager forward the replays are held against, the program table).
    @property
    def model(self) -> torch.nn.Module:
        return self.replicas[0].model

    @property
    def device(self) -> torch.device:
        return self.replicas[0].device

    @property
    def platform(self) -> str:
        """The pool's platform in the JAX package's words: "gpu" on CUDA
        devices, else the device type ("cpu")."""
        kind = self.device.type
        return "gpu" if kind == "cuda" else kind

    @property
    def checkpoint_path(self) -> Optional[str]:
        return self.weights_info()["path"]

    @property
    def checkpoint_epoch(self) -> int:
        return self.weights_info()["epoch"]

    def compile_report(self) -> List[Dict[str, Any]]:
        """Replica 0's programs' records (``GraphProgram.report``), in
        table order."""
        return [p.report() for p in self.replicas[0].programs.values()]

    def program(self, bucket: int, bs: int) -> GraphProgram:
        return self.replicas[0].programs[(bucket, bs)]

    def weights_info(self) -> Dict[str, Any]:
        """The /healthz weights block: path, digest, epoch, swaps."""
        with self._swap_lock:
            return dict(self._weights)

    def _check_swap(self, weights: Mapping) -> Mapping[str, torch.Tensor]:
        """``weights`` as a state_dict with the served keys, shapes and
        dtypes; anything else would need another capture, and raises."""
        try:
            state = state_dict_of(weights)
        except KeyError as e:
            raise ValueError(f"swap rejected: {e} (a hot-swap must never "
                             f"recapture)") from None
        served = self.model.state_dict()
        if set(state) != set(served):
            missing = sorted(set(served) - set(state))[:3]
            extra = sorted(set(state) - set(served))[:3]
            raise ValueError(
                f"swap rejected: the weights' keys differ from the served "
                f"state_dict (missing {missing}, unexpected {extra}; a "
                f"hot-swap must never recapture)")
        for name, t in served.items():
            new = torch.as_tensor(state[name])
            if new.shape != t.shape or new.dtype != t.dtype:
                raise ValueError(
                    f"swap rejected: {name} is {new.dtype}{list(new.shape)},"
                    f" the captured programs read {t.dtype}{list(t.shape)} "
                    f"(a hot-swap must never recapture)")
        return state

    def swap_params(self, weights: Mapping, path: Optional[str] = None,
                    epoch: int = -1,
                    drain_timeout_s: float = 30.0) -> Dict[str, Any]:
        """Weight hot-swap without recapture: check ``weights`` (a port
        state_dict or a flax params tree) against the served state_dict,
        then copy them into every replica's parameter tensors under that
        replica's lock (:meth:`Replica.swap_params`). Returns the JAX
        package's swap report: digest, previous digest, epoch, path,
        replicas, the runs the swap waited for (``drained``), whether
        every lock came within ``drain_timeout_s``, and ``swap_ms``."""
        state = self._check_swap(weights)
        t0 = time.monotonic()
        digest = params_digest(state)
        drained, all_in_time = 0, True
        with self._swap_lock:
            for replica in self.replicas:
                waited, in_time = replica.swap_params(state, drain_timeout_s)
                drained += waited
                all_in_time = all_in_time and in_time
            previous = self._weights["digest"]
            self._weights = {"path": path, "digest": digest,
                             "epoch": int(epoch),
                             "swaps": self._weights["swaps"] + 1}
        report = {"digest": digest, "previous_digest": previous,
                  "epoch": int(epoch), "path": path,
                  "replicas": len(self.replicas), "drained": drained,
                  "drained_in_time": all_in_time,
                  "swap_ms": round(1e3 * (time.monotonic() - t0), 3)}
        if self.telemetry is not None:
            self.telemetry.emit_weight_swap(
                digest=digest, epoch=int(epoch), path=path,
                previous_digest=previous, replicas=len(self.replicas),
                swap_ms=report["swap_ms"], drained=drained)
        return report

    def reload_checkpoint(self, path: str,
                          drain_timeout_s: float = 30.0) -> Dict[str, Any]:
        """``POST /admin/reload``: load a msgpack checkpoint and hot-swap
        it into the pool."""
        variables, epoch = load_params(path)
        return self.swap_params(variables, path=path, epoch=int(epoch),
                                drain_timeout_s=drain_timeout_s)

    def probe_request(self) -> Tuple[np.ndarray, int]:
        """The supervisor's health-probe payload: the JAX package's
        ``min_points`` cloud (``host_rng(DEFAULT_SEED, "serve.probe")``)
        inside the coordinate limit, for the smallest bucket."""
        rng = host_rng(DEFAULT_SEED, "serve.probe")
        scale = min(1.0, 0.5 * self.cfg.coord_limit)
        cloud = rng.uniform(
            -scale, scale,
            (max(self.cfg.min_points, 1), 3)).astype(np.float32)
        return cloud, self.cfg.buckets[0]

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

    def padded_batch(self, requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                     bucket: int) -> Tuple[np.ndarray, ...]:
        """A group of validated same-bucket requests as the program's
        inputs at ``batch_size_for(len(requests))``: padded pc1 and pc2
        (bs, bucket, 3) f32 and their (bs, bucket) validity masks, fill
        slots repeating request 0."""
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
        return tuple(np.stack(a) for a in (rows1, rows2, v1, v2))

    def predict_batch(self, requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                      bucket: int) -> List[np.ndarray]:
        """Run a group of validated same-bucket requests as one batch on
        replica 0 (the direct path; the batcher uses the whole pool);
        returns each request's un-padded (n1, 3) flow."""
        return self.replicas[0].predict_batch(requests, bucket)

    def predict(self, pc1: np.ndarray, pc2: np.ndarray) -> np.ndarray:
        """Validate one request, pad it to its bucket, run it at batch
        size ``batch_size_for(1)``, un-pad."""
        pc1 = np.asarray(pc1, np.float32)
        pc2 = np.asarray(pc2, np.float32)
        bucket = self.validate_request(pc1, pc2)
        return self.predict_batch([(pc1, pc2)], bucket)[0]
