"""Structured run events: the ``pvraft_events/v1`` JSONL schema (port of
``pvraft_tpu/obs/events.py``; the schema, its event types, field names
and rules are the JAX package's, so one operator's tools read the
streams of both).

One stream is an append-only JSONL file whose first record is a
``run_header`` followed by typed events; every record carries
``{"schema": "pvraft_events/v1", "type", "time", "seq"}`` and the fields
of its type (:data:`EVENT_TYPES`: required, then optional).
:class:`EventLog` stamps ``seq``, validates every record as it is
emitted and writes non-finite floats as the strings ``"NaN"``,
``"Infinity"``, ``"-Infinity"`` (:func:`sanitize`), which the validator
accepts wherever a number is required.

The serving tier (``serve/events.py::ServeTelemetry``) writes
``serve_compile``, ``serve_batch``, ``serve_reject``, ``serve_shutdown``,
``span``, ``trace_window``, ``recompile``, ``device_memory``,
``replica_state``, ``fault_injected`` and ``weight_swap``; the Trainer
and the Evaluator write theirs through :class:`RunTelemetry`
(``run_header``, ``step``, ``epoch_summary``, ``eval``, ``checkpoint``,
``trace_window``, ``divergence``, ``snapshot``, ``span``, ``recompile``,
``device_memory``); the other types are validated too, so a stream of
either package checks here.

:func:`run_metadata` describes the process in the JAX package's words:
``devices.platform`` is ``"gpu"`` on a CUDA device (JAX's name for an
NVIDIA device) and ``"cpu"`` otherwise; ``versions`` is
``{"torch", "cuda"}``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, IO, List, Optional

from pvraft_tpu_torch.parallel.distributed import process_count, process_index

SCHEMA_VERSION = "pvraft_events/v1"

# type -> (required fields, optional fields); the base fields are stamped
# by EventLog and required on every record.
EVENT_TYPES: Dict[str, tuple] = {
    "run_header": (
        ("run_id", "mode", "config", "git", "devices", "versions"), ()),
    "step": (("epoch", "step", "loss", "epe"), ("telemetry",)),
    "epoch_summary": (("epoch", "steps"),
                      ("loss", "epe", "step_ms", "cost")),
    "eval": (("mode", "epoch", "scenes", "metrics"), ()),
    "checkpoint": (("epoch", "kind"), ("path",)),
    "trace_window": (("action", "trace_dir", "epoch"), ()),
    "divergence": (("epoch", "step", "reason", "loss"),
                   ("zscore", "snapshot")),
    "snapshot": (("epoch", "step", "path", "reason"), ()),
    "serve_compile": (("bucket", "batch", "lower_s", "compile_s"),
                      ("memory", "dtype", "replica", "device_id")),
    "serve_batch": (("bucket", "batch", "n", "fill", "latency_ms"),
                    ("queue_depth", "replica", "device_id")),
    "serve_reject": (("reason",), ("bucket", "queue_depth")),
    "serve_shutdown": (("served", "rejected", "drained"), ()),
    "cost_calibration": (("bucket", "batch", "dtype", "predicted_s",
                          "measured_s", "platform", "comparable"),
                         ("replica", "basis", "extrapolated", "program")),
    "span": (("trace_id", "span_id", "name", "start_ms", "end_ms"),
             ("parent_id", "attrs")),
    "slo_report": (("path", "slo_p99_ms"),
                   ("max_qps_under_slo", "programs", "requests")),
    "recompile": (("program", "count"),
                  ("baseline", "signature", "context")),
    "device_memory": (("devices",), ("context",)),
    "replica_state": (("replica", "state"),
                      ("from_state", "reason", "device_id")),
    "fault_injected": (("point",),
                       ("replica", "bucket", "traversal", "fires",
                        "value")),
    "fleet_route": (("backend", "reason"),
                    ("bucket", "queue_depth", "predicted_s", "attempts",
                     "canary", "status")),
    "weight_swap": (("digest", "epoch"),
                    ("path", "previous_digest", "replicas", "swap_ms",
                     "drained")),
    "canary_verdict": (("verdict", "epe", "bound"),
                       ("rel_epe", "rel_bound", "samples", "fraction",
                        "canary_backend", "baseline_backend")),
}

# The vocabularies of the enumerated fields.
SERVE_REJECT_REASONS = (
    "queue_full", "too_large", "too_small", "bad_request", "shutdown",
    "timeout", "internal", "unavailable")
REPLICA_STATES = ("healthy", "degraded", "quarantined", "probing")
FAULT_POINTS = (
    "replica_predict_error", "replica_latency_ms", "replica_wedge",
    "queue_stall", "compile_trip")
FLEET_ROUTE_REASONS = ("least_loaded", "spillover", "canary", "shadow")
CANARY_VERDICTS = ("promote", "reject")

_BASE_FIELDS = ("schema", "type", "time", "seq")

# Fields that must hold a number (or a non-finite spelling).
_NUMERIC_FIELDS = {
    "step": ("epoch", "step", "loss", "epe"),
    "epoch_summary": ("epoch", "steps"),
    "eval": ("epoch", "scenes"),
    "checkpoint": ("epoch",),
    "trace_window": ("epoch",),
    "divergence": ("epoch", "step", "loss"),
    "snapshot": ("epoch", "step"),
    "serve_compile": ("bucket", "batch", "lower_s", "compile_s",
                      "replica", "device_id"),
    "serve_batch": ("bucket", "batch", "n", "fill", "latency_ms",
                    "queue_depth", "replica", "device_id"),
    "serve_reject": ("bucket", "queue_depth"),
    "serve_shutdown": ("served", "rejected", "drained"),
    "cost_calibration": ("bucket", "batch", "predicted_s", "measured_s",
                         "replica"),
    "span": ("start_ms", "end_ms"),
    "slo_report": ("slo_p99_ms", "max_qps_under_slo", "programs",
                   "requests"),
    "recompile": ("count", "baseline"),
    "replica_state": ("replica", "device_id"),
    "fault_injected": ("replica", "bucket", "traversal", "fires",
                       "value"),
    "fleet_route": ("backend", "bucket", "queue_depth", "predicted_s",
                    "attempts", "status"),
    "weight_swap": ("epoch", "replicas", "swap_ms", "drained"),
    "canary_verdict": ("epe", "bound", "rel_epe", "rel_bound", "samples",
                       "fraction", "canary_backend", "baseline_backend"),
}

# (type, field) -> the values it may take, present or not.
_ENUMS = {
    ("divergence", "reason"): ("nonfinite", "zscore"),
    ("trace_window", "action"): ("start", "stop"),
    ("serve_reject", "reason"): SERVE_REJECT_REASONS,
    ("replica_state", "state"): REPLICA_STATES,
    ("fault_injected", "point"): FAULT_POINTS,
    ("fleet_route", "reason"): FLEET_ROUTE_REASONS,
    ("canary_verdict", "verdict"): CANARY_VERDICTS,
}

# Fields that, when they hold a real number, must be >= 0.
_NON_NEGATIVE = {
    "replica_state": ("replica",),
    "fleet_route": ("backend",),
    "recompile": ("count",),
    "cost_calibration": ("predicted_s", "measured_s"),
    "weight_swap": ("replicas", "swap_ms", "drained"),
    "canary_verdict": ("epe", "bound", "rel_epe", "rel_bound", "samples",
                       "fraction"),
}

# device_memory rows: required and optional keys, and the byte counts.
DEVICE_MEMORY_REQUIRED = ("device_id", "bytes_in_use")
DEVICE_MEMORY_OPTIONAL = ("peak_bytes_in_use", "bytes_limit", "platform")
_DEVICE_MEMORY_BYTES = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

_NONFINITE_STRINGS = ("NaN", "Infinity", "-Infinity")


def sanitize(value: Any) -> Any:
    """A JSON-strict copy of ``value``: non-finite floats as their string
    spellings, numpy and torch scalars and arrays as Python numbers and
    lists, dicts and lists recursed."""
    if isinstance(value, dict):
        return {str(k): sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [sanitize(v) for v in value]
    if hasattr(value, "tolist") and not isinstance(value, (str, bytes)):
        return sanitize(value.tolist())
    if isinstance(value, float):
        if value != value:
            return "NaN"
        if value == float("inf"):
            return "Infinity"
        if value == float("-inf"):
            return "-Infinity"
    return value


def _is_number(value: Any) -> bool:
    if isinstance(value, bool):
        return False
    if isinstance(value, (int, float)):
        return True
    return isinstance(value, str) and value in _NONFINITE_STRINGS


def _real(value: Any) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def _device_memory_problems(rows: Any) -> List[str]:
    if not isinstance(rows, list) or not rows:
        return ["device_memory: devices must be a non-empty list of "
                "per-device rows"]
    problems = []
    known = set(DEVICE_MEMORY_REQUIRED) | set(DEVICE_MEMORY_OPTIONAL)
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            problems.append(f"device_memory: devices[{i}] is not an object")
            continue
        dev = row.get("device_id")
        if not isinstance(dev, int) or isinstance(dev, bool) or dev < 0:
            problems.append(
                f"device_memory: devices[{i}].device_id {dev!r} "
                "is not a known device (non-negative integer id)")
        for key in DEVICE_MEMORY_REQUIRED[1:]:
            if key not in row:
                problems.append(f"device_memory: devices[{i}] missing {key!r}")
        for key in row:
            if key not in known:
                problems.append(
                    f"device_memory: devices[{i}] unknown field {key!r}")
        for key in _DEVICE_MEMORY_BYTES:
            v = row.get(key)
            if v is not None and (not _real(v) or v < 0):
                problems.append(f"device_memory: devices[{i}].{key}={v!r} "
                                "must be a number >= 0")
    return problems


def _cost_problems(etype: str, rec: Dict[str, Any]) -> List[str]:
    """The platform-honesty rules of ``cost_calibration`` and of an
    ``epoch_summary``'s ``cost`` block: ``comparable`` is a bool and may
    be true only on platform "tpu"."""
    problems = []
    if not isinstance(rec.get("comparable"), bool):
        problems.append(f"{etype}: comparable must be a bool")
    if rec.get("comparable") is True and rec.get("platform") != "tpu":
        problems.append(
            f"{etype}: comparable=true on platform {rec.get('platform')!r}: "
            "only a TPU measurement may be enforced against the TPU "
            "prediction")
    if etype == "cost_calibration":
        for key in ("platform", "dtype"):
            if not isinstance(rec.get(key), str) or not rec.get(key):
                problems.append(
                    f"cost_calibration: {key} must be a non-empty string")
        if "basis" in rec and rec["basis"] not in ("xla_optimal",
                                                   "roofline"):
            problems.append(f"cost_calibration: basis {rec['basis']!r} must "
                            "be 'xla_optimal' or 'roofline'")
        if "extrapolated" in rec and not isinstance(rec["extrapolated"],
                                                    bool):
            problems.append("cost_calibration: extrapolated must be a bool")
    return problems


def validate_event(record: Any, seq: Optional[int] = None) -> List[str]:
    """Schema problems of one event record ([] = valid)."""
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, not an object"]
    problems = [f"missing base field {k!r}" for k in _BASE_FIELDS
                if k not in record]
    if problems:
        return problems
    if record["schema"] != SCHEMA_VERSION:
        problems.append(f"schema {record['schema']!r} != {SCHEMA_VERSION!r}")
    etype = record["type"]
    if etype not in EVENT_TYPES:
        return problems + [f"unknown event type {etype!r}"]
    if not _is_number(record["time"]):
        problems.append(f"time {record['time']!r} is not a number")
    if seq is not None and record["seq"] != seq:
        problems.append(f"seq {record['seq']!r} != expected {seq}")
    required, optional = EVENT_TYPES[etype]
    problems += [f"{etype}: missing field {k!r}" for k in required
                 if k not in record]
    known = set(_BASE_FIELDS) | set(required) | set(optional)
    problems += [f"{etype}: unknown field {k!r}" for k in record
                 if k not in known]
    for key in _NUMERIC_FIELDS.get(etype, ()):
        if key in record and not _is_number(record[key]):
            problems.append(
                f"{etype}: field {key!r}={record[key]!r} is not a number")
    for (etype_, key), allowed in _ENUMS.items():
        if etype_ == etype and record.get(key) not in allowed:
            problems.append(f"{etype}: {key} {record.get(key)!r} must be "
                            f"one of {allowed}")
    if etype == "replica_state" and "from_state" in record \
            and record["from_state"] not in REPLICA_STATES:
        problems.append(f"replica_state: from_state "
                        f"{record['from_state']!r} must be one of "
                        f"{REPLICA_STATES}")
    for key in _NON_NEGATIVE.get(etype, ()):
        v = record.get(key)
        if _real(v) and v < 0:
            problems.append(f"{etype}: {key} {v} must be >= 0")
    if etype == "recompile" and (not isinstance(record.get("program"), str)
                                 or not record.get("program")):
        problems.append("recompile: program must name the offending program")
    if etype == "weight_swap" and (not isinstance(record.get("digest"), str)
                                   or not record.get("digest")):
        problems.append("weight_swap: digest must be a non-empty string")
    if etype == "fleet_route" and "canary" in record \
            and not isinstance(record["canary"], bool):
        problems.append("fleet_route: canary must be a bool")
    if etype == "cost_calibration":
        problems += _cost_problems(etype, record)
    if etype == "epoch_summary" and "cost" in record:
        if isinstance(record["cost"], dict):
            problems += _cost_problems("epoch_summary: cost", record["cost"])
        else:
            problems.append("epoch_summary: cost must be an object")
    if etype == "device_memory":
        problems += _device_memory_problems(record.get("devices"))
    if etype == "span":
        start, end = record.get("start_ms"), record.get("end_ms")
        if _real(start) and _real(end) and end < start:
            problems.append(f"span: end_ms {end} < start_ms {start} "
                            "(reversed span: a clock bug, not data)")
    return problems


def _strict_json(line: str) -> Any:
    def bare(token):
        raise ValueError(f"bare {token} token (invalid strict JSON)")

    return json.loads(line, parse_constant=bare)


def validate_events(lines: List[str], path: str = "<events>") -> List[str]:
    """Problems of a whole stream ([] = valid): every line strict JSON and
    a valid record, the first a ``run_header``, ``seq`` 0, 1, 2, ..."""
    problems: List[str] = []
    records: List[Any] = []
    for i, line in enumerate(lines):
        if not line.strip():
            problems.append(f"{path}:{i + 1}: blank line")
            continue
        try:
            records.append(_strict_json(line))
        except ValueError as e:
            problems.append(f"{path}:{i + 1}: not strict JSON: {e}")
            records.append(None)
    if not records:
        return problems + [f"{path}: empty event stream"]
    if isinstance(records[0], dict) and records[0].get("type") != "run_header":
        problems.append(f"{path}:1: first record must be run_header, got "
                        f"{records[0].get('type')!r}")
    for i, record in enumerate(records):
        if record is not None:
            problems += [f"{path}:{i + 1}: {p}"
                         for p in validate_event(record, seq=i)]
    return problems


def validate_events_file(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return validate_events(f.read().splitlines(), path=path)


def read_events(path: str) -> List[Dict[str, Any]]:
    """The records of a stream file, in order."""
    with open(path, "r", encoding="utf-8") as f:
        return [_strict_json(line) for line in f if line.strip()]


def _git_metadata() -> Dict[str, Any]:
    """{commit, dirty} of the checkout this package lives in, or Nones
    (a copy without git is no reason to fail)."""
    import subprocess

    cwd = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=5, check=True).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, capture_output=True,
            text=True, timeout=5, check=True).stdout.strip())
        return {"commit": commit, "dirty": dirty}
    except Exception:  # noqa: BLE001 — no git, no metadata
        return {"commit": None, "dirty": None}


def run_metadata(cfg=None, mode: str = "train") -> Dict[str, Any]:
    """The ``run_header`` payload: config, git, devices, versions."""
    import dataclasses

    import torch

    config = (sanitize(dataclasses.asdict(cfg))
              if dataclasses.is_dataclass(cfg) else sanitize(cfg or {}))
    cuda = torch.cuda.is_available()
    return {
        "run_id": f"{mode}-{os.getpid()}-{int(time.time())}",
        "mode": mode,
        "config": config,
        "git": _git_metadata(),
        "devices": {
            "platform": "gpu" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "process_index": process_index(),
            "process_count": process_count(),
        },
        "versions": {"torch": torch.__version__, "cuda": torch.version.cuda},
    }


class EventLog:
    """Append-only ``pvraft_events/v1`` JSONL writer; every record is
    validated before it is written, and an invalid one raises. A
    disabled log constructs and no-ops.

    Process-0-only by default, as the JAX ``EventLog``: ``enabled=None``
    resolves to ``process_index() == 0``, so a bare ``EventLog(path)``
    writes once in a multi-process group and the other ranks' logs
    no-op."""

    def __init__(self, path: str, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = process_index() == 0
        self.path = path
        self.enabled = bool(enabled)
        self.seq = 0
        self._f: Optional[IO[str]] = None
        if self.enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            needs_newline = False
            if os.path.exists(path) and os.path.getsize(path) > 0:
                # Appending to an earlier stream: continue its seq chain,
                # ending a partial last line first.
                with open(path, "rb") as f:
                    data = f.read()
                needs_newline = not data.endswith(b"\n")
                self.seq = data.count(b"\n") + int(needs_newline)
            self._f = open(path, "a", encoding="utf-8")
            if needs_newline:
                self._f.write("\n")
                self._f.flush()

    def emit(self, etype: str, **fields: Any) -> Optional[Dict[str, Any]]:
        if not self.enabled:
            return None
        record: Dict[str, Any] = {"schema": SCHEMA_VERSION, "type": etype,
                                  "time": round(time.time(), 3),
                                  "seq": self.seq}
        record.update(sanitize(fields))
        problems = validate_event(record, seq=self.seq)
        if problems:
            raise ValueError(
                f"invalid {etype!r} event: {problems} (record={record!r})")
        assert self._f is not None
        self._f.write(json.dumps(record, sort_keys=True) + "\n")
        self._f.flush()
        self.seq += 1
        return record

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None
        self.enabled = False

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def given(**fields: Any) -> Dict[str, Any]:
    """The fields that are not None (optional fields are left out)."""
    return {k: v for k, v in fields.items() if v is not None}


class RunTelemetry:
    """The run's one sink (the JAX ``RunTelemetry``): each ``emit_*``
    writes one record to the ``pvraft_events/v1`` stream
    ``<exp_path>/<mode>.events.jsonl`` (``train.events.jsonl``,
    ``testalone.events.jsonl``) and, where the JAX sink does, the
    reference's TensorBoard scalars and a line of the text log
    (``utils/logging.py``): ``step`` writes ``Train/Loss`` and
    ``Train/EPE`` at the global step, and ``telemetry/grad_norm`` and
    ``telemetry/update_ratio`` where it carries them; ``eval`` writes
    ``<Mode>/{Loss,EPE,Outlier,Acc3dRelax,Acc3dStrict}`` at the epoch."""

    # eval metric key -> the reference's TensorBoard tag suffix.
    EVAL_TAGS = (("loss", "Loss"), ("epe3d", "EPE"), ("outlier", "Outlier"),
                 ("acc3d_relax", "Acc3dRelax"),
                 ("acc3d_strict", "Acc3dStrict"))

    def __init__(self, exp_path: str, mode: str = "Train", dataset: str = "",
                 events_name: Optional[str] = None,
                 enabled: Optional[bool] = None):
        from pvraft_tpu_torch.utils.logging import ExperimentLog, TBWriter

        # Rank 0 alone writes (the JAX EventLog's process-0 rule): the
        # other ranks' sinks construct and write nothing.
        if enabled is None:
            enabled = process_index() == 0
        self.log = ExperimentLog(exp_path, mode, dataset, enabled=enabled)
        self.tb = TBWriter(os.path.join(exp_path, "logs"), enabled=enabled)
        name = events_name or f"{mode.lower()}.events.jsonl"
        self.events = EventLog(os.path.join(exp_path, name), enabled=enabled)

    def info(self, msg: str) -> None:
        self.log.info(msg)

    def emit_header(self, cfg=None, mode: str = "train") -> None:
        self.events.emit("run_header", **run_metadata(cfg, mode=mode))

    def emit_step(self, epoch: int, step: int, loss: float, epe: float,
                  telemetry: Optional[Dict[str, Any]] = None) -> None:
        self.events.emit("step", epoch=epoch, step=step, loss=loss, epe=epe,
                         **given(telemetry=telemetry))
        self.tb.add_scalar("Train/Loss", loss, step)
        self.tb.add_scalar("Train/EPE", epe, step)
        for key in ("grad_norm", "update_ratio"):
            if telemetry is not None and key in telemetry:
                self.tb.add_scalar(f"telemetry/{key}", telemetry[key], step)

    def emit_epoch_summary(self, epoch: int, steps: int, **extra: Any) -> None:
        self.events.emit("epoch_summary", epoch=epoch, steps=steps, **extra)

    def emit_eval(self, mode: str, epoch: int, scenes: int,
                  metrics: Dict[str, float]) -> None:
        self.events.emit("eval", mode=mode, epoch=epoch, scenes=scenes,
                         metrics=metrics)
        tag = mode.capitalize()
        for key, suffix in self.EVAL_TAGS:
            if key in metrics:
                self.tb.add_scalar(f"{tag}/{suffix}", metrics[key], epoch)

    def emit_checkpoint(self, epoch: int, kind: str,
                        path: Optional[str] = None) -> None:
        self.events.emit("checkpoint", epoch=epoch, kind=kind,
                         **given(path=path))

    def emit_trace_window(self, action: str, trace_dir: str,
                          epoch: int) -> None:
        self.events.emit("trace_window", action=action, trace_dir=trace_dir,
                         epoch=epoch)

    def emit_divergence(self, epoch: int, step: int, reason: str,
                        loss: float, zscore: Optional[float] = None,
                        snapshot: Optional[str] = None) -> None:
        self.events.emit("divergence", epoch=epoch, step=step, reason=reason,
                         loss=loss, **given(zscore=zscore, snapshot=snapshot))
        self.log.info(
            f"DIVERGENCE at epoch {epoch} step {step}: {reason} "
            f"(loss={loss})" + (f" snapshot={snapshot}" if snapshot else ""))

    def emit_snapshot(self, epoch: int, step: int, path: str,
                      reason: str) -> None:
        self.events.emit("snapshot", epoch=epoch, step=step, path=path,
                         reason=reason)

    def emit_span(self, **span: Any) -> None:
        """One ``span`` record: the step profiler's stages arrive here
        through ``obs/trace.py::trace_from_step_profile``."""
        self.events.emit("span", **span)

    def emit_recompile(self, program: str, count: int,
                       baseline: Optional[int] = None,
                       signature: Optional[str] = None,
                       context: Optional[str] = None) -> None:
        """The retrace watchdog saw a train program capture a new input
        signature after warm-up."""
        self.events.emit("recompile", program=program, count=count,
                         **given(baseline=baseline, signature=signature,
                                 context=context))
        self.log.info(
            f"RECOMPILE: {program} program count grew to {count}"
            + (f" (baseline {baseline})" if baseline is not None else "")
            + (f" on {signature}" if signature else ""))

    def emit_device_memory(self, devices: list,
                           context: Optional[str] = None) -> None:
        """One sample of ``obs/device_memory.py::sample_device_memory``."""
        self.events.emit("device_memory", devices=devices,
                         **given(context=context))

    def close(self) -> None:
        """Close the stream, the TensorBoard writer and the log file.
        Idempotent."""
        self.events.close()
        self.tb.close()
        self.log.close()
