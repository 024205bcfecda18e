"""Request span tracing of the service (port of the serve half of
``pvraft_tpu/obs/trace.py``).

Every sampled request gets a trace id and a span tree::

    request
      ├─ ingress          read and decode the HTTP body
      ├─ validate         the engine's contract check
      ├─ queue_wait       enqueue -> a collector takes it
      ├─ batch_form       taken -> dispatched (straggler wait, grouping,
      │                   the wait for a replica)
      ├─ device_execute   the replay and the copy of the flow to the host
      │                   (inside ``torch.profiler.record_function(
      │                   "device_execute")``, so it lines up with the
      │                   replay's kernels in a ``/debug/trace`` window)
      ├─ serialize        flow -> JSON or msgpack
      └─ respond          the socket write

from ``time.monotonic()`` stamps at the hook points of
``serve/server.py`` and ``serve/batcher.py``. Spans travel as
``pvraft_events/v1`` records of type ``span`` through the service's
lock-serialized telemetry writer. Times are host-monotonic milliseconds:
comparable within one process, not wall time.

:class:`Tracer` samples 1 request in ``sample_every`` (1: all, 0: off).
An unsampled request costs one ``None`` check: nothing is stamped or
allocated for it. :func:`trace_shape` and :func:`collect_traces` read
span records back into trees (the checks of the tests and of
``chip_smoke.py``). :func:`trace_from_step_profile` gives the train
step the same span format, from the step profiler's breakdown.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock

TRACE_SCHEMA = "pvraft_trace/v1"

# The serve request's stages, in pipeline order.
SERVE_STAGES = (
    "ingress", "validate", "queue_wait", "batch_form", "device_execute",
    "serialize", "respond")
SERVE_ROOT = "request"
# The train step's tree: a root over the step profiler's breakdown
# (profiling/step_profiler.py::BREAKDOWN_STAGES).
TRAIN_ROOT = "train_step"

SPAN_REQUIRED = ("trace_id", "span_id", "name", "start_ms", "end_ms")
SPAN_OPTIONAL = ("parent_id", "attrs")


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class RequestTrace:
    """The stamp sheet of one traced request. Worker threads ``mark``
    stage intervals (a list append; the batcher's marks happen before
    the request's completion event, which the handler waits on); the
    handler assembles the tree once, at respond time (:meth:`spans`)."""

    __slots__ = ("trace_id", "t0", "_marks")

    def __init__(self, trace_id: Optional[str] = None,
                 t0: Optional[float] = None):
        self.trace_id = trace_id or new_trace_id()
        self.t0 = time.monotonic() if t0 is None else t0  # seconds
        self._marks: List[Tuple[str, float, float,
                                Optional[Dict[str, Any]]]] = []

    def mark(self, name: str, t_start: float, t_end: float,
             attrs: Optional[Dict[str, Any]] = None) -> None:
        """Record one stage interval (monotonic seconds)."""
        self._marks.append((name, t_start, t_end, attrs))

    def spans(self, t_end: Optional[float] = None,
              root_name: str = SERVE_ROOT,
              root_attrs: Optional[Dict[str, Any]] = None
              ) -> List[Dict[str, Any]]:
        """The tree: a root over [t0, t_end] and one child per mark."""
        t_end = time.monotonic() if t_end is None else t_end
        root_id = uuid.uuid4().hex[:12]
        root: Dict[str, Any] = {
            "trace_id": self.trace_id, "span_id": root_id,
            "name": root_name, "start_ms": round(self.t0 * 1000.0, 3),
            "end_ms": round(t_end * 1000.0, 3)}
        if root_attrs:
            root["attrs"] = dict(root_attrs)
        out = [root]
        for i, (name, ts, te, attrs) in enumerate(self._marks):
            span: Dict[str, Any] = {
                "trace_id": self.trace_id, "span_id": f"{root_id}.{i}",
                "parent_id": root_id, "name": name,
                "start_ms": round(ts * 1000.0, 3),
                "end_ms": round(te * 1000.0, 3)}
            if attrs:
                span["attrs"] = dict(attrs)
            out.append(span)
        return out

    def stage_durations_ms(self) -> Dict[str, float]:
        """{stage: ms} of the marks (the stage histograms' feed)."""
        return {name: round((te - ts) * 1000.0, 3)
                for name, ts, te, _ in self._marks}


class Tracer:
    """The sampling decision and the span sink, shared by the handler
    threads. ``sample_every`` and ``emit`` may be changed on a live
    server (the tracing-cost comparison alternates them)."""

    def __init__(self, sample_every: int = 1,
                 emit: Optional[Callable[..., Any]] = None):
        if sample_every < 0:
            raise ValueError("sample_every must be >= 0 (0 disables)")
        self.sample_every = int(sample_every)
        self.emit = emit
        self._lock = ordered_lock("Tracer._lock")
        self._n = 0  # guarded-by: _lock

    @property
    def enabled(self) -> bool:
        return self.sample_every > 0

    def begin(self) -> Optional[RequestTrace]:
        """A new :class:`RequestTrace` for a sampled request, else None."""
        every = self.sample_every
        if every <= 0:
            return None
        if every > 1:
            with self._lock:
                self._n += 1
                if self._n % every:
                    return None
        return RequestTrace()

    def emit_spans(self, spans: Sequence[Dict[str, Any]]) -> None:
        emit = self.emit  # read once: a live server may swap the sink
        if emit is None:
            return
        for span in spans:
            emit(**span)


def trace_shape(spans: Sequence[Dict[str, Any]],
                expected_stages: Sequence[str]
                ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]],
                           Dict[str, float], bool]:
    """``(roots, orphans, child stage ms, complete)`` of one trace's
    spans. Complete: one root (no ``parent_id``), no orphans (every
    ``parent_id`` resolves in the trace), every expected stage among the
    children."""
    ids = {s.get("span_id") for s in spans}
    roots = [s for s in spans if "parent_id" not in s]
    orphans = [s for s in spans
               if "parent_id" in s and s["parent_id"] not in ids]
    stages = {s.get("name"): s.get("end_ms", 0.0) - s.get("start_ms", 0.0)
              for s in spans if "parent_id" in s}
    complete = (len(roots) == 1 and not orphans
                and set(expected_stages) <= set(stages))
    return roots, orphans, stages, complete


def collect_traces(records: Sequence[Dict[str, Any]],
                   expected_stages: Sequence[str] = SERVE_STAGES,
                   source: str = "<events>") -> Dict[str, Any]:
    """The ``span`` records of a parsed stream grouped by trace into a
    ``pvraft_trace/v1`` document, completeness by :func:`trace_shape`."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("type") != "span":
            continue
        span = {k: rec[k] for k in (*SPAN_REQUIRED, *SPAN_OPTIONAL)
                if k in rec}
        by_trace.setdefault(rec["trace_id"], []).append(span)
    traces, n_complete, n_orphans, n_spans = [], 0, 0, 0
    for trace_id, spans in by_trace.items():
        spans.sort(key=lambda s: (s["start_ms"], s["span_id"]))
        roots, orphans, _, complete = trace_shape(spans, expected_stages)
        n_complete += complete
        n_orphans += len(orphans)
        n_spans += len(spans)
        entry: Dict[str, Any] = {
            "trace_id": trace_id,
            "root": roots[0]["name"] if len(roots) == 1 else None,
            "complete": complete, "spans": spans}
        if len(roots) == 1:
            entry["duration_ms"] = round(
                roots[0]["end_ms"] - roots[0]["start_ms"], 3)
        traces.append(entry)
    traces.sort(key=lambda t: t["trace_id"])
    return {"schema": TRACE_SCHEMA, "source": source,
            "expected_stages": list(expected_stages),
            "counts": {"traces": len(traces), "spans": n_spans,
                       "complete": n_complete, "orphan_spans": n_orphans},
            "traces": traces}


def validate_trace_artifact(doc: Any,
                            path: str = "<artifact>") -> List[str]:
    """Schema problems of a ``pvraft_trace/v1`` document ([] = valid).
    Completeness and the counts are recomputed from the spans, so a
    hand-edited ``complete`` cannot pass. ``expected_stages`` must be the
    serve vocabulary or the train step's (the step profiler's breakdown):
    an empty list would mark every trace complete."""
    from pvraft_tpu_torch.profiling.step_profiler import BREAKDOWN_STAGES

    if not isinstance(doc, dict):
        return [f"{path}: artifact is {type(doc).__name__}, not an object"]
    problems: List[str] = []
    if doc.get("schema") != TRACE_SCHEMA:
        problems.append(
            f"{path}: schema {doc.get('schema')!r} != {TRACE_SCHEMA!r}")
    for key in ("expected_stages", "counts", "traces"):
        if key not in doc:
            problems.append(f"{path}: missing field {key!r}")
    if problems:
        return problems
    if not isinstance(doc["expected_stages"], list) or tuple(
            doc["expected_stages"]) not in (SERVE_STAGES, BREAKDOWN_STAGES):
        problems.append(
            f"{path}: expected_stages {doc['expected_stages']!r} is not a "
            f"known stage vocabulary (serve: {list(SERVE_STAGES)}, train: "
            f"{list(BREAKDOWN_STAGES)}) — completeness would be meaningless")
        return problems
    if not isinstance(doc["traces"], list) or not isinstance(
            doc["counts"], dict):
        problems.append(
            f"{path}: traces must be a list and counts an object")
        return problems
    expected = set(doc["expected_stages"])
    n_complete = n_orphans = n_spans = 0
    for t_i, trace in enumerate(doc["traces"]):
        where = f"{path}: traces[{t_i}]"
        if (not isinstance(trace, dict)
                or not isinstance(trace.get("spans"), list)
                or not all(isinstance(s, dict) for s in trace["spans"])):
            problems.append(
                f"{where}: not an object with a list of span objects")
            continue
        spans = trace["spans"]
        for s_i, span in enumerate(spans):
            for key in SPAN_REQUIRED:
                if key not in span:
                    problems.append(
                        f"{where}.spans[{s_i}]: missing {key!r}")
            if "start_ms" in span and "end_ms" in span and (
                    span["end_ms"] < span["start_ms"]):
                problems.append(
                    f"{where}.spans[{s_i}]: end_ms {span['end_ms']} < "
                    f"start_ms {span['start_ms']}")
            if span.get("trace_id") != trace.get("trace_id"):
                problems.append(
                    f"{where}.spans[{s_i}]: trace_id "
                    f"{span.get('trace_id')!r} != {trace.get('trace_id')!r}")
        roots, orphans, stages, complete = trace_shape(spans, expected)
        if bool(trace.get("complete")) != complete:
            problems.append(
                f"{where}: complete={trace.get('complete')!r} but spans "
                f"say {complete} (roots={len(roots)}, "
                f"orphans={len(orphans)}, "
                f"missing={sorted(expected - set(stages))})")
        n_complete += complete
        n_orphans += len(orphans)
        n_spans += len(spans)
    want = {"traces": len(doc["traces"]), "spans": n_spans,
            "complete": n_complete, "orphan_spans": n_orphans}
    if doc["counts"] != want:
        problems.append(
            f"{path}: counts {doc['counts']} != recomputed {want}")
    return problems


def validate_trace_artifact_file(path: str) -> List[str]:
    """As the JAX validator words it: a file that cannot be read or
    parsed is one ``unreadable`` problem."""
    import json

    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable: {e}"]
    return validate_trace_artifact(doc, path=path)


def trace_from_step_profile(record: Dict[str, Any],
                            trace_id: Optional[str] = None
                            ) -> List[Dict[str, Any]]:
    """A ``pvraft_step_profile/v1`` record's breakdown as spans: one
    ``train_step`` root of ``total_step_s`` and the stages end to end in
    breakdown order (they telescope, so laid end to end they are the
    measured decomposition). A stage that timing noise made slightly
    negative becomes an empty span; the record keeps the signed value."""
    if "breakdown_s" not in record or "total_step_s" not in record:
        raise ValueError(
            "step-profile record has no breakdown (incomplete ladder); "
            "cannot build a trace")
    tid = trace_id or new_trace_id()
    root_id = uuid.uuid4().hex[:12]
    spans: List[Dict[str, Any]] = [{
        "trace_id": tid, "span_id": root_id, "name": TRAIN_ROOT,
        "start_ms": 0.0,
        "end_ms": round(record["total_step_s"] * 1000.0, 3),
        "attrs": {k: record.get(k) for k in
                  ("platform", "variant", "points", "batch", "iters")},
    }]
    cursor = 0.0
    for i, (stage, sec) in enumerate(record["breakdown_s"].items()):
        dur_ms = max(0.0, sec * 1000.0)
        spans.append({
            "trace_id": tid, "span_id": f"{root_id}.{i}",
            "parent_id": root_id, "name": stage,
            "start_ms": round(cursor, 3),
            "end_ms": round(cursor + dur_ms, 3),
        })
        cursor += dur_ms
    return spans
