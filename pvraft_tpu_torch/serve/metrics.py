"""Serve metrics, the store behind ``/metrics`` (port of
``pvraft_tpu/serve/metrics.py``).

HTTP handler threads and batcher workers update the counters
concurrently; one lock keeps each snapshot consistent, and the
reconciliation identity ``requests_total == responses_total +
sum(rejected) + in_flight`` holds at every snapshot. The latency
histogram has fixed log-spaced edges (ms), so it stays bounded however
long the server runs; its quantiles are the upper edge of the bucket
they fall in.

Two renderings of one store, with the JAX package's names and keys:

* JSON (``/metrics``): :meth:`ServeMetrics.snapshot`;
* Prometheus text 0.0.4 (``/metrics?format=prometheus``):
  :func:`render_prometheus`, the ``pvraft_serve_*`` families, and only
  there the traced per-(bucket, stage) latency histograms
  (:meth:`ServeMetrics.record_stages`), the device-memory gauges fed by
  the memory monitor and the retrace watchdog's counter: the JSON
  snapshot keeps the JAX package's keys.

The cost-calibration series (``serve/costing.py``) exist only while the
store is armed (:meth:`ServeMetrics.arm_cost`, by ``build_service`` with
a cost surface): predicted and measured device-seconds per (bucket,
batch, dtype), busy seconds and the rolling busy fraction per replica
(:func:`replica_utilization`). A disarmed store renders the exposition as
it did before them; ``/healthz`` reads :meth:`ServeMetrics.cost_snapshot`.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.serve.supervisor import REPLICA_STATES

# Histogram edges (ms): a sample falls in the first bucket whose edge is
# >= it; the last bucket is unbounded.
LATENCY_EDGES_MS = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0, 30000.0,
)

# Request-size (points per cloud) edges.
POINT_EDGES = (
    32.0, 64.0, 128.0, 256.0, 512.0, 1024.0, 2048.0, 4096.0, 8192.0,
    16384.0, 32768.0,
)

# The window of the per-replica busy fraction.
UTILIZATION_WINDOW_S = 60.0
# At most this many dispatch intervals a replica (intervals older than the
# window are pruned first).
_BUSY_INTERVALS_MAX = 65536


class LatencyHistogram:
    """Fixed-edge histogram with count, sum and max (no lock: its owner
    serializes access)."""

    def __init__(self, edges: Sequence[float] = LATENCY_EDGES_MS):
        self.edges = tuple(edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def observe(self, ms: float) -> None:
        i = 0
        while i < len(self.edges) and ms > self.edges[i]:
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum_ms += ms
        self.max_ms = max(self.max_ms, ms)

    def quantile(self, q: float) -> Optional[float]:
        """The edge of the bucket holding the q-quantile (None when empty,
        max_ms in the unbounded bucket)."""
        if not self.count:
            return None
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                if i < len(self.edges):
                    return self.edges[i]
                return self.max_ms
        return self.max_ms

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "mean_ms": (self.sum_ms / self.count) if self.count else None,
            "max_ms": self.max_ms if self.count else None,
            "p50_ms": self.quantile(0.50),
            "p95_ms": self.quantile(0.95),
            "p99_ms": self.quantile(0.99),
            "bucket_edges_ms": list(self.edges),
            "bucket_counts": list(self.counts),
        }


class ServeMetrics:
    """All serve counters behind one lock; readers go through
    :meth:`snapshot`, :meth:`prometheus` and :meth:`current_in_flight`."""

    def __init__(self, buckets):
        self._lock = ordered_lock("ServeMetrics._lock")
        self.requests_total = 0   # guarded-by: _lock
        self.responses_total = 0  # guarded-by: _lock
        # Accepted requests whose outcome is not recorded yet.
        self.in_flight = 0  # guarded-by: _lock
        self.rejected: Dict[str, int] = {}  # guarded-by: _lock
        self.batches_total = 0    # guarded-by: _lock
        self.batch_fill_sum = 0.0  # guarded-by: _lock
        self.per_bucket_requests: Dict[int, int] = {int(b): 0  # guarded-by: _lock
                                                    for b in buckets}
        self.latency = LatencyHistogram()  # guarded-by: _lock
        self.request_points = LatencyHistogram(edges=POINT_EDGES)  # guarded-by: _lock
        # Failed batches dispatched once more on another replica.
        self.retries_total = 0  # guarded-by: _lock
        # Prometheus only: per-(bucket, stage) latency of traced
        # requests, the newest device-memory rows, the watchdog's trips.
        self.stage_latency: Dict[Tuple[int, str], LatencyHistogram] = {}  # guarded-by: _lock
        self.device_memory: List[Dict[str, Any]] = []  # guarded-by: _lock
        self.recompiles_total = 0  # guarded-by: _lock
        # The cost plane, armed by build_service with a cost surface.
        self.cost_armed = False  # guarded-by: _lock
        self.predicted_device_seconds_total = 0.0  # guarded-by: _lock
        self.busy_seconds: Dict[int, float] = {}  # guarded-by: _lock
        # (bucket, batch, dtype) -> running calibration sums.
        self.cost_calibration: Dict[Tuple[int, int, str], Dict[str, Any]] = {}  # guarded-by: _lock
        # replica -> recent (t_start, t_end) dispatch intervals.
        self._busy_intervals: Dict[int, Any] = {}  # guarded-by: _lock

    def current_in_flight(self) -> int:
        with self._lock:
            return self.in_flight

    def record_submit(self, bucket: int,
                      n_points: Optional[int] = None) -> None:
        with self._lock:
            self.requests_total += 1
            self.in_flight += 1
            self.per_bucket_requests[int(bucket)] = (
                self.per_bucket_requests.get(int(bucket), 0) + 1)
            if n_points is not None:
                self.request_points.observe(float(n_points))

    def record_stages(self, bucket: int,
                      stage_ms: Dict[str, float]) -> None:
        """The stage latencies of one traced request."""
        with self._lock:
            for stage, ms in stage_ms.items():
                hist = self.stage_latency.get((int(bucket), stage))
                if hist is None:
                    hist = self.stage_latency[(int(bucket), stage)] = \
                        LatencyHistogram()
                hist.observe(ms)

    def record_device_memory(self, rows: List[Dict[str, Any]]) -> None:
        """The newest device-memory sample (a gauge: the last one wins)."""
        with self._lock:
            self.device_memory = [dict(r) for r in rows]

    def record_recompile(self) -> None:
        """One retrace-watchdog trip."""
        with self._lock:
            self.recompiles_total += 1

    def record_retry(self) -> None:
        with self._lock:
            self.retries_total += 1

    def arm_cost(self) -> None:
        """Turn the cost-calibration series on."""
        with self._lock:
            self.cost_armed = True

    def record_cost(self, bucket: int, batch: int, dtype: str,
                    replica: int, predicted_s: float, measured_s: float,
                    t_start: float, t_end: float, comparable: bool,
                    extrapolated: bool) -> None:
        """One priced and measured dispatch (``serve/costing.py``)."""
        key = (int(bucket), int(batch), dtype)
        with self._lock:
            self.predicted_device_seconds_total += predicted_s
            self.busy_seconds[int(replica)] = (
                self.busy_seconds.get(int(replica), 0.0) + measured_s)
            slot = self.cost_calibration.get(key)
            if slot is None:
                slot = self.cost_calibration[key] = {
                    "n": 0, "predicted_s": 0.0, "measured_s": 0.0,
                    "comparable": comparable, "extrapolated": 0}
            slot["n"] += 1
            slot["predicted_s"] += predicted_s
            slot["measured_s"] += measured_s
            # An incomparable dispatch makes its whole key incomparable.
            slot["comparable"] = slot["comparable"] and comparable
            slot["extrapolated"] += 1 if extrapolated else 0
            window = self._busy_intervals.get(int(replica))
            if window is None:
                window = self._busy_intervals[int(replica)] = \
                    collections.deque(maxlen=_BUSY_INTERVALS_MAX)
            window.append((t_start, t_end))
            # Pruned by age, so that a busy replica's intervals always
            # span the window they are divided by.
            cutoff = t_end - UTILIZATION_WINDOW_S
            while window and window[0][1] < cutoff:
                window.popleft()

    def cost_snapshot(self, now: Optional[float] = None
                      ) -> Optional[Dict[str, Any]]:
        """The ``/healthz`` ``cost`` block: the calibration rows, busy
        seconds and utilization per replica (None while disarmed)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if not self.cost_armed:
                return None
            rows = []
            for (bucket, batch, dtype), slot in sorted(
                    self.cost_calibration.items()):
                rows.append({
                    "bucket": bucket, "batch": batch, "dtype": dtype,
                    "n": slot["n"],
                    "predicted_s": round(slot["predicted_s"], 6),
                    "measured_s": round(slot["measured_s"], 6),
                    "ratio": (round(slot["measured_s"]
                                    / slot["predicted_s"], 4)
                              if slot["predicted_s"] > 0 else None),
                    "comparable": slot["comparable"],
                    "extrapolated": slot["extrapolated"],
                })
            return {
                "predicted_device_seconds_total": round(
                    self.predicted_device_seconds_total, 6),
                "device_busy_seconds": {
                    str(r): round(sec, 6)
                    for r, sec in sorted(self.busy_seconds.items())},
                "utilization_window_s": UTILIZATION_WINDOW_S,
                "utilization": {
                    str(r): round(u, 4)
                    for r, u in sorted(replica_utilization(
                        self._busy_intervals, now).items())},
                "calibration": rows,
            }

    def record_reject(self, reason: str) -> None:
        """A request refused before it was accepted."""
        with self._lock:
            self.requests_total += 1
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def record_failure(self, reason: str) -> None:
        """An accepted request (already in ``requests_total``) that never
        produced a response: timeout, engine failure, shutdown without
        drain."""
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1
            self.in_flight -= 1

    def record_batch(self, n: int, fill: float,
                     latencies_ms: List[float]) -> None:
        with self._lock:
            self.batches_total += 1
            self.batch_fill_sum += fill
            self.responses_total += n
            self.in_flight -= n
            for ms in latencies_ms:
                self.latency.observe(ms)

    def snapshot(self, queue_depths: Optional[Dict[int, int]] = None
                 ) -> Dict[str, Any]:
        """The JSON ``/metrics`` document (the JAX package's keys)."""
        with self._lock:
            snap: Dict[str, Any] = {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "rejected": dict(self.rejected),
                "batches_total": self.batches_total,
                "batch_fill_mean": (
                    self.batch_fill_sum / self.batches_total
                    if self.batches_total else None),
                "per_bucket_requests": {
                    str(k): v for k, v in self.per_bucket_requests.items()},
                "latency": self.latency.snapshot(),
            }
        if queue_depths is not None:
            snap["queue_depth"] = {str(k): v for k, v in queue_depths.items()}
        return snap

    def prometheus(self, queue_depths: Optional[Dict[int, int]] = None,
                   replica_stats: Optional[List[Dict[str, Any]]] = None,
                   batch_queue_depth: Optional[int] = None) -> str:
        """Prometheus text 0.0.4, rendered under the one lock.
        ``replica_stats`` (``MicroBatcher.replica_stats()``) and the
        queue depths are live gauges the caller samples."""
        with self._lock:
            return render_prometheus(self, queue_depths,
                                     replica_stats=replica_stats,
                                     batch_queue_depth=batch_queue_depth)


def replica_utilization(busy_intervals: Dict[int, Any], now: float,
                        window_s: float = UTILIZATION_WINDOW_S
                        ) -> Dict[int, float]:
    """replica -> busy fraction of the trailing ``window_s``, from each
    replica's (start, end) dispatch intervals."""
    out: Dict[int, float] = {}
    cutoff = now - window_s
    for replica, intervals in busy_intervals.items():
        busy = sum(max(0.0, min(t1, now) - max(t0, cutoff))
                   for t0, t1 in intervals)
        out[replica] = min(1.0, busy / window_s)
    return out


# ------------------------------------------------ Prometheus exposition --

PROM_CONTENT_TYPE = "text/plain; version=0.0.4"


def _prom_escape(value: Any) -> str:
    return str(value).replace("\\", r"\\").replace(
        "\n", r"\n").replace('"', r'\"')


def _prom_labels(labels: Optional[Dict[str, Any]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_prom_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_num(v: float) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class _PromDoc:
    """One exposition document; HELP and TYPE precede each family once."""

    def __init__(self):
        self.lines: List[str] = []

    def family(self, name: str, mtype: str, help_text: str) -> None:
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {mtype}")

    def sample(self, name: str, value: float,
               labels: Optional[Dict[str, Any]] = None) -> None:
        self.lines.append(f"{name}{_prom_labels(labels)} {_prom_num(value)}")

    def histogram(self, name: str, hist: LatencyHistogram,
                  labels: Optional[Dict[str, Any]] = None) -> None:
        cum = 0
        for edge, count in zip(hist.edges, hist.counts):
            cum += count
            le = dict(labels or {})
            le["le"] = _prom_num(float(edge))
            self.sample(f"{name}_bucket", cum, le)
        le = dict(labels or {})
        le["le"] = "+Inf"
        self.sample(f"{name}_bucket", cum + hist.counts[-1], le)
        self.sample(f"{name}_sum", round(hist.sum_ms, 6), labels)
        self.sample(f"{name}_count", hist.count, labels)

    def render(self) -> str:
        return "\n".join(self.lines) + "\n"


def render_prometheus(metrics: ServeMetrics,
                      queue_depths: Optional[Dict[int, int]] = None,
                      replica_stats: Optional[List[Dict[str, Any]]] = None,
                      batch_queue_depth: Optional[int] = None) -> str:
    """The ``pvraft_serve_*`` exposition. The caller holds the metrics
    lock (:meth:`ServeMetrics.prometheus`)."""
    doc = _PromDoc()
    doc.family("pvraft_serve_requests_total", "counter",
               "Requests received (accepted + rejected).")
    doc.sample("pvraft_serve_requests_total", metrics.requests_total)
    doc.family("pvraft_serve_responses_total", "counter",
               "Successful predict responses.")
    doc.sample("pvraft_serve_responses_total", metrics.responses_total)
    doc.family("pvraft_serve_in_flight", "gauge",
               "Accepted requests whose outcome is not yet recorded "
               "(requests_total == responses_total + rejected + this).")
    doc.sample("pvraft_serve_in_flight", metrics.in_flight)
    doc.family("pvraft_serve_rejected_total", "counter",
               "Rejected or failed requests by reason.")
    for reason, count in sorted(metrics.rejected.items()):
        doc.sample("pvraft_serve_rejected_total", count,
                   {"reason": reason})
    doc.family("pvraft_serve_batches_total", "counter",
               "Dispatched micro-batches.")
    doc.sample("pvraft_serve_batches_total", metrics.batches_total)
    doc.family("pvraft_serve_batch_fill_sum", "counter",
               "Sum of per-batch fill ratios (divide by "
               "pvraft_serve_batches_total for the mean).")
    doc.sample("pvraft_serve_batch_fill_sum",
               round(metrics.batch_fill_sum, 6))
    doc.family("pvraft_serve_bucket_requests_total", "counter",
               "Accepted requests per point-count bucket.")
    for bucket, count in sorted(metrics.per_bucket_requests.items()):
        doc.sample("pvraft_serve_bucket_requests_total", count,
                   {"bucket": bucket})
    if queue_depths is not None:
        doc.family("pvraft_serve_queue_depth", "gauge",
                   "Pending requests per bucket queue.")
        for bucket, depth in sorted(queue_depths.items()):
            doc.sample("pvraft_serve_queue_depth", depth,
                       {"bucket": bucket})
    if batch_queue_depth is not None:
        doc.family("pvraft_serve_batch_queue_depth", "gauge",
                   "Formed micro-batches awaiting a replica executor.")
        doc.sample("pvraft_serve_batch_queue_depth", batch_queue_depth)
    if replica_stats:
        doc.family("pvraft_serve_replica_in_flight", "gauge",
                   "Requests currently executing per replica.")
        for row in replica_stats:
            doc.sample("pvraft_serve_replica_in_flight",
                       row["in_flight"],
                       {"replica": row["replica"],
                        "device": row["device_id"]})
        doc.family("pvraft_serve_replica_batches_total", "counter",
                   "Micro-batches served per replica.")
        for row in replica_stats:
            doc.sample("pvraft_serve_replica_batches_total",
                       row["batches_total"],
                       {"replica": row["replica"],
                        "device": row["device_id"]})
        if any("state" in row for row in replica_stats):
            doc.family("pvraft_serve_replica_state", "gauge",
                       "Supervisor health state per replica: 1 for the "
                       "current state, 0 otherwise.")
            for row in replica_stats:
                if "state" not in row:
                    continue
                for state in REPLICA_STATES:
                    doc.sample(
                        "pvraft_serve_replica_state",
                        1 if row["state"] == state else 0,
                        {"replica": row["replica"], "state": state})
    if metrics.device_memory:
        doc.family("pvraft_device_hbm_bytes", "gauge",
                   "Device bytes in use, latest device.memory_stats() "
                   "sample (obs/device_memory.py).")
        for row in metrics.device_memory:
            doc.sample("pvraft_device_hbm_bytes", row["bytes_in_use"],
                       {"device": row["device_id"]})
        if any("peak_bytes_in_use" in r for r in metrics.device_memory):
            doc.family("pvraft_device_hbm_peak_bytes", "gauge",
                       "Peak device bytes in use since process start "
                       "(allocator watermark).")
            for row in metrics.device_memory:
                if "peak_bytes_in_use" in row:
                    doc.sample("pvraft_device_hbm_peak_bytes",
                               row["peak_bytes_in_use"],
                               {"device": row["device_id"]})
    doc.family("pvraft_serve_recompiles_total", "counter",
               "Retrace-watchdog trips: backend compiles observed after "
               "the AOT program set sealed (each also rides the event "
               "stream as a `recompile` record).")
    doc.sample("pvraft_serve_recompiles_total", metrics.recompiles_total)
    doc.family("pvraft_serve_retries_total", "counter",
               "Failed micro-batches re-dispatched once on a different "
               "replica.")
    doc.sample("pvraft_serve_retries_total", metrics.retries_total)
    if metrics.cost_armed:
        _render_cost(doc, metrics)
    doc.family("pvraft_serve_latency_ms", "histogram",
               "End-to-end request latency (enqueue to resolve), ms.")
    doc.histogram("pvraft_serve_latency_ms", metrics.latency)
    doc.family("pvraft_serve_request_points", "histogram",
               "Requested points per cloud.")
    doc.histogram("pvraft_serve_request_points", metrics.request_points)
    doc.family("pvraft_serve_stage_latency_ms", "histogram",
               "Per-stage latency of traced requests by (bucket, stage) "
               "— stages: ingress validate queue_wait batch_form "
               "device_execute serialize respond.")
    for (bucket, stage), hist in sorted(metrics.stage_latency.items()):
        doc.histogram("pvraft_serve_stage_latency_ms", hist,
                      {"bucket": bucket, "stage": stage})
    return doc.render()


def _render_cost(doc: _PromDoc, metrics: ServeMetrics) -> None:
    """The cost plane's seven families (``serve/costing.py``)."""
    doc.family("pvraft_serve_predicted_device_seconds_total", "counter",
               "Predicted device-seconds of every priced dispatch "
               "(CostSurface over the pvraft_costs/v1 inventory).")
    doc.sample("pvraft_serve_predicted_device_seconds_total",
               round(metrics.predicted_device_seconds_total, 6))
    doc.family("pvraft_serve_device_busy_seconds_total", "counter",
               "Measured dispatch wall-seconds per replica (the "
               "device_execute window the trace plane marks).")
    for replica, busy in sorted(metrics.busy_seconds.items()):
        doc.sample("pvraft_serve_device_busy_seconds_total",
                   round(busy, 6), {"replica": replica})
    doc.family("pvraft_serve_replica_utilization", "gauge",
               "Busy fraction of the trailing "
               f"{UTILIZATION_WINDOW_S:.0f}s window per replica.")
    for replica, util in sorted(replica_utilization(
            metrics._busy_intervals, time.monotonic()).items()):
        doc.sample("pvraft_serve_replica_utilization", round(util, 4),
                   {"replica": replica})
    cal = [(slot, {"bucket": b, "batch": bs, "dtype": dt})
           for (b, bs, dt), slot in sorted(metrics.cost_calibration.items())]
    doc.family("pvraft_serve_cost_predicted_seconds_total", "counter",
               "Predicted device-seconds by (bucket, batch, dtype).")
    for slot, labels in cal:
        doc.sample("pvraft_serve_cost_predicted_seconds_total",
                   round(slot["predicted_s"], 6), labels)
    doc.family("pvraft_serve_cost_measured_seconds_total", "counter",
               "Measured dispatch seconds by (bucket, batch, dtype).")
    for slot, labels in cal:
        doc.sample("pvraft_serve_cost_measured_seconds_total",
                   round(slot["measured_s"], 6), labels)
    doc.family("pvraft_serve_cost_dispatches_total", "counter",
               "Priced dispatches by (bucket, batch, dtype).")
    for slot, labels in cal:
        doc.sample("pvraft_serve_cost_dispatches_total", slot["n"], labels)
    doc.family("pvraft_serve_cost_calibration_ratio", "gauge",
               "measured/predicted device-seconds by (bucket, batch, "
               "dtype): how far a dispatch sits from the card's roofline "
               "(recorded, never enforceable off a TPU: comparable=false "
               "on the event stream).")
    for slot, labels in cal:
        if slot["predicted_s"] > 0:
            doc.sample("pvraft_serve_cost_calibration_ratio",
                       round(slot["measured_s"] / slot["predicted_s"], 4),
                       labels)
