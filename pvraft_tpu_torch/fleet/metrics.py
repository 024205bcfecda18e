"""The fleet router's counters (port of ``pvraft_tpu/fleet/metrics.py``):
one lock and one identity,

    requests_total == responses_total + sum(rejected.values()) + in_flight

which holds at every snapshot, not only at rest. A request is counted
once at ingress (``record_submit``) and reaches exactly one terminal
record (``record_response`` or ``record_failure``). Spillover attempts
and canary shadow mirrors are dispatch facts with their own counters,
never in the client ledger. The Prometheus text reuses the serve
renderer's ``_PromDoc`` under ``pvraft_fleet_*``; each backend's health
is a one-hot gauge over ``REPLICA_STATES``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.obs.events import REPLICA_STATES
from pvraft_tpu_torch.serve.metrics import PROM_CONTENT_TYPE, _PromDoc

__all__ = ["FleetMetrics", "PROM_CONTENT_TYPE"]


class FleetMetrics:
    """Thread-safe fleet request ledger + per-backend dispatch counters."""

    def __init__(self):
        self._lock = ordered_lock("FleetMetrics._lock")
        self.requests_total = 0      # guarded-by: _lock
        self.responses_total = 0     # guarded-by: _lock
        self.in_flight = 0           # guarded-by: _lock
        self.rejected: Dict[str, int] = {}  # guarded-by: _lock
        self.spillovers_total = 0    # guarded-by: _lock
        self.canary_total = 0        # guarded-by: _lock
        self.shadow_total = 0        # guarded-by: _lock
        self.predicted_device_seconds_total = 0.0  # guarded-by: _lock
        # backend index -> {"responses", "failures", "predicted_s"}
        self.per_backend: Dict[int, Dict[str, Any]] = {}  # guarded-by: _lock

    def record_submit(self) -> None:
        with self._lock:
            self.requests_total += 1
            self.in_flight += 1

    def record_response(self, backend: int, predicted_s: float = 0.0,
                        canary: bool = False) -> None:
        with self._lock:
            self.responses_total += 1
            self.in_flight -= 1
            self.predicted_device_seconds_total += predicted_s
            if canary:
                self.canary_total += 1
            slot = self.per_backend.setdefault(
                int(backend),
                {"responses": 0, "failures": 0, "predicted_s": 0.0})
            slot["responses"] += 1
            slot["predicted_s"] += predicted_s

    def record_failure(self, reason: str,
                       backend: Optional[int] = None) -> None:
        """Terminal non-200 outcome for an ACCEPTED request (every
        ingress request was accepted into the ledger — the router has no
        pre-acceptance reject path; a body it cannot parse is a
        ``bad_request`` failure)."""
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1
            self.in_flight -= 1
            if backend is not None:
                slot = self.per_backend.setdefault(
                    int(backend),
                    {"responses": 0, "failures": 0, "predicted_s": 0.0})
                slot["failures"] += 1

    def record_spillover(self) -> None:
        with self._lock:
            self.spillovers_total += 1

    def record_shadow(self) -> None:
        with self._lock:
            self.shadow_total += 1

    def current_in_flight(self) -> int:
        with self._lock:
            return self.in_flight

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "in_flight": self.in_flight,
                "rejected": dict(self.rejected),
                "spillovers_total": self.spillovers_total,
                "canary_total": self.canary_total,
                "shadow_total": self.shadow_total,
                "predicted_device_seconds_total": round(
                    self.predicted_device_seconds_total, 6),
                "per_backend": {
                    str(i): {"responses": s["responses"],
                             "failures": s["failures"],
                             "predicted_s": round(s["predicted_s"], 6)}
                    for i, s in sorted(self.per_backend.items())},
            }

    def prometheus(self, backends: List[Dict[str, Any]]) -> str:
        """The ``pvraft_fleet_*`` exposition. ``backends`` is the list
        of :meth:`Backend.snapshot` rows (sampled by the caller outside
        this lock — backend locks and the metrics lock never nest)."""
        snap = self.snapshot()
        doc = _PromDoc()
        doc.family("pvraft_fleet_requests_total", "counter",
                   "Requests received by the router "
                   "(== responses + rejected + in_flight).")
        doc.sample("pvraft_fleet_requests_total", snap["requests_total"])
        doc.family("pvraft_fleet_responses_total", "counter",
                   "Requests answered 200 via some backend.")
        doc.sample("pvraft_fleet_responses_total", snap["responses_total"])
        doc.family("pvraft_fleet_in_flight", "gauge",
                   "Requests without a recorded terminal outcome yet.")
        doc.sample("pvraft_fleet_in_flight", snap["in_flight"])
        doc.family("pvraft_fleet_rejected_total", "counter",
                   "Terminal non-200 outcomes by reason.")
        for reason, count in sorted(snap["rejected"].items()):
            doc.sample("pvraft_fleet_rejected_total", count,
                       {"reason": reason})
        doc.family("pvraft_fleet_spillovers_total", "counter",
                   "Dispatch attempts re-routed to another backend "
                   "after a shed or connect failure.")
        doc.sample("pvraft_fleet_spillovers_total", snap["spillovers_total"])
        doc.family("pvraft_fleet_canary_requests_total", "counter",
                   "Client requests served by the canary backend.")
        doc.sample("pvraft_fleet_canary_requests_total", snap["canary_total"])
        doc.family("pvraft_fleet_shadow_requests_total", "counter",
                   "Router-internal shadow mirrors to the incumbent "
                   "(the canary EPE comparison traffic).")
        doc.sample("pvraft_fleet_shadow_requests_total", snap["shadow_total"])
        doc.family("pvraft_fleet_predicted_device_seconds_total", "counter",
                   "Cost-surface-predicted device-seconds routed "
                   "(0 while no surface is armed).")
        doc.sample("pvraft_fleet_predicted_device_seconds_total",
                   snap["predicted_device_seconds_total"])
        doc.family("pvraft_fleet_backend_responses_total", "counter",
                   "200s served per backend.")
        for i, slot in sorted(snap["per_backend"].items()):
            doc.sample("pvraft_fleet_backend_responses_total",
                       slot["responses"], {"backend": i})
        doc.family("pvraft_fleet_backend_failures_total", "counter",
                   "Terminal failures attributed per backend.")
        for i, slot in sorted(snap["per_backend"].items()):
            doc.sample("pvraft_fleet_backend_failures_total",
                       slot["failures"], {"backend": i})
        doc.family("pvraft_fleet_backend_queue_depth", "gauge",
                   "Polled backend in-flight count (its /healthz).")
        for row in backends:
            doc.sample("pvraft_fleet_backend_queue_depth",
                       row["queue_depth"], {"backend": row["backend"]})
        doc.family("pvraft_fleet_backend_outstanding", "gauge",
                   "Router-side dispatches currently open per backend.")
        for row in backends:
            doc.sample("pvraft_fleet_backend_outstanding",
                       row["outstanding"], {"backend": row["backend"]})
        doc.family("pvraft_fleet_backend_state", "gauge",
                   "Poll-driven health state per backend: 1 for the "
                   "current state, 0 otherwise (the replica "
                   "supervisor's vocabulary, one tier up).")
        for row in backends:
            for state in REPLICA_STATES:
                doc.sample("pvraft_fleet_backend_state",
                           1 if row["state"] == state else 0,
                           {"backend": row["backend"], "state": state})
        return doc.render()
