"""One backend of the fleet: an HTTP client and the polled health of a
serve host (port of ``pvraft_tpu/fleet/backend.py``).

A backend is a whole ``serve.build_service`` pool at ``host:port``; the
router sees its ``/healthz`` and its ``/predict`` answers, never its
replicas. Health follows the poll loop (``FleetRouter.poll_once``), not
the dispatches: a 503 is a routing signal (spill over), a backend that
stops answering ``/healthz`` a health signal. The states are the replica
supervisor's (``obs.events.REPLICA_STATES``): healthy -> degraded
(``degraded_after`` failed polls in a row, still routed to) ->
quarantined (``quarantine_after``, out of the rotation) -> probing (the
next poll of a quarantined backend) -> healthy on a poll that succeeds.
The thresholds come from ``programs/geometries.FLEET_DEFAULTS`` through
``FleetConfig``.

Every mutable field is guarded by the backend's ``_lock``
(``ordered_lock``); a transition is decided under it and returned for
the caller to act on after release.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.obs.events import REPLICA_STATES
from pvraft_tpu_torch.serve.loadgen import _endpoints, _get_json, _post_json

__all__ = ["BackendClient", "Backend"]

assert "healthy" in REPLICA_STATES  # the vocabulary this module speaks


class BackendClient:
    """Thin stdlib HTTP client for one serve host.

    Wraps the load generator's client helpers, so the load generator
    and the router read ``Retry-After`` one way. No state: safe to call
    from any router thread (each call opens its own connection)."""

    def __init__(self, host: str, port: int,
                 predict_timeout_s: float = 60.0,
                 poll_timeout_s: float = 5.0):
        self.host = host
        self.port = int(port)
        self.predict_timeout_s = predict_timeout_s
        self.poll_timeout_s = poll_timeout_s

    @classmethod
    def from_target(cls, target: Any, predict_timeout_s: float = 60.0,
                    poll_timeout_s: float = 5.0) -> "BackendClient":
        """Accepts everything ``loadgen._endpoints`` does: "host:port"
        strings (URL spellings included), (host, port) tuples, or an
        object with ``host``/``port`` (e.g. a started server)."""
        (host, port), = _endpoints(None, [target])
        return cls(host, port, predict_timeout_s=predict_timeout_s,
                   poll_timeout_s=poll_timeout_s)

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def predict(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """Forward one predict body; returns the loadgen client shape
        ``{"status", "body", "retry_after", "trace_id"}``. Raises
        ``OSError`` on connect/timeout failures — the router's spillover
        signal."""
        return _post_json(self.host, self.port, "/predict", doc,
                          timeout=self.predict_timeout_s)

    def healthz(self) -> Dict[str, Any]:
        return _get_json(self.host, self.port, "/healthz",
                         timeout=self.poll_timeout_s)

    def metrics(self) -> Dict[str, Any]:
        return _get_json(self.host, self.port, "/metrics",
                         timeout=self.poll_timeout_s)

    def admin_reload(self, ckpt: str,
                     drain_timeout_s: float = 30.0) -> Dict[str, Any]:
        """``POST /admin/reload`` against this backend (the zero-
        downtime weight hot-swap). Generous timeout: the backend holds
        the response until in-flight batches drained."""
        return _post_json(self.host, self.port, "/admin/reload",
                          {"ckpt": ckpt, "drain_timeout_s": drain_timeout_s},
                          timeout=self.predict_timeout_s
                          + max(drain_timeout_s, 0.0))


class Backend:
    """Router-side record of one backend: client + health state + load
    accounting."""

    def __init__(self, index: int, client: BackendClient,
                 degraded_after: int = 1, quarantine_after: int = 3):
        self.index = int(index)
        self.client = client
        self.degraded_after = int(degraded_after)
        self.quarantine_after = int(quarantine_after)
        self._lock = ordered_lock("fleet.Backend._lock")
        self.state = "healthy"          # guarded-by: _lock
        self.consecutive_failures = 0   # guarded-by: _lock
        self.polls_total = 0            # guarded-by: _lock
        self.last_poll_ok = None        # guarded-by: _lock (monotonic ts)
        self.last_health: Optional[Dict[str, Any]] = None  # guarded-by: _lock
        # Polled load signal: the backend's /healthz in_flight (accepted
        # requests without a recorded outcome — queued + executing).
        self.queue_depth = 0            # guarded-by: _lock
        # Router-side load accounting: dispatches this router currently
        # has open against the backend, and their cost-surface-predicted
        # device-seconds (0.0 each when no surface is armed).
        self.outstanding = 0            # guarded-by: _lock
        self.outstanding_s = 0.0        # guarded-by: _lock
        # True while this backend serves canary weights (set by the
        # admin plane, read by the routing decision).
        self.canary = False             # guarded-by: _lock

    # ------------------------------------------------------------- health --

    def begin_probe(self) -> Optional[Tuple[str, str]]:
        """Mark a quarantined backend probing (the poll loop calls this
        right before it polls one). Returns the transition or None."""
        with self._lock:
            if self.state != "quarantined":
                return None
            self.state = "probing"
            return ("quarantined", "probing")

    def poll_succeeded(self, health: Dict[str, Any]
                       ) -> Optional[Tuple[str, str]]:
        """Record one successful ``/healthz`` poll; any non-healthy
        state recovers (probing included — a quarantined backend that
        answers its probe rejoins the rotation, the supervisor's revival
        semantics). Returns the transition or None."""
        depth = health.get("in_flight")
        with self._lock:
            self.polls_total += 1
            self.consecutive_failures = 0
            self.last_poll_ok = time.monotonic()
            self.last_health = health
            self.queue_depth = int(depth) if isinstance(depth, int) else 0
            if self.state == "healthy":
                return None
            old, self.state = self.state, "healthy"
            return (old, "healthy")

    def poll_failed(self) -> Optional[Tuple[str, str]]:
        """Record one failed poll (connect error, timeout, non-JSON).
        Returns the transition or None."""
        with self._lock:
            self.polls_total += 1
            self.consecutive_failures += 1
            old = self.state
            if old == "probing":
                # A failed probe re-quarantines; failures keep counting.
                self.state = "quarantined"
            elif self.consecutive_failures >= self.quarantine_after:
                self.state = "quarantined"
            elif self.consecutive_failures >= self.degraded_after:
                self.state = "degraded"
            return (old, self.state) if self.state != old else None

    @property
    def in_rotation(self) -> bool:
        """Routable: healthy or degraded (degraded still serves — the
        supervisor's 'visibly unhealthy, not dead' semantics)."""
        with self._lock:
            return self.state in ("healthy", "degraded")

    # --------------------------------------------------------------- load --

    def begin_dispatch(self, predicted_s: float) -> None:
        with self._lock:
            self.outstanding += 1
            self.outstanding_s += predicted_s

    def end_dispatch(self, predicted_s: float) -> None:
        with self._lock:
            self.outstanding -= 1
            self.outstanding_s = max(0.0, self.outstanding_s - predicted_s)

    def load_score(self, predicted_s: float) -> Tuple[float, int, int]:
        """Sort key for routing: predicted outstanding device-seconds
        (router-side in-flight plus the polled backend queue priced at
        this request's predicted cost), then raw counts, then index (a
        stable tie-break keeps the no-surface path deterministic)."""
        with self._lock:
            priced = self.outstanding_s + self.queue_depth * predicted_s
            return (priced, self.outstanding + self.queue_depth, self.index)

    def snapshot(self) -> Dict[str, Any]:
        """One /healthz row (and the Prometheus gauge source)."""
        with self._lock:
            health = self.last_health or {}
            return {
                "backend": self.index,
                "endpoint": self.client.endpoint,
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "polls_total": self.polls_total,
                "queue_depth": self.queue_depth,
                "outstanding": self.outstanding,
                "outstanding_s": round(self.outstanding_s, 6),
                "canary": self.canary,
                # Pass-through provenance from the backend's own
                # /healthz: weights digest/epoch (the hot-swap evidence)
                # and the pool supervision summary.
                "weights": health.get("weights"),
                "pool": health.get("pool"),
            }

    def set_canary(self, canary: bool) -> None:
        with self._lock:
            self.canary = bool(canary)

    def is_canary(self) -> bool:
        with self._lock:
            return self.canary

    def buckets(self) -> Optional[List[int]]:
        """The backend's bucket table from its last good poll (None
        before the first one)."""
        with self._lock:
            if self.last_health is None:
                return None
            b = self.last_health.get("buckets")
            return list(b) if isinstance(b, list) else None

    def dtype(self) -> Optional[str]:
        with self._lock:
            if self.last_health is None:
                return None
            d = self.last_health.get("dtype")
            return d if isinstance(d, str) else None
