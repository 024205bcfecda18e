"""Per-replica health supervision (port of
``pvraft_tpu/serve/supervisor.py``).

Each replica walks ``healthy -> degraded -> quarantined -> probing ->
healthy`` (:data:`REPLICA_STATES`), driven by what the batcher's
dispatches report:

* **hard failures**: ``degraded_after`` consecutive failed dispatches
  mark a replica degraded (it still serves), ``quarantine_after`` take it
  out of the work-stealing rotation;
* **latency outliers**: a dispatch slower than ``latency_outlier_factor``
  x its bucket's moving average (after ``latency_min_samples``, above
  ``latency_floor_ms``); ``latency_outlier_after`` in a row degrade a
  replica, never quarantine it.

A dispatch still in flight after ``wedge_timeout_s`` quarantines its
replica (the wedge scan). Only the background **probe** revives a
quarantined replica: the engine's probe payload (``probe_request``)
through the replica's own smallest-bucket program, after the same fault
points a dispatch traverses, on a worker thread bounded by
``probe_timeout_s``. The faults run outside the replica's lock, so a
wedged fault never holds the lock a probe needs.

``/healthz`` reports the per-replica rows and :meth:`pool_health`; the
healthy count scales the batcher's admission. Thresholds are the JAX
package's declared defaults (:data:`SUPERVISOR_DEFAULTS`). With a
telemetry sink every transition is a ``replica_state`` event (with the
state it left and why) and every fault the probe fires a
``fault_injected`` one, emitted after the supervisor's lock is released.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.rng import DEFAULT_SEED, host_rng
from pvraft_tpu_torch.serve import faults

# pvraft_tpu/obs/events.py::REPLICA_STATES.
REPLICA_STATES = ("healthy", "degraded", "quarantined", "probing")

# pvraft_tpu/programs/geometries.py::SUPERVISOR_DEFAULTS.
SUPERVISOR_DEFAULTS = {
    "degraded_after": 1,
    "quarantine_after": 3,
    "latency_outlier_factor": 4.0,
    "latency_outlier_after": 4,
    "latency_min_samples": 8,
    "latency_floor_ms": 1.0,
    "probe_interval_s": 0.5,
    "probe_timeout_s": 10.0,
    "wedge_timeout_s": 30.0,
}


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """The state machine's trip points (:data:`SUPERVISOR_DEFAULTS`)."""

    degraded_after: int = SUPERVISOR_DEFAULTS["degraded_after"]
    quarantine_after: int = SUPERVISOR_DEFAULTS["quarantine_after"]
    latency_outlier_factor: float = \
        SUPERVISOR_DEFAULTS["latency_outlier_factor"]
    latency_outlier_after: int = SUPERVISOR_DEFAULTS["latency_outlier_after"]
    latency_min_samples: int = SUPERVISOR_DEFAULTS["latency_min_samples"]
    latency_floor_ms: float = SUPERVISOR_DEFAULTS["latency_floor_ms"]
    probe_interval_s: float = SUPERVISOR_DEFAULTS["probe_interval_s"]
    probe_timeout_s: float = SUPERVISOR_DEFAULTS["probe_timeout_s"]
    wedge_timeout_s: float = SUPERVISOR_DEFAULTS["wedge_timeout_s"]

    def __post_init__(self):
        if self.degraded_after < 1 or self.quarantine_after < 1:
            raise ValueError("failure thresholds must be >= 1")
        if self.quarantine_after < self.degraded_after:
            raise ValueError(
                "quarantine_after must be >= degraded_after (the state "
                "machine escalates, never skips backwards)")
        if self.latency_outlier_factor <= 1.0:
            raise ValueError("latency_outlier_factor must be > 1")
        if self.probe_interval_s < 0 or self.wedge_timeout_s <= 0 \
                or self.probe_timeout_s <= 0:
            raise ValueError(
                "probe_interval_s/probe_timeout_s/wedge_timeout_s invalid")

    @property
    def retry_after_s(self) -> int:
        """A 503's ``Retry-After``: one probe cycle, rounded up, >= 1 s."""
        return max(1, int(math.ceil(self.probe_interval_s)))


def _transition(states: List[str], replicas, i: int, new: str,
                reason: str) -> Dict[str, Any]:
    """Apply one transition to ``states`` and return its
    ``replica_state`` record. Module-level, and the caller holds the
    supervisor's lock: the lock analysis (threadcheck GC001) then sees
    every state mutation at a locked call site."""
    assert new in REPLICA_STATES
    old, states[i] = states[i], new
    return {"replica": i, "state": new, "from_state": old, "reason": reason,
            "device_id": int(getattr(replicas[i], "device_id", i))}


def _observe_latency(ewma: Dict[int, List[float]], cfg: SupervisorConfig,
                     bucket: int, seconds: float) -> bool:
    """Outlier decision and moving-average update for one dispatch (the
    caller holds the supervisor's lock). Outliers do not feed the
    average."""
    slot = ewma.setdefault(int(bucket), [0.0, 0])
    mean, count = slot[0], int(slot[1])
    outlier = (
        count >= cfg.latency_min_samples
        and seconds * 1000.0 > cfg.latency_floor_ms
        and seconds > cfg.latency_outlier_factor * mean)
    if not outlier:
        slot[0] = seconds if count == 0 else 0.8 * mean + 0.2 * seconds
        slot[1] = count + 1
    return outlier


class ReplicaSupervisor:
    """Health state per replica and the background probe and wedge-scan
    loop. The batcher's executors report concurrently with the probe
    thread; every state change happens under ``_lock``, and nothing is
    called out to while it is held: transitions are emitted to
    ``telemetry`` after its release."""

    def __init__(self, engine, cfg: Optional[SupervisorConfig] = None,
                 telemetry=None):
        self.engine = engine
        self.cfg = cfg or SupervisorConfig()
        self.telemetry = telemetry
        self.replicas = list(getattr(engine, "replicas", ()) or ()) \
            or [engine]
        n = len(self.replicas)
        self._lock = ordered_lock("ReplicaSupervisor._lock")
        self._state = ["healthy"] * n            # guarded-by: _lock
        self._fail_streak = [0] * n              # guarded-by: _lock
        self._outlier_streak = [0] * n           # guarded-by: _lock
        self._ewma: Dict[int, List[float]] = {}  # guarded-by: _lock
        # In-flight dispatch start times per replica, by token: a replica
        # can run its executor's dispatch and a sibling's retry at once.
        self._dispatch_started: List[Dict[int, float]] = \
            [{} for _ in range(n)]               # guarded-by: _lock
        self._dispatch_tokens = 0                # guarded-by: _lock
        self._transitions = 0                    # guarded-by: _lock
        self._probes = 0                         # guarded-by: _lock
        self._probe_failures = 0                 # guarded-by: _lock
        # The probe payload, built before any thread exists; doubles
        # without probe_request get the same cloud from the config.
        probe = getattr(engine, "probe_request", None)
        if probe is not None:
            self._probe_cloud, self._probe_bucket = probe()
        else:
            ecfg = self.engine.cfg
            scale = min(1.0, 0.5 * float(ecfg.coord_limit))
            rng = host_rng(DEFAULT_SEED, "serve.probe")
            self._probe_cloud = rng.uniform(
                -scale, scale,
                (max(int(ecfg.min_points), 1), 3)).astype(np.float32)
            self._probe_bucket = int(ecfg.buckets[0])
        self._stop = threading.Event()
        self._thread_lock = ordered_lock("ReplicaSupervisor._thread_lock")
        self._thread: Optional[threading.Thread] = None  # guarded-by: _thread_lock

    def _emit(self, transitions: List[Dict[str, Any]]) -> None:
        """Emit transitions decided under ``_lock``, after its release."""
        if self.telemetry is not None:
            for t in transitions:
                self.telemetry.emit_replica_state(**t)

    def _on_fault(self, record: Dict[str, Any]) -> None:
        """The probe's ``fault_injected`` sink (the batcher has its own)."""
        if self.telemetry is not None:
            self.telemetry.emit_fault(**record)

    # ------------------------------------------------------------ signals --

    def record_success(self, i: int, bucket: int, seconds: float) -> None:
        """A dispatch on replica ``i`` took ``seconds``: resets the failure
        streak, feeds the outlier signal, recovers a degraded replica. A
        quarantined or probing replica's straggler changes nothing."""
        transitions = []
        with self._lock:
            if self._state[i] in ("quarantined", "probing"):
                pass
            elif _observe_latency(self._ewma, self.cfg, bucket, seconds):
                self._outlier_streak[i] += 1
                if (self._state[i] == "healthy"
                        and self._outlier_streak[i]
                        >= self.cfg.latency_outlier_after):
                    transitions.append(_transition(
                        self._state, self.replicas, i,
                        "degraded", "latency_outlier"))
                    self._transitions += 1
            else:
                self._fail_streak[i] = 0
                self._outlier_streak[i] = 0
                if self._state[i] == "degraded":
                    transitions.append(_transition(
                        self._state, self.replicas, i, "healthy", "recovered"))
                    self._transitions += 1
        self._emit(transitions)

    def record_failure(self, i: int, reason: str = "dispatch_error") -> None:
        """A dispatch on replica ``i`` raised: healthy -> degraded ->
        quarantined on consecutive failures."""
        transitions = []
        with self._lock:
            if self._state[i] not in ("quarantined", "probing"):
                self._fail_streak[i] += 1
                if self._fail_streak[i] >= self.cfg.quarantine_after:
                    transitions.append(_transition(
                        self._state, self.replicas, i, "quarantined", reason))
                    self._transitions += 1
                elif (self._fail_streak[i] >= self.cfg.degraded_after
                      and self._state[i] == "healthy"):
                    transitions.append(_transition(
                        self._state, self.replicas, i, "degraded", reason))
                    self._transitions += 1
        self._emit(transitions)

    def note_dispatch_start(self, i: int, t: float) -> int:
        """Track one in-flight dispatch; returns its token for
        :meth:`note_dispatch_end`."""
        with self._lock:
            self._dispatch_tokens += 1
            token = self._dispatch_tokens
            self._dispatch_started[i][token] = t
        return token

    def note_dispatch_end(self, i: int, token: int) -> None:
        with self._lock:
            self._dispatch_started[i].pop(token, None)

    # ------------------------------------------------------------ queries --

    def state_of(self, i: int) -> str:
        with self._lock:
            return self._state[i]

    def in_rotation(self, i: int) -> bool:
        """Degraded replicas keep serving; quarantined and probing ones
        do not."""
        with self._lock:
            return self._state[i] in ("healthy", "degraded")

    def serving_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._state
                       if s in ("healthy", "degraded"))

    def retry_target(self, exclude: int) -> Optional[int]:
        """Another in-rotation replica (healthy first) for a failed
        batch's one retry, or None."""
        with self._lock:
            for want in ("healthy", "degraded"):
                for i, s in enumerate(self._state):
                    if i != exclude and s == want:
                        return i
        return None

    def states(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"replica": i, "state": self._state[i],
                     "fail_streak": self._fail_streak[i],
                     "outlier_streak": self._outlier_streak[i]}
                    for i in range(len(self.replicas))]

    def pool_health(self) -> Dict[str, Any]:
        """The ``/healthz`` ``pool`` block."""
        with self._lock:
            serving = sum(1 for s in self._state
                          if s in ("healthy", "degraded"))
            total = len(self._state)
        state = ("unavailable" if serving == 0
                 else "degraded" if serving < total else "ok")
        return {"state": state, "healthy_replicas": serving,
                "replicas_total": total,
                "probe_interval_s": self.cfg.probe_interval_s,
                "retry_after_s": self.cfg.retry_after_s}

    @property
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"transitions": self._transitions,
                    "probes": self._probes,
                    "probe_failures": self._probe_failures}

    # ------------------------------------------------------------- probes --

    def poll(self) -> None:
        """One pass: wedge scan, then a probe of every quarantined replica
        (public, so tests drive the machine without the thread)."""
        self._scan_wedged()
        self._probe_quarantined()

    def _scan_wedged(self) -> None:
        now = time.monotonic()
        transitions = []
        with self._lock:
            for i, starts in enumerate(self._dispatch_started):
                if (starts
                        and now - min(starts.values())
                        > self.cfg.wedge_timeout_s
                        and self._state[i] not in ("quarantined",
                                                   "probing")):
                    transitions.append(_transition(
                        self._state, self.replicas, i,
                        "quarantined", "wedged"))
                    self._transitions += 1
        self._emit(transitions)

    def _probe_quarantined(self) -> None:
        # A replica with a dispatch still in flight is stuck: probing it
        # would only stall this loop beside it.
        with self._lock:
            targets = [i for i, s in enumerate(self._state)
                       if s == "quarantined"
                       and not self._dispatch_started[i]]
        for i in targets:
            with self._lock:
                if self._state[i] != "quarantined":
                    continue
                transitions = [_transition(
                    self._state, self.replicas, i, "probing", "probe")]
                self._transitions += 1
                self._probes += 1
            self._emit(transitions)
            ok = self._probe(i)
            with self._lock:
                if self._state[i] != "probing":
                    continue
                if ok:
                    self._fail_streak[i] = 0
                    self._outlier_streak[i] = 0
                    transitions = [_transition(
                        self._state, self.replicas, i, "healthy", "probe_ok")]
                    self._transitions += 1
                else:
                    self._probe_failures += 1
                    transitions = [_transition(
                        self._state, self.replicas, i,
                        "quarantined", "probe_failed")]
                    self._transitions += 1
            self._emit(transitions)

    def _probe(self, i: int) -> bool:
        """The probe payload through replica ``i``'s smallest-bucket
        program, after its fault points, on a worker thread: a replica
        that hangs costs one ``probe_timeout_s`` and counts as failed;
        its late return changes nothing."""
        result: Dict[str, bool] = {}

        def run() -> None:
            try:
                faults.replica_faults(i, bucket=self._probe_bucket,
                                      on_fire=self._on_fault)
                self.replicas[i].predict_batch(
                    [(self._probe_cloud, self._probe_cloud)],
                    self._probe_bucket)
                result["ok"] = True
            except BaseException:  # noqa: BLE001 — a failed probe is a state
                result["ok"] = False

        worker = threading.Thread(target=run, daemon=True,
                                  name=f"pvraft-serve-probe-r{i}")
        worker.start()
        worker.join(self.cfg.probe_timeout_s)
        return bool(result.get("ok"))

    # ---------------------------------------------------------- lifecycle --

    def start(self) -> None:
        """Start the probe loop (not when ``probe_interval_s`` is 0)."""
        with self._thread_lock:
            if self.cfg.probe_interval_s <= 0 or self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pvraft-serve-supervisor",
                daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception:  # noqa: BLE001 — supervise, never crash serving
                pass
            self._stop.wait(self.cfg.probe_interval_s)

    def stop(self) -> None:
        # Joined under the lifecycle lock, which the loop never takes: a
        # concurrent start() cannot clear the flag under the old thread.
        with self._thread_lock:
            thread = self._thread
            if thread is None:
                return
            self._thread = None
            self._stop.set()
            thread.join(10.0)
