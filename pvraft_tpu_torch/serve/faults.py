"""Deterministic fault injection for the serve plane (port of
``pvraft_tpu/serve/faults.py``).

Named **fault points** sit in the replica executor, the batcher and the
supervisor's probe (:data:`FAULT_POINTS`, the JAX package's vocabulary):

  ``replica_predict_error``   raise from a replica's dispatch or probe
  ``replica_latency_ms``      sleep ``value`` ms inside the dispatch
  ``replica_wedge``           block the dispatch until the plan clears
  ``queue_stall``             sleep ``value`` ms in a bucket collector
  ``compile_trip``            a compile after the seal: the batcher's
                              dispatch fires it after the replay
                              (``batcher.py::MicroBatcher._dispatch``) and
                              counts one compile on the retrace watchdog
                              (``RetraceWatchdog.inject_compile``), so the
                              trip takes the watchdog's real path

A point is **armed** only by an installed :class:`FaultPlan`: a
deterministic schedule of :class:`FaultRule` records. A rule fires on the
``nth`` traversal of its point (counted per replica when the rule names
one, else globally), again every ``every`` traversals after that, at most
``max_fires`` times, and only ``after_s`` seconds past install.

Disarmed, :func:`fire` is one attribute read and a ``None`` check. The
plan is process-global (:func:`install_plan`, :func:`clear_plan`, the
:func:`injected` context manager). Each firing is handed to the caller's
``on_fire`` (the service's ``fault_injected`` event), then its effect
(sleep, block, raise) runs, both outside the injector's lock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock

# The JAX package's fault_injected.point vocabulary
# (pvraft_tpu/obs/events.py::FAULT_POINTS).
FAULT_POINTS = (
    "replica_predict_error", "replica_latency_ms", "replica_wedge",
    "queue_stall", "compile_trip")


# The sink of a firing's record (``ServeTelemetry.emit_fault``).
OnFire = Callable[[Dict[str, Any]], None]


class InjectedFaultError(RuntimeError):
    """The effect of a fired ``replica_predict_error`` point: a type of
    its own, so an injected failure is told from a real one."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One firing schedule for one fault point. ``nth`` is 1-based;
    ``every=0`` fires once; ``max_fires=0`` is unlimited; ``value`` is
    milliseconds for ``replica_latency_ms``/``queue_stall`` and the
    longest block in seconds for ``replica_wedge`` (0: until the plan
    clears)."""

    point: str
    nth: int = 1
    every: int = 0
    after_s: float = 0.0
    replica: Optional[int] = None
    value: float = 0.0
    max_fires: int = 0

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; known points: "
                f"{FAULT_POINTS}")
        if self.nth < 1:
            raise ValueError("nth is 1-based and must be >= 1")
        if self.every < 0 or self.max_fires < 0 or self.after_s < 0:
            raise ValueError("every/max_fires/after_s must be >= 0")
        if self.value < 0:
            raise ValueError("value must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable set of fault rules, installed as one unit."""

    rules: Tuple[FaultRule, ...]

    def __init__(self, rules):
        object.__setattr__(self, "rules", tuple(rules))
        if not self.rules:
            raise ValueError("a FaultPlan needs at least one rule")
        for rule in self.rules:
            if not isinstance(rule, FaultRule):
                raise TypeError(f"not a FaultRule: {rule!r}")

    def describe(self) -> List[Dict[str, Any]]:
        """Plain data for /healthz."""
        return [dataclasses.asdict(r) for r in self.rules]


class _Injector:
    """Process-global fault-point state. ``_plan`` is written under
    ``_lock`` and read bare on the hot path: a traversal racing a clear
    fires once more or not at all, both legitimate schedules."""

    def __init__(self):
        self._lock = ordered_lock("serve.faults._Injector._lock")
        self._plan: Optional[FaultPlan] = None
        self._installed_at = 0.0  # guarded-by: _lock
        # Traversals per (point, replica) and (point, None).
        self._counts: Dict[Tuple[str, Optional[int]], int] = {}  # guarded-by: _lock
        self._rule_fires: List[int] = []  # guarded-by: _lock
        self._fired_total = 0  # guarded-by: _lock
        # Set at clear, so wedged traversals resume.
        self._release = threading.Event()

    def install(self, plan: FaultPlan) -> None:
        with self._lock:
            if self._plan is not None:
                raise RuntimeError(
                    "a FaultPlan is already installed; clear_plan() first")
            self._counts = {}
            self._rule_fires = [0] * len(plan.rules)
            self._fired_total = 0
            self._installed_at = time.monotonic()
            self._release = threading.Event()
            self._plan = plan

    def clear(self) -> None:
        with self._lock:
            self._plan = None
            self._counts = {}
            self._rule_fires = []
            self._fired_total = 0
            release = self._release
        release.set()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            plan = self._plan
            return {
                "armed": plan is not None,
                "rules": plan.describe() if plan is not None else [],
                "fired_total": self._fired_total,
                "rule_fires": list(self._rule_fires),
            }

    def fire(self, point: str, replica: Optional[int],
             bucket: Optional[int], on_fire: Optional[OnFire]
             ) -> Tuple[Dict[str, Any], ...]:
        now = time.monotonic()
        fired: List[Tuple[FaultRule, Dict[str, Any]]] = []
        with self._lock:
            plan = self._plan
            if plan is None:  # cleared since the caller's check
                return ()
            release = self._release
            self._counts[(point, None)] = \
                self._counts.get((point, None), 0) + 1
            if replica is not None:
                self._counts[(point, replica)] = \
                    self._counts.get((point, replica), 0) + 1
            for idx, rule in enumerate(plan.rules):
                if rule.point != point:
                    continue
                if rule.replica is not None and rule.replica != replica:
                    continue
                n = self._counts[(point, rule.replica)]
                if rule.after_s and now - self._installed_at < rule.after_s:
                    continue
                if n < rule.nth:
                    continue
                if rule.every == 0:
                    if n != rule.nth:
                        continue
                elif (n - rule.nth) % rule.every != 0:
                    continue
                if rule.max_fires and self._rule_fires[idx] >= rule.max_fires:
                    continue
                self._rule_fires[idx] += 1
                self._fired_total += 1
                fired.append((rule, {
                    "point": point,
                    "traversal": n,
                    "fires": self._fired_total,
                    **({"replica": replica} if replica is not None else {}),
                    **({"bucket": bucket} if bucket is not None else {}),
                    **({"value": rule.value} if rule.value else {}),
                }))
        if on_fire is not None:
            for _, rec in fired:
                on_fire(rec)
        for rule, rec in fired:
            if point in ("replica_latency_ms", "queue_stall"):
                time.sleep(rule.value / 1000.0)
            elif point == "replica_wedge":
                # Until the plan clears or the rule's bound; 60 s at most,
                # so a forgotten plan cannot hang a process.
                release.wait(rule.value if rule.value > 0 else 60.0)
            elif point == "replica_predict_error":
                raise InjectedFaultError(
                    f"injected fault: {point} (traversal "
                    f"{rec['traversal']}, replica {replica})")
        return tuple(rec for _, rec in fired)


_INJECTOR = _Injector()


def fire(point: str, replica: Optional[int] = None,
         bucket: Optional[int] = None, on_fire: Optional[OnFire] = None
         ) -> Tuple[Dict[str, Any], ...]:
    """Traverse one fault point. Disarmed: returns ``()``, nothing counted
    or locked. Armed: counts the traversal and fires every matching rule
    (``on_fire(record)`` per firing, then the effect;
    ``replica_predict_error`` raises :class:`InjectedFaultError`); the
    records are returned."""
    if _INJECTOR._plan is None:
        return ()
    return _INJECTOR.fire(point, replica, bucket, on_fire)


def replica_faults(replica: int, bucket: Optional[int] = None,
                   on_fire: Optional[OnFire] = None) -> None:
    """The replica points in order, latency -> wedge -> error: what the
    batcher's dispatch and the supervisor's probe traverse, so an armed
    replica fault fails the probe too."""
    if _INJECTOR._plan is None:
        return
    for point in ("replica_latency_ms", "replica_wedge",
                  "replica_predict_error"):
        fire(point, replica=replica, bucket=bucket, on_fire=on_fire)


def install_plan(plan: FaultPlan) -> None:
    """Arm the process-global fault plan (one at a time)."""
    _INJECTOR.install(plan)


def clear_plan() -> None:
    """Disarm: traversals stop counting, wedged threads resume."""
    _INJECTOR.clear()


def plan_snapshot() -> Dict[str, Any]:
    """Armed state and fire counts (``/healthz`` ``faults``)."""
    return _INJECTOR.snapshot()


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Install ``plan`` for the block; always clear."""
    install_plan(plan)
    try:
        yield
    finally:
        clear_plan()
