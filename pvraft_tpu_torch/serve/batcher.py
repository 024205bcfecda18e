"""Continuous micro-batching across the replica pool, with backpressure
(port of ``pvraft_tpu/serve/batcher.py``).

Three tiers of threads:

  * one **collector** per bucket takes requests off its bucket's bounded
    queue and forms groups (up to ``max_batch``, straggler window
    ``max_wait_ms``), but never executes;
  * one bounded **batch queue** hands formed groups to the pool (its
    capacity is the replica count; anything beyond stays as requests in
    the bucket queues, where ``queue_depth`` governs intake);
  * one **executor** per replica takes the next formed group, whatever
    its bucket, and runs it on its replica (work-stealing: a slow
    large-bucket batch holds one replica while the others drain the
    small buckets).

A collector waits out the straggler window only while every replica is
busy (``eager_when_idle``); with idle capacity a group dispatches at
once. A full bucket queue raises :class:`QueueFullError` at ``submit``
(HTTP 503) instead of blocking the caller. ``shutdown(drain=True)``
stops intake and serves every queued request; ``drain=False`` fails them
with :class:`ShutdownError`.

With a supervisor (``serve/supervisor.py``) dispatch outcomes feed its
state machine, quarantined replicas leave the rotation, a failed batch
is retried once on another replica, and admission shrinks with the
healthy count (:class:`PoolUnavailableError` when none is left). The
fault points (``serve/faults.py``) fire where they fire in JAX: the
collector's ``queue_stall``, the replica points before each dispatch,
outside the replica's lock, and ``compile_trip`` after the replay.

Observability (wired by ``build_service``): a ``telemetry`` sink gets
``serve_batch``, ``serve_reject``, ``fault_injected`` and, once,
``serve_shutdown`` records; a traced request (``submit(..., trace=)``)
gets its ``validate`` mark at submit and ``queue_wait``, ``batch_form``
and ``device_execute`` marks at dispatch, ``device_execute`` ending once
the flow is on the host and wrapped in
``torch.profiler.record_function("device_execute")``; a sealed retrace
``watchdog`` is checked once per dispatch over that dispatch's window. A
strict watchdog's :class:`~pvraft_tpu_torch.obs.retrace.RetraceError`
fails the batch (HTTP 500) and is not counted against the replica. The
JAX batcher's cost plane arrives with ROADMAP queue 1 item 9c.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.obs.retrace import RetraceError
from pvraft_tpu_torch.serve import faults
from pvraft_tpu_torch.serve.engine import RequestError


class QueueFullError(RuntimeError):
    """The bucket's queue is at capacity: shed load (HTTP 503)."""


class ShutdownError(RuntimeError):
    """The batcher no longer accepts requests (HTTP 503)."""


class PoolUnavailableError(RuntimeError):
    """Every replica is quarantined: rejected at admission (HTTP 503
    ``unavailable`` with ``Retry-After``)."""


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_batch: int = 4        # largest group per dispatch
    max_wait_ms: float = 5.0  # straggler wait once a group has a member
    queue_depth: int = 64     # per-bucket bounded queue capacity
    # Dispatch a partial group at once when a replica is idle and no
    # formed batch waits; False always waits out max_wait_ms.
    eager_when_idle: bool = True

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")


class _Request:
    __slots__ = ("pc1", "pc2", "result", "error", "done", "t_enqueue",
                 "t_dequeue", "abandoned", "trace", "bucket", "_final",
                 "_finalized")

    def __init__(self, pc1: np.ndarray, pc2: np.ndarray):
        self.pc1 = pc1
        self.pc2 = pc2
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.abandoned = False
        # Host clock at submit and when a collector took the request: its
        # queue wait.
        self.t_enqueue = time.monotonic()
        self.t_dequeue: Optional[float] = None
        # The request's obs.trace.RequestTrace when it is sampled, and its
        # bucket (the stage histograms' label).
        self.trace = None
        self.bucket: Optional[int] = None
        # Exactly one party (the dispatch counting a response, or the
        # failure path) records this request's outcome: the first to set
        # _finalized under _final, which is only ever tried, never waited
        # for, and held for the test-and-set alone.
        self._final = ordered_lock("_Request._final")
        self._finalized = False  # guarded-by: _final

    def finalize(self) -> bool:
        """True exactly once, for the party that records the outcome (a
        party that finds another one setting the flag has lost)."""
        if not self._final.acquire(blocking=False):
            return False
        try:
            won, self._finalized = not self._finalized, True
            return won
        finally:
            self._final.release()

    def resolve(self, result: np.ndarray) -> None:
        self.result = result
        self.done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            # The waiter is gone (504 sent): an executor skips it.
            self.abandoned = True
            raise TimeoutError("predict did not complete in time")
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result


class MicroBatcher:
    """Bucket collectors -> batch queue -> per-replica executors."""

    def __init__(self, engine, cfg: BatcherConfig, telemetry=None,
                 metrics=None, watchdog=None, supervisor=None):
        largest = max(engine.cfg.batch_sizes)
        if cfg.max_batch > largest:
            raise ValueError(
                f"max_batch={cfg.max_batch} exceeds the largest captured "
                f"batch size {largest}: the engine has no program for a "
                f"bigger group")
        self.engine = engine
        self.cfg = cfg
        self.telemetry = telemetry
        self.metrics = metrics
        self.watchdog = watchdog
        self.supervisor = supervisor
        # The engine's replicas, or the engine itself as one executor
        # (test doubles without a pool).
        self.replicas = list(getattr(engine, "replicas", ()) or ()) \
            or [engine]
        self._queues: Dict[int, "queue.Queue[_Request]"] = {
            b: queue.Queue(maxsize=cfg.queue_depth)
            for b in engine.cfg.buckets}
        self._batchq: "queue.Queue[Tuple[int, List[_Request]]]" = \
            queue.Queue(maxsize=len(self.replicas))
        self._stopping = threading.Event()
        # Makes {stopping check -> enqueue} atomic against shutdown
        # setting the flag, so no accepted request is stranded.
        self._intake_lock = ordered_lock("MicroBatcher._intake_lock")
        self._drain = True
        self._count_lock = ordered_lock("MicroBatcher._count_lock")
        self._served = 0    # guarded-by: _count_lock
        self._rejected = 0  # guarded-by: _count_lock
        self._drained = 0   # guarded-by: _count_lock
        self._busy = 0      # guarded-by: _count_lock
        self._replica_inflight = [0] * len(self.replicas)  # guarded-by: _count_lock
        self._replica_batches = [0] * len(self.replicas)   # guarded-by: _count_lock
        self._collectors_live = len(engine.cfg.buckets)    # guarded-by: _count_lock
        self._executors_live = len(self.replicas)          # guarded-by: _count_lock
        self._retries = 0                                  # guarded-by: _count_lock
        self._collectors = [
            threading.Thread(target=self._collector, args=(b,),
                             name=f"pvraft-serve-b{b}", daemon=True)
            for b in engine.cfg.buckets
        ]
        self._executors = [
            threading.Thread(target=self._executor, args=(i,),
                             name=f"pvraft-serve-r{i}", daemon=True)
            for i in range(len(self.replicas))
        ]
        for t in (*self._collectors, *self._executors):
            t.start()

    # ------------------------------------------------------------- intake --

    def submit(self, pc1: np.ndarray, pc2: np.ndarray,
               trace=None) -> _Request:
        """Validate and enqueue one request; its handle's ``wait()``
        yields the un-padded (n1, 3) flow. Raises :class:`RequestError`,
        :class:`QueueFullError`, :class:`PoolUnavailableError` or
        :class:`ShutdownError`. ``trace`` (an ``obs.trace.RequestTrace``)
        gets the ``validate`` mark here and the dispatch's marks later."""
        t_validate = time.monotonic()
        try:
            bucket = self.engine.validate_request(pc1, pc2)
        except RequestError as e:
            if trace is not None:
                trace.mark("validate", t_validate, time.monotonic(),
                           attrs={"rejected": e.reason})
            self._reject(e.reason)
            raise
        if trace is not None:
            trace.mark("validate", t_validate, time.monotonic())
        req = _Request(np.asarray(pc1, np.float32),
                       np.asarray(pc2, np.float32))
        req.trace = trace
        req.bucket = bucket
        n_points = max(pc1.shape[0], pc2.shape[0])
        reject = None
        effective_depth = self.cfg.queue_depth
        with self._intake_lock:
            if self._stopping.is_set():
                reject = "shutdown"
            else:
                # Admission scales with the replicas still in rotation.
                serving = (self.supervisor.serving_count()
                           if self.supervisor is not None
                           else len(self.replicas))
                if serving == 0:
                    reject = "unavailable"
                else:
                    effective_depth = max(
                        1, (self.cfg.queue_depth * serving
                            + len(self.replicas) - 1)
                        // len(self.replicas))
                    if self._queues[bucket].qsize() >= effective_depth:
                        reject = "queue_full"
                    else:
                        # Counted before a worker can see it, so a
                        # snapshot never has more responses than requests.
                        if self.metrics is not None:
                            self.metrics.record_submit(
                                bucket, n_points=n_points)
                        self._queues[bucket].put_nowait(req)
        if reject == "shutdown":
            self._reject("shutdown")
            raise ShutdownError("server is shutting down")
        if reject == "unavailable":
            self._reject("unavailable", bucket=bucket)
            raise PoolUnavailableError(
                "every replica is quarantined; the pool sheds load "
                "until a probe revives one") from None
        if reject == "queue_full":
            self._reject("queue_full", bucket=bucket,
                         queue_depth=effective_depth)
            raise QueueFullError(
                f"bucket {bucket} queue is full "
                f"({effective_depth} of {self.cfg.queue_depth} slots "
                f"admissible at current pool health)") from None
        return req

    def record_reject(self, reason: str) -> None:
        """Count a reject that never reached ``submit`` (the HTTP layer's
        body checks)."""
        self._reject(reason)

    def record_failure(self, reason: str) -> None:
        """Count an accepted request that produced no response. A caller
        holding the handle goes through :meth:`record_failure_for`."""
        with self._count_lock:
            self._rejected += 1
        if self.metrics is not None:
            self.metrics.record_failure(reason)
        if self.telemetry is not None:
            self.telemetry.emit_reject(reason)

    def record_failure_for(self, req: _Request, reason: str) -> None:
        """Record an accepted request's failure, unless a dispatch already
        counted it as a response (whoever wins ``finalize`` records)."""
        if req.finalize():
            self.record_failure(reason)

    def _reject(self, reason: str, bucket: Optional[int] = None,
                queue_depth: Optional[int] = None) -> None:
        with self._count_lock:
            self._rejected += 1
        if self.metrics is not None:
            self.metrics.record_reject(reason)
        if self.telemetry is not None:
            self.telemetry.emit_reject(reason, bucket=bucket,
                                       queue_depth=queue_depth)

    def queue_depths(self) -> Dict[int, int]:
        return {b: q.qsize() for b, q in self._queues.items()}

    def batch_queue_depth(self) -> int:
        return self._batchq.qsize()

    def replica_stats(self) -> List[Dict[str, Any]]:
        """Per replica: device id, requests executing, batches served,
        and the supervisor's state when one is wired (read before
        ``_count_lock``; the two locks never nest)."""
        health = (self.supervisor.states()
                  if self.supervisor is not None else None)
        with self._count_lock:
            rows = [{"replica": i,
                     "device_id": int(getattr(r, "device_id", i)),
                     "in_flight": self._replica_inflight[i],
                     "batches_total": self._replica_batches[i]}
                    for i, r in enumerate(self.replicas)]
        if health is not None:
            for row, h in zip(rows, health):
                row["state"] = h["state"]
        return rows

    # -------------------------------------------------------- collectors --

    def _capacity_idle(self) -> bool:
        """True when a formed group would start at once."""
        with self._count_lock:
            busy = self._busy
        serving = (self.supervisor.serving_count()
                   if self.supervisor is not None else len(self.replicas))
        return busy < serving and self._batchq.empty()

    def _collect(self, q: "queue.Queue[_Request]") -> List[_Request]:
        """One group: wait briefly for a first request (so the stop flag
        is polled), then gather up to max_batch."""
        try:
            first = q.get(timeout=0.05)
        except queue.Empty:
            return []
        first.t_dequeue = time.monotonic()
        group = [first]
        deadline = first.t_dequeue + self.cfg.max_wait_ms / 1000.0
        while len(group) < self.cfg.max_batch:
            try:
                req = q.get_nowait()
            except queue.Empty:
                if self.cfg.eager_when_idle and self._capacity_idle():
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # Eager mode polls in short slices so it notices an
                # executor freeing up; the other waits the whole window.
                wait_s = (min(remaining, 0.002)
                          if self.cfg.eager_when_idle else remaining)
                try:
                    req = q.get(timeout=wait_s)
                except queue.Empty:
                    continue
            req.t_dequeue = time.monotonic()
            group.append(req)
        return group

    def _collector(self, bucket: int) -> None:
        q = self._queues[bucket]
        try:
            while True:
                group = self._collect(q)
                if not group:
                    if self._stopping.is_set():
                        if not self._drain or q.empty():
                            break
                    continue
                if self._stopping.is_set() and not self._drain:
                    self._fail_group(group)
                    continue
                faults.fire("queue_stall", bucket=bucket,
                            on_fire=self._on_fault)
                self._enqueue_batch(bucket, group)
        finally:
            with self._count_lock:
                self._collectors_live -= 1

    def _enqueue_batch(self, bucket: int, group: List[_Request]) -> None:
        """Hand a formed group to the pool; blocks while the batch queue
        is full (submit has returned already)."""
        while True:
            try:
                self._batchq.put((bucket, group), timeout=0.05)
                return
            except queue.Full:
                if self._stopping.is_set() and not self._drain:
                    self._fail_group(group)
                    return
                if self._stopping.is_set():
                    # Draining with every executor gone (all replicas
                    # quarantined exit at stop): serve the group here.
                    with self._count_lock:
                        executors_done = self._executors_live == 0
                    if executors_done:
                        self._dispatch(0, self.replicas[0], bucket, group)
                        return

    def _fail_group(self, group: List[_Request]) -> None:
        for req in group:
            if req.finalize():
                self.record_failure("shutdown")
                req.fail(ShutdownError("server stopped without drain"))

    # --------------------------------------------------------- executors --

    def _executor(self, index: int) -> None:
        replica = self.replicas[index]
        try:
            while True:
                if (self.supervisor is not None
                        and not self.supervisor.in_rotation(index)):
                    # Parked out of the rotation; only the probe touches
                    # this replica. At stop it exits at once.
                    if self._stopping.is_set():
                        break
                    time.sleep(0.02)
                    continue
                try:
                    bucket, group = self._batchq.get(timeout=0.05)
                except queue.Empty:
                    if self._stopping.is_set():
                        with self._count_lock:
                            collectors_done = self._collectors_live == 0
                        if collectors_done and self._batchq.empty():
                            break
                    continue
                if self._stopping.is_set() and not self._drain:
                    self._fail_group(group)
                    continue
                self._dispatch(index, replica, bucket, group)
        finally:
            with self._count_lock:
                self._executors_live -= 1

    def _on_fault(self, record: Dict[str, Any]) -> None:
        """The ``fault_injected`` sink of the batcher's fault points."""
        if self.telemetry is not None:
            self.telemetry.emit_fault(**record)

    def _dispatch(self, index: int, replica, bucket: int,
                  group: List[_Request], retried: bool = False) -> None:
        # Skip requests whose waiter timed out already.
        group = [r for r in group if not r.abandoned]
        if not group:
            return
        t0 = time.monotonic()
        # The watchdog's window: only a compile during this dispatch trips.
        window = (self.watchdog.global_compiles()
                  if self.watchdog is not None else 0)
        with self._count_lock:
            self._busy += 1
            self._replica_inflight[index] += len(group)
        token = None
        if self.supervisor is not None:
            token = self.supervisor.note_dispatch_start(index, t0)
        failure: Optional[BaseException] = None
        try:
            # The replica's fault points, outside its lock (the probe
            # traverses the same ones).
            faults.replica_faults(index, bucket=bucket,
                                  on_fire=self._on_fault)
            # predict_batch returns once the flow is on the host.
            with torch.profiler.record_function("device_execute"):
                flows = replica.predict_batch(
                    [(r.pc1, r.pc2) for r in group], bucket)
            if self.watchdog is not None:
                if faults.fire("compile_trip", replica=index, bucket=bucket,
                               on_fire=self._on_fault):
                    self.watchdog.inject_compile()
                self._watchdog_check(bucket, len(group), window)
        except BaseException as e:  # noqa: BLE001 — fail or retry the group, not the executor
            failure = e
        finally:
            if self.supervisor is not None:
                self.supervisor.note_dispatch_end(index, token)
            with self._count_lock:
                self._busy -= 1
                self._replica_inflight[index] -= len(group)
        if failure is not None:
            self._dispatch_failed(index, bucket, group, failure, retried)
            return
        now = time.monotonic()
        if self.supervisor is not None:
            self.supervisor.record_success(index, bucket, now - t0)
        # A waiter may have timed out while the replica ran: such a
        # request is neither counted as served nor resolved.
        live = [(r, f) for r, f in zip(group, flows)
                if not r.abandoned and r.finalize()]
        bs = self.engine.batch_size_for(len(group))
        device_id = int(getattr(replica, "device_id", index))
        for r, _ in live:
            tr = r.trace
            if tr is None or r.abandoned:
                continue
            # Marked before resolve(), which the handler waits on.
            t_dq = r.t_dequeue if r.t_dequeue is not None else t0
            tr.mark("queue_wait", r.t_enqueue, t_dq)
            tr.mark("batch_form", t_dq, t0)
            tr.mark("device_execute", t0, now,
                    attrs={"bucket": bucket, "batch": bs, "n": len(group),
                           "replica": index, "device_id": device_id})
        latencies = [(now - r.t_enqueue) * 1000.0 for r, _ in live]
        # Counted before resolving: a client that reads /metrics right
        # after its answer sees it counted.
        with self._count_lock:
            self._served += len(live)
            self._replica_batches[index] += 1
            if self._stopping.is_set():
                self._drained += len(live)
        fill = len(group) / bs
        if self.metrics is not None:
            self.metrics.record_batch(len(live), fill, latencies)
        if self.telemetry is not None:
            self.telemetry.emit_batch(
                bucket=bucket, batch=bs, n=len(live), fill=round(fill, 4),
                latency_ms=round((now - t0) * 1000.0, 3),
                queue_depth=self._queues[bucket].qsize(), replica=index,
                device_id=device_id)
        for req, flow in live:
            req.resolve(flow)

    def _dispatch_failed(self, index: int, bucket: int,
                         group: List[_Request], error: BaseException,
                         retried: bool) -> None:
        """A dispatch raised: tell the supervisor, then retry the batch
        once on another in-rotation replica; a retried batch (or one with
        no healthy sibling) fails. A strict watchdog's
        :class:`RetraceError` fails the batch without touching the
        supervisor: the replay succeeded, and the compile it reports is
        the process's, which a retry would meet again."""
        if self.supervisor is not None \
                and not isinstance(error, RetraceError):
            self.supervisor.record_failure(index,
                                           reason=type(error).__name__)
            if not retried:
                target = self.supervisor.retry_target(exclude=index)
                if target is not None:
                    with self._count_lock:
                        self._retries += 1
                    if self.metrics is not None:
                        self.metrics.record_retry()
                    self._dispatch(target, self.replicas[target], bucket,
                                   group, retried=True)
                    return
        for req in group:
            req.fail(error)

    def _watchdog_check(self, bucket: int, n: int, window: int) -> None:
        """The per-dispatch retrace check; every trip counts on
        ``/metrics``, a strict one before it raises."""
        try:
            trips = self.watchdog.check(
                signature=f"bucket={bucket} n={n}",
                program=f"serve_dispatch_b{bucket}", window_start=window)
        except RetraceError:
            if self.metrics is not None:
                self.metrics.record_recompile()
            raise
        if self.metrics is not None:
            for _ in trips:
                self.metrics.record_recompile()

    # ----------------------------------------------------------- shutdown --

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop intake; ``drain=True`` serves queued work first. Safe to
        call twice; the first call emits the ``serve_shutdown`` record."""
        with self._intake_lock:
            already = self._stopping.is_set()
            self._drain = drain
            self._stopping.set()
        for t in self._collectors:
            t.join(timeout)
        for t in self._executors:
            t.join(timeout)
        if drain:
            # Nothing should be left; serve any straggler on replica 0 so
            # a drained shutdown never strands an accepted request.
            while True:
                try:
                    bucket, group = self._batchq.get_nowait()
                except queue.Empty:
                    break
                self._dispatch(0, self.replicas[0], bucket, group)
            for bucket, q in self._queues.items():
                while True:
                    group: List[_Request] = []
                    while len(group) < self.cfg.max_batch:
                        try:
                            group.append(q.get_nowait())
                        except queue.Empty:
                            break
                    if not group:
                        break
                    self._dispatch(0, self.replicas[0], bucket, group)
        else:
            while True:
                try:
                    _, group = self._batchq.get_nowait()
                except queue.Empty:
                    break
                self._fail_group(group)
            for q in self._queues.values():
                while True:
                    try:
                        req = q.get_nowait()
                    except queue.Empty:
                        break
                    self._fail_group([req])
        if self.telemetry is not None and not already:
            counts = self.counts
            self.telemetry.emit_shutdown(served=counts["served"],
                                         rejected=counts["rejected"],
                                         drained=counts["drained"])

    @property
    def counts(self) -> Dict[str, int]:
        with self._count_lock:
            return {"served": self._served, "rejected": self._rejected,
                    "drained": self._drained, "retries": self._retries}
