"""Serve telemetry: the service's ``pvraft_events/v1`` stream (port of
``pvraft_tpu/serve/events.py``).

One :class:`ServeTelemetry` per service writes a ``run_header`` and then
``serve_compile`` (one per captured program), ``serve_batch`` (one per
dispatched micro-batch), ``serve_reject``, ``span`` (traced requests),
``trace_window`` (``/debug/trace``), ``recompile`` (the retrace
watchdog), ``device_memory`` (the memory monitor), ``replica_state``
(the supervisor), ``fault_injected`` (fault plans), ``weight_swap``
(hot swaps) and ``serve_shutdown`` (the drain's summary), with the JAX
package's fields. Handler threads, executors, the supervisor and the
monitor emit concurrently, so every emit goes through one lock: the
stream's ``seq`` stays sequential.

With a cost surface armed, ``cost_calibration`` (one per priced
dispatch, ``serve/costing.py``). A fleet router (``fleet/router.py``)
writes ``fleet_route`` (one per routing decision) and ``canary_verdict``
(its canary gate's verdict) through the same class.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.obs.events import EventLog, given, run_metadata


class ServeTelemetry:
    """Thread-safe ``pvraft_events/v1`` writer of the serve lifecycle."""

    def __init__(self, events_path: str, cfg=None, enabled: bool = True):
        self._lock = ordered_lock("ServeTelemetry._lock")
        self.events = EventLog(events_path, enabled=enabled)  # guarded-by: _lock
        self.events.emit("run_header", **run_metadata(cfg, mode="serve"))

    def _emit(self, etype: str, **fields: Any) -> None:
        with self._lock:
            self.events.emit(etype, **fields)

    def emit_compile(self, bucket: int, batch: int, lower_s: float,
                     compile_s: float,
                     memory: Optional[Dict[str, Any]] = None,
                     dtype: Optional[str] = None,
                     replica: Optional[int] = None,
                     device_id: Optional[int] = None) -> None:
        """One captured program. The schema's ``lower_s`` and
        ``compile_s`` carry the port's warm-up and capture seconds
        (``GraphProgram.report()``'s ``warmup_s`` and ``capture_s``);
        ``memory`` carries the bytes the capture added to the graph pool
        (``{"pool_bytes": ...}``)."""
        self._emit("serve_compile", bucket=bucket, batch=batch,
                   lower_s=lower_s, compile_s=compile_s,
                   **given(memory=memory, dtype=dtype, replica=replica,
                           device_id=device_id))

    def emit_batch(self, bucket: int, batch: int, n: int, fill: float,
                   latency_ms: float, queue_depth: Optional[int] = None,
                   replica: Optional[int] = None,
                   device_id: Optional[int] = None) -> None:
        self._emit("serve_batch", bucket=bucket, batch=batch, n=n,
                   fill=fill, latency_ms=latency_ms,
                   **given(queue_depth=queue_depth, replica=replica,
                           device_id=device_id))

    def emit_reject(self, reason: str, bucket: Optional[int] = None,
                    queue_depth: Optional[int] = None) -> None:
        self._emit("serve_reject", reason=reason,
                   **given(bucket=bucket, queue_depth=queue_depth))

    def emit_trace_window(self, action: str, trace_dir: str) -> None:
        """A ``/debug/trace`` profiler window; serving has no epoch, so
        the schema's required ``epoch`` is -1."""
        self._emit("trace_window", action=action, trace_dir=trace_dir,
                   epoch=-1)

    def emit_span(self, **span: Any) -> None:
        """One span of a traced request, emitted by the handler after the
        response is written."""
        self._emit("span", **span)

    def emit_recompile(self, program: str, count: int,
                       baseline: Optional[int] = None,
                       signature: Optional[str] = None,
                       context: Optional[str] = None) -> None:
        """The sealed retrace watchdog saw a compile during a dispatch."""
        self._emit("recompile", program=program, count=count,
                   **given(baseline=baseline, signature=signature,
                           context=context))

    def emit_device_memory(self, devices: list,
                           context: Optional[str] = None) -> None:
        """One sample of the memory monitor (``obs/device_memory.py``)."""
        self._emit("device_memory", devices=devices,
                   **given(context=context))

    def emit_replica_state(self, replica: int, state: str,
                           from_state: Optional[str] = None,
                           reason: Optional[str] = None,
                           device_id: Optional[int] = None) -> None:
        """One transition of the supervisor's state machine."""
        self._emit("replica_state", replica=replica, state=state,
                   **given(from_state=from_state, reason=reason,
                           device_id=device_id))

    def emit_fault(self, point: str, replica: Optional[int] = None,
                   bucket: Optional[int] = None,
                   traversal: Optional[int] = None,
                   fires: Optional[int] = None,
                   value: Optional[float] = None) -> None:
        """One firing of a fault point (``serve/faults.py``)."""
        self._emit("fault_injected", point=point,
                   **given(replica=replica, bucket=bucket,
                           traversal=traversal, fires=fires, value=value))

    def emit_cost_calibration(self, bucket: int, batch: int, dtype: str,
                              predicted_s: float, measured_s: float,
                              platform: str, comparable: bool,
                              replica: Optional[int] = None,
                              basis: Optional[str] = None,
                              extrapolated: Optional[bool] = None,
                              program: Optional[str] = None) -> None:
        """One dispatch priced through the cost surface beside its
        measured wall-seconds. ``comparable`` may be true only on
        platform "tpu" (the validator rejects anything else)."""
        self._emit("cost_calibration", bucket=bucket, batch=batch,
                   dtype=dtype, predicted_s=predicted_s,
                   measured_s=measured_s, platform=platform,
                   comparable=comparable,
                   **given(replica=replica, basis=basis,
                           extrapolated=extrapolated, program=program))

    def emit_weight_swap(self, digest: str, epoch: int,
                         path: Optional[str] = None,
                         previous_digest: Optional[str] = None,
                         replicas: Optional[int] = None,
                         swap_ms: Optional[float] = None,
                         drained: Optional[int] = None) -> None:
        """One hot swap (``InferenceEngine.swap_params``); ``epoch`` is
        the checkpoint's or -1."""
        self._emit("weight_swap", digest=digest, epoch=epoch,
                   **given(path=path, previous_digest=previous_digest,
                           replicas=replicas, swap_ms=swap_ms,
                           drained=drained))

    def emit_fleet_route(self, backend: int, reason: str,
                         bucket: Optional[int] = None,
                         queue_depth: Optional[int] = None,
                         predicted_s: Optional[float] = None,
                         attempts: Optional[int] = None,
                         canary: Optional[bool] = None,
                         status: Optional[int] = None) -> None:
        """One routing decision of the fleet router: which backend got a
        request and why (``least_loaded``, ``spillover``, ``canary``,
        ``shadow``)."""
        self._emit("fleet_route", backend=backend, reason=reason,
                   **given(bucket=bucket, queue_depth=queue_depth,
                           predicted_s=predicted_s, attempts=attempts,
                           canary=canary, status=status))

    def emit_canary_verdict(self, verdict: str, epe: float, bound: float,
                            rel_epe: Optional[float] = None,
                            rel_bound: Optional[float] = None,
                            samples: Optional[int] = None,
                            fraction: Optional[float] = None,
                            canary_backend: Optional[int] = None,
                            baseline_backend: Optional[int] = None
                            ) -> None:
        """The router's canary gate fired: the mean EPE between canary
        and incumbent flows against its bound."""
        self._emit("canary_verdict", verdict=verdict, epe=epe, bound=bound,
                   **given(rel_epe=rel_epe, rel_bound=rel_bound,
                           samples=samples, fraction=fraction,
                           canary_backend=canary_backend,
                           baseline_backend=baseline_backend))

    def emit_shutdown(self, served: int, rejected: int,
                      drained: int) -> None:
        self._emit("serve_shutdown", served=served, rejected=rejected,
                   drained=drained)

    def close(self) -> None:
        with self._lock:
            self.events.close()
