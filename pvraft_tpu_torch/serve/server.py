"""The HTTP service (port of ``pvraft_tpu/serve/server.py``): a stdlib
``ThreadingHTTPServer`` over the micro-batcher. Handler threads block on
their request's completion while the batcher's executors dispatch, so
the queue depth bounds concurrency, not the HTTP layer.

Endpoints, with the JAX package's routes, bodies and status codes:

  ``POST /predict``
      JSON ``{"pc1": [[x, y, z], ...], "pc2": [...]}`` ->
      ``{"flow": [[x, y, z], ...], "n": n}``. With ``Content-Type:
      application/msgpack`` the body is a msgpack map whose ``pc1`` and
      ``pc2`` are raw little-endian float32 bytes, and so is the answer's
      ``flow`` (the port's own codec, ``engine/msgpack.py``). 400 for a
      contract violation, 413 for a request no bucket holds, 503 with
      ``Retry-After`` for a full queue, a quarantined pool or a shutdown,
      504 for a timeout. A sampled request (1 in ``trace_sample_every``)
      carries ``X-Pvraft-Trace: <trace id>``; its span tree
      (``obs/trace.py``) goes to the event stream once the response is
      written, whatever the status, and a 200's stages feed the
      per-(bucket, stage) histograms.
  ``GET /healthz``
      readiness: buckets, batch sizes, dtype, the supervisor's ``pool``
      block, the armed fault plan, per-replica rows, in-flight count,
      weights provenance, the captured programs and the ``telemetry``
      block (events path, tracing, sample rate, trace directory).
      ``cost`` and ``cost_surface`` stay null until the cost plane
      (ROADMAP queue 1 item 9c).
  ``GET /metrics``
      JSON (default) or ``?format=prometheus`` (``serve/metrics.py``).
  ``POST /admin/reload``
      ``{"ckpt": "<path>"}``: the engine's hot-swap without recapture
      (``InferenceEngine.reload_checkpoint``); returns the swap report.
      400 for a bad body or an unreadable checkpoint, 409 for weights of
      another structure (the served ones stay).
  ``GET /debug/trace?seconds=N``
      A ``torch.profiler`` window (CPU and CUDA activities) of N seconds,
      N in (0, 60] (else 400), written as a Chrome trace into a fresh
      directory under ``trace_dir`` (default: a temporary directory);
      answers ``{"trace_dir", "seconds"}``. One window at a time per
      process: 409 while one is open, 500 with the profiler's message
      when another profiler session is running. ``trace_window`` start
      and stop ride the event stream.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.engine import msgpack
from pvraft_tpu_torch.obs.trace import Tracer
from pvraft_tpu_torch.profiling.timers import start_profiler
from pvraft_tpu_torch.serve import faults
from pvraft_tpu_torch.serve.batcher import (
    BatcherConfig,
    MicroBatcher,
    PoolUnavailableError,
    QueueFullError,
    ShutdownError,
)
from pvraft_tpu_torch.serve.engine import RequestError
from pvraft_tpu_torch.serve.metrics import PROM_CONTENT_TYPE, ServeMetrics
from pvraft_tpu_torch.serve.supervisor import ReplicaSupervisor

MSGPACK_CT = "application/msgpack"
JSON_CT = "application/json"
TRACE_FILE = "trace.json"

# One profiler window per process, across every server in it: taken
# without blocking only (409 while busy), so it closes no deadlock cycle.
_DEBUG_TRACE_LOCK = ordered_lock("serve.server._DEBUG_TRACE_LOCK")


def _decode_json(body: bytes) -> Tuple[np.ndarray, np.ndarray]:
    try:
        doc = json.loads(body)
    except ValueError as e:
        raise RequestError("bad_request", f"invalid JSON: {e}") from None
    if not isinstance(doc, dict) or "pc1" not in doc or "pc2" not in doc:
        raise RequestError("bad_request", "body must carry 'pc1' and 'pc2'")
    try:
        pc1 = np.asarray(doc["pc1"], np.float32)
        pc2 = np.asarray(doc["pc2"], np.float32)
    except (TypeError, ValueError) as e:
        raise RequestError("bad_request", f"non-numeric cloud: {e}") from None
    return pc1, pc2


def _decode_msgpack(body: bytes) -> Tuple[np.ndarray, np.ndarray]:
    try:
        doc = msgpack.unpackb(body)
    except Exception as e:  # noqa: BLE001 — any malformed body is a 400
        raise RequestError("bad_request", f"invalid msgpack: {e}") from None
    if not isinstance(doc, dict) or "pc1" not in doc or "pc2" not in doc:
        raise RequestError("bad_request", "body must carry 'pc1' and 'pc2'")
    out = []
    for name in ("pc1", "pc2"):
        raw = doc[name]
        if not isinstance(raw, (bytes, bytearray)) or len(raw) % 12:
            raise RequestError(
                "bad_request",
                f"{name} must be raw float32 bytes, length divisible by 12")
        out.append(np.frombuffer(bytes(raw), "<f4").reshape(-1, 3))
    return out[0], out[1]


def _profile_window(seconds: float, base: str, telemetry) -> str:
    """Profile the process for ``seconds`` into a fresh directory under
    ``base`` (``trace.json``, a Chrome trace); returns the directory.
    Raises when another profiler session is running: two at once are not
    supported (they can take the process down)."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        raise RuntimeError("another torch.profiler session is running in "
                           "this process; one profiler at a time")
    base = base or os.path.join(tempfile.gettempdir(), "pvraft_traces")
    os.makedirs(base, exist_ok=True)
    trace_dir = tempfile.mkdtemp(
        prefix=time.strftime("trace_%Y%m%d_%H%M%S_"), dir=base)
    # Every thread's ranges: the executors' device_execute, not only
    # this handler thread's (the default records the starting thread's).
    prof = start_profiler()
    announced = False
    try:
        # "start" only once the profiler runs, so start and stop pair.
        if telemetry is not None:
            telemetry.emit_trace_window("start", trace_dir)
            announced = True
        time.sleep(seconds)
    finally:
        # Stopped on every exit once started.
        prof.stop()
        if announced:
            telemetry.emit_trace_window("stop", trace_dir)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return trace_dir


class _Handler(BaseHTTPRequestHandler):
    # Bound per server by ServeHTTPServer.
    batcher: MicroBatcher = None  # type: ignore[assignment]
    metrics: Optional[ServeMetrics] = None
    tracer: Optional[Tracer] = None
    telemetry = None
    trace_dir: str = ""
    events_path: str = ""
    predict_timeout_s: float = 60.0
    max_body_bytes: int = 1 << 24
    quiet: bool = True
    # 503 Retry-After: one supervisor probe cycle when one is wired.
    retry_after_s: int = 1

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # the stdlib prints every hit
        if not self.quiet:
            super().log_message(fmt, *args)

    # ------------------------------------------------------------ replies --

    def _reply(self, code: int, payload: bytes, content_type: str,
               headers: List[Tuple[str, str]] = ()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        for key, value in headers:
            self.send_header(key, value)
        if self.close_connection:
            # Advertise the close: a pooled HTTP/1.1 client would reuse
            # the connection otherwise.
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(payload)

    def _reply_json(self, code: int, doc: Dict[str, Any],
                    headers: List[Tuple[str, str]] = ()) -> None:
        self._reply(code, json.dumps(doc).encode("utf-8"), JSON_CT, headers)

    def _reply_error(self, code: int, error: str, detail: str = "",
                     headers: List[Tuple[str, str]] = ()) -> None:
        self._reply_json(code, {"error": error, "detail": detail}, headers)

    def _reply_busy(self, error: str, detail: str,
                    headers: List[Tuple[str, str]] = ()) -> None:
        self._reply_error(503, error, detail,
                          [*headers, ("Retry-After", str(self.retry_after_s))])

    # ------------------------------------------------------------- routes --

    def _healthz(self) -> Dict[str, Any]:
        engine = self.batcher.engine
        supervisor = self.batcher.supervisor
        tracer = self.tracer
        return {
            "status": "ok",
            "buckets": list(engine.cfg.buckets),
            "batch_sizes": list(engine.cfg.batch_sizes),
            "min_points": engine.cfg.min_points,
            "dtype": getattr(engine.cfg, "dtype", "float32"),
            "pool": (supervisor.pool_health()
                     if supervisor is not None else None),
            "faults": faults.plan_snapshot(),
            "replicas": self.batcher.replica_stats(),
            "in_flight": (self.metrics.current_in_flight()
                          if self.metrics is not None else None),
            "cost": None,
            "cost_surface": None,
            "weights": engine.weights_info(),
            "programs": engine.compile_report(),
            "telemetry": {
                "events_path": self.events_path or None,
                "tracing": bool(tracer is not None and tracer.enabled),
                "trace_sample_every": (tracer.sample_every
                                       if tracer is not None else 0),
                "trace_dir": self.trace_dir or None},
        }

    def do_GET(self):  # noqa: N802 — stdlib handler naming
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            self._reply_json(200, self._healthz())
            return
        if path == "/metrics":
            fmt = urllib.parse.parse_qs(query).get("format", ["json"])[0]
            depths = self.batcher.queue_depths()
            if fmt == "prometheus":
                text = (self.metrics.prometheus(
                    depths,
                    replica_stats=self.batcher.replica_stats(),
                    batch_queue_depth=self.batcher.batch_queue_depth())
                    if self.metrics is not None else "")
                self._reply(200, text.encode("utf-8"), PROM_CONTENT_TYPE)
            elif fmt == "json":
                snap = (self.metrics.snapshot(depths)
                        if self.metrics is not None else {})
                self._reply_json(200, snap)
            else:
                self._reply_error(
                    400, "bad_request",
                    f"unknown format {fmt!r} (json|prometheus)")
            return
        if path == "/debug/trace":
            self._debug_trace(query)
            return
        self._reply_error(404, "not_found", self.path)

    def _debug_trace(self, query: str) -> None:
        """A ``torch.profiler`` window of the live server. The handler
        thread sleeps through it while other threads keep serving, so
        the trace holds their work: the replays' kernels (CUPTI sees the
        whole device) and the executors' ``device_execute`` ranges."""
        try:
            seconds = float(
                urllib.parse.parse_qs(query).get("seconds", ["2"])[0])
        except ValueError:
            self._reply_error(400, "bad_request", "seconds must be a number")
            return
        if not 0 < seconds <= 60:
            self._reply_error(400, "bad_request",
                              "seconds must be in (0, 60]")
            return
        if not _DEBUG_TRACE_LOCK.acquire(blocking=False):
            self._reply_error(
                409, "busy", "a trace window is already being captured")
            return
        try:
            trace_dir = _profile_window(seconds, self.trace_dir,
                                        self.telemetry)
        except Exception as e:  # noqa: BLE001 — a handler must answer
            self._reply_error(500, "internal", f"{type(e).__name__}: {e}")
            return
        finally:
            _DEBUG_TRACE_LOCK.release()
        self._reply_json(200, {"trace_dir": trace_dir, "seconds": seconds})

    def _finish_trace(self, trace, status: int,
                      bucket: Optional[int] = None) -> None:
        """Emit a traced request's span tree once its response is
        written (a 200's stages also feed the stage histograms)."""
        if trace is None:
            return
        spans = trace.spans(root_attrs={"status": status})
        if self.tracer is not None:
            self.tracer.emit_spans(spans)
        if self.metrics is not None and bucket is not None \
                and status == 200:
            self.metrics.record_stages(bucket, trace.stage_durations_ms())

    def _admin_reload(self) -> None:
        """``POST /admin/reload``: decode the body, let the engine swap,
        map failures to status codes."""
        raw_length = self.headers.get("Content-Length")
        try:
            length = int(raw_length if raw_length is not None else "")
        except ValueError:
            length = -1
        if not 0 <= length <= (1 << 20):
            self.close_connection = True
            self._reply_error(400, "bad_request",
                              "missing or invalid Content-Length")
            return
        body = self.rfile.read(length)
        try:
            doc = json.loads(body or b"{}")
        except ValueError as e:
            self._reply_error(400, "bad_request", f"invalid JSON: {e}")
            return
        ckpt = doc.get("ckpt") if isinstance(doc, dict) else None
        if not isinstance(ckpt, str) or not ckpt:
            self._reply_error(
                400, "bad_request", "body must carry 'ckpt': <path>")
            return
        try:
            drain_s = float(doc.get("drain_timeout_s", 30.0))
        except (TypeError, ValueError):
            self._reply_error(400, "bad_request",
                              "drain_timeout_s must be a number")
            return
        try:
            report = self.batcher.engine.reload_checkpoint(
                ckpt, drain_timeout_s=drain_s)
        except ValueError as e:
            # Another structure, shape or dtype: the served weights stay.
            self._reply_error(409, "swap_rejected", str(e))
            return
        except Exception as e:  # noqa: BLE001 — a handler must answer
            self._reply_error(
                400, "bad_request",
                f"checkpoint unreadable: {type(e).__name__}: {e}")
            return
        self._reply_json(200, report)

    def do_POST(self):  # noqa: N802 — stdlib handler naming
        post_path = self.path.partition("?")[0]
        if post_path == "/admin/reload":
            self._admin_reload()
            return
        if post_path != "/predict":
            # The body stays unread, so the connection cannot be reused.
            self.close_connection = True
            self._reply_error(404, "not_found", self.path)
            return
        raw_length = self.headers.get("Content-Length")
        if raw_length is None:
            self.close_connection = True
            self.batcher.record_reject("bad_request")
            self._reply_error(400, "bad_request", "missing Content-Length")
            return
        try:
            length = int(raw_length)
        except ValueError:
            length = -1
        if length < 0:
            self.close_connection = True
            self.batcher.record_reject("bad_request")
            self._reply_error(400, "bad_request", "invalid Content-Length")
            return
        if length > self.max_body_bytes:
            # Bounded before buffering; the unread body closes the
            # connection.
            self.close_connection = True
            self.batcher.record_reject("too_large")
            self._reply_error(
                413, "too_large",
                f"body {length} B exceeds the {self.max_body_bytes} B cap")
            return
        # The sampling decision and ingress's start come before the body
        # is read; an unsampled request stamps nothing.
        trace = self.tracer.begin() if self.tracer is not None else None
        traced = ([("X-Pvraft-Trace", trace.trace_id)]
                  if trace is not None else [])
        t_ingress = time.monotonic()
        body = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or JSON_CT).split(";")[0]
        use_msgpack = ctype.strip().lower() == MSGPACK_CT
        try:
            pc1, pc2 = (_decode_msgpack(body) if use_msgpack
                        else _decode_json(body))
        except RequestError as e:
            self.batcher.record_reject(e.reason)
            self._reply_error(400, e.reason, str(e), traced)
            self._finish_trace(trace, 400)
            return
        if trace is not None:
            trace.mark("ingress", t_ingress, time.monotonic(),
                       attrs={"bytes": length, "msgpack": use_msgpack,
                              "n1": int(pc1.shape[0]),
                              "n2": int(pc2.shape[0])})
        req = None
        try:
            req = self.batcher.submit(pc1, pc2, trace=trace)
            flow = req.wait(self.predict_timeout_s)
        except RequestError as e:
            code = 413 if e.reason == "too_large" else 400
            self._reply_error(code, e.reason, str(e), traced)
            self._finish_trace(trace, code)
            return
        except QueueFullError as e:
            self._reply_busy("queue_full", str(e), traced)
            self._finish_trace(trace, 503)
            return
        except PoolUnavailableError as e:
            self._reply_busy("unavailable", str(e), traced)
            self._finish_trace(trace, 503)
            return
        except ShutdownError as e:
            self._reply_busy("shutting_down", str(e), traced)
            self._finish_trace(trace, 503)
            return
        except TimeoutError as e:
            # Accepted, then no answer: an outcome of a counted request.
            self.batcher.record_failure_for(req, "timeout")
            self._reply_error(504, "timeout", str(e), traced)
            self._finish_trace(trace, 504)
            return
        except Exception as e:  # noqa: BLE001 — a handler must answer
            if req is not None:
                self.batcher.record_failure_for(req, "internal")
            else:
                self.batcher.record_reject("internal")
            self._reply_error(500, "internal", f"{type(e).__name__}: {e}",
                              traced)
            self._finish_trace(trace, 500)
            return
        t_serialize = time.monotonic()
        if use_msgpack:
            payload = msgpack.packb({
                "flow": np.ascontiguousarray(flow, "<f4").tobytes(),
                "n": int(flow.shape[0])})
            content_type = MSGPACK_CT
        else:
            payload = json.dumps({"flow": flow.tolist(),
                                  "n": int(flow.shape[0])}).encode("utf-8")
            content_type = JSON_CT
        if trace is None:
            self._reply(200, payload, content_type)
            return
        t_respond = time.monotonic()
        trace.mark("serialize", t_serialize, t_respond)
        self._reply(200, payload, content_type, traced)
        trace.mark("respond", t_respond, time.monotonic())
        self._finish_trace(trace, 200, bucket=req.bucket)


class ServeHTTPServer:
    """The assembled service: engine, batcher and supervisor behind HTTP.
    ``port=0`` binds an ephemeral port (``self.port`` after
    construction); ``start()`` serves on a background thread and starts
    the memory monitor and the probe loop; ``shutdown()`` stops the probe
    loop and the monitor, drains the batcher, unseals the watchdog and
    stops the HTTP loop."""

    def __init__(self, batcher: MicroBatcher, host: str = "127.0.0.1",
                 port: int = 8000, metrics: Optional[ServeMetrics] = None,
                 predict_timeout_s: float = 60.0, quiet: bool = True,
                 tracer: Optional[Tracer] = None, telemetry=None,
                 trace_dir: str = "", devmem_monitor=None,
                 supervisor: Optional[ReplicaSupervisor] = None):
        self.batcher = batcher
        self.tracer = tracer
        self.devmem_monitor = devmem_monitor
        self.supervisor = supervisor
        events = getattr(telemetry, "events", None)
        # 64 B per coordinate bounds any JSON float spelling: a larger
        # body cannot fit the largest bucket.
        largest = max(batcher.engine.cfg.buckets)
        handler = type("BoundHandler", (_Handler,), {
            "batcher": batcher,
            "metrics": metrics,
            "tracer": tracer,
            "telemetry": telemetry,
            "trace_dir": trace_dir,
            "events_path": getattr(events, "path", "") or "",
            "predict_timeout_s": predict_timeout_s,
            "max_body_bytes": 2 * largest * 3 * 64 + 65536,
            "quiet": quiet,
            "retry_after_s": (supervisor.cfg.retry_after_s
                              if supervisor is not None else 1),
        })
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="pvraft-serve-http",
            daemon=True)
        self._thread.start()
        if self.devmem_monitor is not None:
            self.devmem_monitor.start()
        if self.supervisor is not None:
            self.supervisor.start()

    def shutdown(self, drain: bool = True) -> None:
        # The probe loop first: probes during teardown prove nothing.
        # The memory monitor's last sample comes before the drain, so the
        # batcher's serve_shutdown summary ends the stream.
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.devmem_monitor is not None:
            self.devmem_monitor.stop()
        self.batcher.shutdown(drain=drain)
        if self.batcher.watchdog is not None:
            self.batcher.watchdog.close()
        if self._thread is not None:
            # Waits for serve_forever, which only a started server runs.
            self.httpd.shutdown()
            self._thread.join(10.0)
        self.httpd.server_close()


def build_service(engine, *, max_wait_ms: float = 5.0,
                  queue_depth: int = 64, host: str = "127.0.0.1",
                  port: int = 0, telemetry=None,
                  predict_timeout_s: float = 60.0,
                  quiet: bool = True, trace_sample_every: int = 16,
                  trace_dir: str = "", eager_when_idle: bool = True,
                  strict_retrace: bool = False,
                  devmem_interval_s: float = 10.0,
                  supervise: bool = True,
                  supervisor_cfg=None) -> ServeHTTPServer:
    """engine -> metrics -> batcher -> HTTP, at the JAX package's
    defaults: ``max_batch`` is the largest captured batch size, one
    :class:`ServeMetrics` reaches the batcher and the handler, and
    ``supervise=True`` wires a :class:`ReplicaSupervisor`
    (``supervisor_cfg`` overrides its thresholds). The engine decides the
    device: it runs on the card unless it was built on the CPU.

    Observability: ``telemetry`` (a ``ServeTelemetry``) receives the
    service's events; 1 request in ``trace_sample_every`` is traced (1:
    all, 0: off), its spans to ``telemetry`` and its stages to the
    Prometheus histograms; a :class:`~pvraft_tpu_torch.obs.retrace.
    RetraceWatchdog`, sealed here before the batcher's executors exist
    (the engine has captured every program and loaded every kernel
    library it runs), turns a compile during a dispatch into a
    ``recompile`` event and ``pvraft_serve_recompiles_total``, and under
    ``strict_retrace`` into HTTP 500; a :class:`~pvraft_tpu_torch.obs.
    device_memory.DeviceMemoryMonitor` samples the card every
    ``devmem_interval_s`` seconds (0: never; the CPU has nothing to
    sample). ``trace_dir`` is where ``/debug/trace`` windows go. Returns
    an unstarted server (``.start()``, ``.shutdown()``)."""
    from pvraft_tpu_torch.obs.device_memory import DeviceMemoryMonitor
    from pvraft_tpu_torch.obs.retrace import RetraceWatchdog

    metrics = ServeMetrics(engine.cfg.buckets)
    supervisor = (ReplicaSupervisor(engine, cfg=supervisor_cfg,
                                    telemetry=telemetry)
                  if supervise else None)
    watchdog = RetraceWatchdog(
        emit=telemetry.emit_recompile if telemetry is not None else None,
        strict=strict_retrace, context="serve")
    watchdog.seal()
    batcher = MicroBatcher(
        engine,
        BatcherConfig(max_batch=max(engine.cfg.batch_sizes),
                      max_wait_ms=max_wait_ms, queue_depth=queue_depth,
                      eager_when_idle=eager_when_idle),
        telemetry=telemetry, metrics=metrics, watchdog=watchdog,
        supervisor=supervisor)
    tracer = Tracer(
        sample_every=trace_sample_every,
        emit=telemetry.emit_span if telemetry is not None else None)
    devmem = DeviceMemoryMonitor(
        emit=telemetry.emit_device_memory if telemetry is not None else None,
        metrics=metrics, interval_s=devmem_interval_s, context="serve")
    return ServeHTTPServer(batcher, host=host, port=port, metrics=metrics,
                           predict_timeout_s=predict_timeout_s, quiet=quiet,
                           tracer=tracer, telemetry=telemetry,
                           trace_dir=trace_dir, devmem_monitor=devmem,
                           supervisor=supervisor)
