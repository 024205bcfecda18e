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
      504 for a timeout.
  ``GET /healthz``
      readiness: buckets, batch sizes, dtype, the supervisor's ``pool``
      block, the armed fault plan, per-replica rows, in-flight count,
      weights provenance and the captured programs. ``cost`` and
      ``cost_surface`` are null and ``telemetry.tracing`` is false: the
      cost plane and tracing arrive with ROADMAP queue 1 item 9.
  ``GET /metrics``
      JSON (default) or ``?format=prometheus`` (``serve/metrics.py``).
  ``POST /admin/reload``
      ``{"ckpt": "<path>"}``: the engine's hot-swap without recapture
      (``InferenceEngine.reload_checkpoint``); returns the swap report.
      400 for a bad body or an unreadable checkpoint, 409 for weights of
      another structure (the served ones stay).
  ``GET /debug/trace``
      501: the profiler window of JAX's service arrives with ROADMAP
      queue 1 item 9.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pvraft_tpu_torch.engine import msgpack
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


class _Handler(BaseHTTPRequestHandler):
    # Bound per server by ServeHTTPServer.
    batcher: MicroBatcher = None  # type: ignore[assignment]
    metrics: Optional[ServeMetrics] = None
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

    def _reply_busy(self, error: str, detail: str) -> None:
        self._reply_error(503, error, detail,
                          [("Retry-After", str(self.retry_after_s))])

    # ------------------------------------------------------------- routes --

    def _healthz(self) -> Dict[str, Any]:
        engine = self.batcher.engine
        supervisor = self.batcher.supervisor
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
            "telemetry": {"events_path": None, "tracing": False,
                          "trace_sample_every": 0, "trace_dir": None},
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
            self._reply_error(
                501, "not_implemented",
                "the profiler window arrives with the port's "
                "observability slice (ROADMAP queue 1 item 9)")
            return
        self._reply_error(404, "not_found", self.path)

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
        body = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or JSON_CT).split(";")[0]
        use_msgpack = ctype.strip().lower() == MSGPACK_CT
        try:
            pc1, pc2 = (_decode_msgpack(body) if use_msgpack
                        else _decode_json(body))
        except RequestError as e:
            self.batcher.record_reject(e.reason)
            self._reply_error(400, e.reason, str(e))
            return
        req = None
        try:
            req = self.batcher.submit(pc1, pc2)
            flow = req.wait(self.predict_timeout_s)
        except RequestError as e:
            self._reply_error(413 if e.reason == "too_large" else 400,
                              e.reason, str(e))
            return
        except QueueFullError as e:
            self._reply_busy("queue_full", str(e))
            return
        except PoolUnavailableError as e:
            self._reply_busy("unavailable", str(e))
            return
        except ShutdownError as e:
            self._reply_busy("shutting_down", str(e))
            return
        except TimeoutError as e:
            # Accepted, then no answer: an outcome of a counted request.
            self.batcher.record_failure_for(req, "timeout")
            self._reply_error(504, "timeout", str(e))
            return
        except Exception as e:  # noqa: BLE001 — a handler must answer
            if req is not None:
                self.batcher.record_failure_for(req, "internal")
            else:
                self.batcher.record_reject("internal")
            self._reply_error(500, "internal", f"{type(e).__name__}: {e}")
            return
        if use_msgpack:
            payload = msgpack.packb({
                "flow": np.ascontiguousarray(flow, "<f4").tobytes(),
                "n": int(flow.shape[0])})
            content_type = MSGPACK_CT
        else:
            payload = json.dumps({"flow": flow.tolist(),
                                  "n": int(flow.shape[0])}).encode("utf-8")
            content_type = JSON_CT
        self._reply(200, payload, content_type)


class ServeHTTPServer:
    """The assembled service: engine, batcher and supervisor behind HTTP.
    ``port=0`` binds an ephemeral port (``self.port`` after
    construction); ``start()`` serves on a background thread;
    ``shutdown()`` stops the probe loop, drains the batcher and stops
    the HTTP loop."""

    def __init__(self, batcher: MicroBatcher, host: str = "127.0.0.1",
                 port: int = 8000, metrics: Optional[ServeMetrics] = None,
                 predict_timeout_s: float = 60.0, quiet: bool = True,
                 supervisor: Optional[ReplicaSupervisor] = None):
        self.batcher = batcher
        self.supervisor = supervisor
        # 64 B per coordinate bounds any JSON float spelling: a larger
        # body cannot fit the largest bucket.
        largest = max(batcher.engine.cfg.buckets)
        handler = type("BoundHandler", (_Handler,), {
            "batcher": batcher,
            "metrics": metrics,
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
        if self.supervisor is not None:
            self.supervisor.start()

    def shutdown(self, drain: bool = True) -> None:
        # The probe loop first: probes during teardown prove nothing.
        if self.supervisor is not None:
            self.supervisor.stop()
        self.batcher.shutdown(drain=drain)
        if self._thread is not None:
            # Waits for serve_forever, which only a started server runs.
            self.httpd.shutdown()
            self._thread.join(10.0)
        self.httpd.server_close()


def build_service(engine, *, max_wait_ms: float = 5.0,
                  queue_depth: int = 64, host: str = "127.0.0.1",
                  port: int = 0, predict_timeout_s: float = 60.0,
                  quiet: bool = True, eager_when_idle: bool = True,
                  supervise: bool = True,
                  supervisor_cfg=None) -> ServeHTTPServer:
    """engine -> metrics -> batcher -> HTTP, at the JAX package's
    defaults: ``max_batch`` is the largest captured batch size, one
    :class:`ServeMetrics` reaches the batcher and the handler, and
    ``supervise=True`` wires a :class:`ReplicaSupervisor`
    (``supervisor_cfg`` overrides its thresholds). The engine decides the
    device: it runs on the card unless it was built on the CPU. Returns
    an unstarted server (``.start()``, ``.shutdown()``)."""
    metrics = ServeMetrics(engine.cfg.buckets)
    supervisor = (ReplicaSupervisor(engine, cfg=supervisor_cfg)
                  if supervise else None)
    batcher = MicroBatcher(
        engine,
        BatcherConfig(max_batch=max(engine.cfg.batch_sizes),
                      max_wait_ms=max_wait_ms, queue_depth=queue_depth,
                      eager_when_idle=eager_when_idle),
        metrics=metrics, supervisor=supervisor)
    return ServeHTTPServer(batcher, host=host, port=port, metrics=metrics,
                           predict_timeout_s=predict_timeout_s, quiet=quiet,
                           supervisor=supervisor)
