"""The fleet router: an HTTP fan-out tier over serve hosts (port of
``pvraft_tpu/fleet/router.py``).

N backends, each a whole ``serve.build_service`` pool on its own port,
behind one stdlib ``ThreadingHTTPServer``. The router holds no model and
no queue: it decides which pool answers.

``POST /predict``: the point count picks a bucket from the backends'
polled table; the cost surface, when armed, prices it in predicted
device-seconds (``CostSurface.estimate_serve``, the H100 roofline); the
request goes to the backend in the rotation with the least predicted
outstanding work (the router's open dispatches plus the polled queue,
priced). A backend that sheds (503) or cannot be reached spills the
request to the next; only when every candidate shed does the client see
a 503, with a ``Retry-After`` no shorter than the backends' own. A 4xx
never spills: it would fail on every pool.

Health: a poll loop GETs every backend's ``/healthz`` each
``poll_interval_s`` and drives the supervisor's states one tier up
(``fleet/backend.py``); a quarantined backend leaves the rotation until
a probe poll succeeds.

``POST /admin/reload`` fans the swap out one backend at a time, so the
others keep serving while one swaps; each swap is the engine's
drain-aware copy into the captured parameters, with no recapture.
``"canary": true`` swaps one backend and arms the canary on it
(``POST /admin/canary`` arms or disarms it alone): a share of the
traffic goes to it, each such request is mirrored to the incumbent, and
the EPE gate renders the verdict (``fleet/canary.py``).

Every client dispatch writes a ``fleet_route`` event (``least_loaded``,
``spillover``, ``canary`` or ``shadow``) through the telemetry given
(``serve/events.py::ServeTelemetry``); ``GET /healthz`` gives the
backends' rows, the canary block and the ledger, ``GET /metrics`` the
``pvraft_fleet_*`` ledger as JSON or Prometheus (``fleet/metrics.py``).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from pvraft_tpu_torch.fleet.backend import Backend, BackendClient
from pvraft_tpu_torch.fleet.canary import CanaryController
from pvraft_tpu_torch.fleet.metrics import PROM_CONTENT_TYPE, FleetMetrics
from pvraft_tpu_torch.programs.geometries import FLEET_DEFAULTS

__all__ = ["FleetConfig", "FleetRouter", "build_fleet"]

JSON_CT = "application/json"

# Body cap before the first successful poll reveals the real bucket
# table (then: the serve formula over the largest polled bucket). 64 B
# bounds any JSON float spelling per coordinate.
_FALLBACK_MAX_BUCKET = 8192


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet-tier thresholds; defaults are the declared geometry data
    (``programs/geometries.FLEET_DEFAULTS`` — the SUPERVISOR_DEFAULTS
    discipline one tier up)."""

    poll_interval_s: float = FLEET_DEFAULTS["poll_interval_s"]
    poll_timeout_s: float = FLEET_DEFAULTS["poll_timeout_s"]
    degraded_after: int = FLEET_DEFAULTS["degraded_after"]
    quarantine_after: int = FLEET_DEFAULTS["quarantine_after"]
    retry_after_s: int = FLEET_DEFAULTS["retry_after_s"]
    predict_timeout_s: float = FLEET_DEFAULTS["predict_timeout_s"]
    canary_fraction: float = FLEET_DEFAULTS["canary_fraction"]
    canary_min_samples: int = FLEET_DEFAULTS["canary_min_samples"]
    canary_epe_bound: float = FLEET_DEFAULTS["canary_epe_bound"]
    canary_rel_epe_bound: float = FLEET_DEFAULTS["canary_rel_epe_bound"]


class _FleetHandler(BaseHTTPRequestHandler):
    """Bound per-router via ``type()`` (the serve/server.py idiom)."""

    router: "FleetRouter"
    quiet: bool = True
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        if not self.quiet:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: bytes, content_type: str,
               extra: Optional[List[Tuple[str, str]]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        for name, value in extra or ():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(payload)

    def _reply_json(self, code: int, doc: Dict[str, Any],
                    extra: Optional[List[Tuple[str, str]]] = None) -> None:
        self._reply(code, json.dumps(doc).encode("utf-8"), JSON_CT,
                    extra=extra)

    def _reply_error(self, code: int, error: str, detail: str = "") -> None:
        self._reply_json(code, {"error": error, "detail": detail})

    def _read_body(self) -> Optional[bytes]:
        """Bounded body read; None (after replying 400/413) when the
        Content-Length is missing, malformed or over the cap — the
        serve handler's keep-alive discipline (an unread body would
        desync the connection, so these close it)."""
        raw = self.headers.get("Content-Length")
        try:
            length = int(raw if raw is not None else "")
        except ValueError:
            length = -1
        if length < 0:
            self.close_connection = True
            self._reply_error(400, "bad_request",
                              "missing or invalid Content-Length")
            return None
        if length > self.router.max_body_bytes():
            self.close_connection = True
            self._reply_error(413, "too_large",
                              f"body {length} B exceeds the cap")
            return None
        return self.rfile.read(length)

    # ------------------------------------------------------------- routes --

    def do_GET(self):  # noqa: N802 — stdlib handler naming
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            self._reply_json(200, self.router.health_doc())
            return
        if path == "/metrics":
            fmt = "prometheus" if "format=prometheus" in query else "json"
            if fmt == "prometheus":
                text = self.router.metrics.prometheus(
                    [b.snapshot() for b in self.router.backends])
                self._reply(200, text.encode("utf-8"), PROM_CONTENT_TYPE)
            else:
                self._reply_json(200, self.router.metrics.snapshot())
            return
        self._reply_error(404, "not_found", self.path)

    def do_POST(self):  # noqa: N802 — stdlib handler naming
        path = self.path.partition("?")[0]
        if path not in ("/predict", "/admin/reload", "/admin/canary"):
            self.close_connection = True
            self._reply_error(404, "not_found", self.path)
            return
        body = self._read_body()
        if body is None:
            return
        try:
            doc = json.loads(body or b"{}")
        except ValueError as e:
            if path == "/predict":
                # Counted: the ledger sees every predict ingress.
                self.router.metrics.record_submit()
                self.router.metrics.record_failure("bad_request")
            self._reply_error(400, "bad_request", f"invalid JSON: {e}")
            return
        if not isinstance(doc, dict):
            if path == "/predict":
                self.router.metrics.record_submit()
                self.router.metrics.record_failure("bad_request")
            self._reply_error(400, "bad_request", "body must be an object")
            return
        if path == "/predict":
            status, out, retry_after = self.router.route_predict(doc)
            extra = ([("Retry-After", str(retry_after))]
                     if retry_after is not None else None)
            self._reply_json(status, out, extra=extra)
            return
        if path == "/admin/reload":
            status, out = self.router.admin_reload_doc(doc)
            self._reply_json(status, out)
            return
        status, out = self.router.admin_canary_doc(doc)
        self._reply_json(status, out)


class FleetRouter:
    """The assembled fan-out tier. ``port=0`` binds ephemeral (tests,
    chaos runs); ``start()``/``shutdown()`` manage the HTTP loop and
    the health poll thread."""

    def __init__(self, targets, cfg: Optional[FleetConfig] = None,
                 telemetry=None, cost_surface=None,
                 host: str = "127.0.0.1", port: int = 0,
                 quiet: bool = True):
        if not targets:
            raise ValueError("a fleet needs at least one backend target")
        self.cfg = cfg or FleetConfig()
        self.telemetry = telemetry
        self.cost_surface = cost_surface
        self.metrics = FleetMetrics()
        self.canary = CanaryController(
            fraction=self.cfg.canary_fraction,
            min_samples=self.cfg.canary_min_samples,
            epe_bound=self.cfg.canary_epe_bound,
            rel_epe_bound=self.cfg.canary_rel_epe_bound)
        self.backends: List[Backend] = []
        for i, target in enumerate(targets):
            client = (target if isinstance(target, BackendClient)
                      else BackendClient.from_target(
                          target,
                          predict_timeout_s=self.cfg.predict_timeout_s,
                          poll_timeout_s=self.cfg.poll_timeout_s))
            self.backends.append(Backend(
                i, client, degraded_after=self.cfg.degraded_after,
                quarantine_after=self.cfg.quarantine_after))
        handler = type("BoundFleetHandler", (_FleetHandler,),
                       {"router": self, "quiet": quiet})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self._http_thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---------------------------------------------------------- lifecycle --

    def start(self) -> None:
        # Prime health before serving: the first request must not race
        # an empty rotation just because the poll cadence hasn't fired.
        self.poll_once()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="pvraft-fleet-http",
            daemon=True)
        self._http_thread.start()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="pvraft-fleet-poll", daemon=True)
        self._poll_thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(10.0)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(10.0)

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.cfg.poll_interval_s):
            self.poll_once()

    def poll_once(self) -> None:
        """One health sweep: quarantined backends go probing, every
        backend gets a ``/healthz`` GET, transitions are decided under
        each backend's lock and logged after."""
        for b in self.backends:
            b.begin_probe()
            try:
                health = b.client.healthz()
                if not isinstance(health, dict):
                    raise ValueError("healthz: not a JSON object")
                b.poll_succeeded(health)
            except (OSError, ValueError):
                b.poll_failed()

    # ------------------------------------------------------------ geometry --

    def buckets(self) -> Optional[List[int]]:
        for b in self.backends:
            table = b.buckets()
            if table:
                return table
        return None

    def bucket_for(self, n_points: int) -> Optional[int]:
        table = self.buckets()
        if not table:
            return None
        for b in table:
            if n_points <= b:
                return b
        return None

    def max_body_bytes(self) -> int:
        table = self.buckets()
        largest = max(table) if table else _FALLBACK_MAX_BUCKET
        return 2 * largest * 3 * 64 + 65536

    def predict_seconds(self, bucket: Optional[int]) -> float:
        """Cost-surface price of one request in this bucket (0.0 when
        the surface is disarmed or the geometry is unknown — routing
        degrades to raw queue counts, never blocks on pricing)."""
        if self.cost_surface is None or bucket is None:
            return 0.0
        dtype = None
        for b in self.backends:
            dtype = b.dtype()
            if dtype:
                break
        est = self.cost_surface.estimate_serve(bucket, 1,
                                               dtype or "bfloat16")
        return est.device_seconds if est is not None else 0.0

    # ------------------------------------------------------------- predict --

    def route_predict(self, doc: Dict[str, Any]
                      ) -> Tuple[int, Dict[str, Any], Optional[float]]:
        """Route one predict body; returns ``(status, body,
        retry_after)``. Pure function of router state + backend HTTP —
        tests drive it without a client socket."""
        self.metrics.record_submit()
        pc1 = doc.get("pc1")
        n = len(pc1) if isinstance(pc1, list) else 0
        bucket = self.bucket_for(n)
        predicted_s = self.predict_seconds(bucket)

        cst = self.canary.status()
        take_canary = False
        canary_backend: Optional[Backend] = None
        if cst["armed"] and cst["verdict"] is None:
            canary_backend = self.backends[cst["canary_backend"]]
            if canary_backend.in_rotation and self.canary.take():
                take_canary = True
        normal = sorted(
            (b for b in self.backends
             if b.in_rotation and not b.is_canary()),
            key=lambda b: b.load_score(predicted_s))
        order = [canary_backend] if take_canary else normal
        if take_canary is False and not normal and canary_backend is not None \
                and canary_backend.in_rotation:
            # Degenerate fleet: the canary is the only live backend —
            # serving beats shedding, interleave bookkeeping aside.
            order = [canary_backend]

        served: Optional[Backend] = None
        resp: Optional[Dict[str, Any]] = None
        attempts = 0
        retry_hint: Optional[float] = None
        for b in order:
            if attempts > 0:
                self.metrics.record_spillover()
            attempts += 1
            b.begin_dispatch(predicted_s)
            try:
                resp = b.client.predict(doc)
            except (OSError, ValueError):
                resp = None
            finally:
                b.end_dispatch(predicted_s)
            if resp is None:
                continue
            if resp["status"] == 503:
                if resp.get("retry_after") is not None:
                    retry_hint = max(retry_hint or 0.0, resp["retry_after"])
                continue
            served = b
            break

        if served is None:
            # Every candidate shed or died (or none existed).
            reason = "unavailable"
            backend_idx = order[-1].index if order else None
            self.metrics.record_failure(reason, backend=backend_idx)
            retry_after = max(retry_hint or 0.0, float(self.cfg.retry_after_s))
            if attempts and self.telemetry is not None:
                self.telemetry.emit_fleet_route(
                    order[-1].index,
                    "spillover" if attempts > 1 else "least_loaded",
                    bucket=bucket, predicted_s=predicted_s,
                    attempts=attempts, canary=take_canary, status=503)
            return (503, {"error": reason,
                          "detail": f"all {attempts} candidate backend(s) "
                                    f"shed or unreachable"}, retry_after)

        status = resp["status"]
        if status == 200:
            self.metrics.record_response(served.index, predicted_s,
                                         canary=take_canary)
        else:
            body = resp.get("body")
            reason = (body.get("error") if isinstance(body, dict)
                      else None) or f"http_{status}"
            self.metrics.record_failure(reason, backend=served.index)
        if self.telemetry is not None:
            self.telemetry.emit_fleet_route(
                served.index,
                "canary" if take_canary
                else ("spillover" if attempts > 1 else "least_loaded"),
                bucket=bucket, queue_depth=served.snapshot()["queue_depth"],
                predicted_s=predicted_s, attempts=attempts,
                canary=take_canary, status=status)
        if take_canary and status == 200:
            self._shadow_mirror(doc, resp, cst, bucket, predicted_s)
        return (status, resp.get("body") or {}, resp.get("retry_after"))

    def _shadow_mirror(self, doc: Dict[str, Any], resp: Dict[str, Any],
                       cst: Dict[str, Any], bucket: Optional[int],
                       predicted_s: float) -> None:
        """Mirror one canary-served request to the incumbent and feed
        the EPE gate. Router-internal traffic: its own counters and a
        ``shadow`` route event, never the client ledger. Synchronous on
        the canary request's thread — the comparison needs both flows,
        and a canary-fraction latency tax is the honest price of the
        gate."""
        baseline = self.backends[cst["baseline_backend"]]
        if not baseline.in_rotation:
            return
        self.metrics.record_shadow()
        baseline.begin_dispatch(predicted_s)
        try:
            shadow = baseline.client.predict(doc)
        except (OSError, ValueError):
            shadow = None
        finally:
            baseline.end_dispatch(predicted_s)
        if self.telemetry is not None:
            self.telemetry.emit_fleet_route(
                baseline.index, "shadow", bucket=bucket,
                predicted_s=predicted_s, attempts=1, canary=True,
                status=shadow["status"] if shadow else 0)
        if not shadow or shadow["status"] != 200:
            return
        try:
            verdict = self.canary.record(resp["body"]["flow"],
                                         shadow["body"]["flow"])
        except (KeyError, TypeError, ValueError):
            return
        if verdict is not None and self.telemetry is not None:
            self.telemetry.emit_canary_verdict(
                verdict["verdict"], verdict["epe"], verdict["bound"],
                rel_epe=verdict["rel_epe"], rel_bound=verdict["rel_bound"],
                samples=verdict["samples"], fraction=verdict["fraction"],
                canary_backend=verdict["canary_backend"],
                baseline_backend=verdict["baseline_backend"])

    # --------------------------------------------------------------- admin --

    def admin_reload_doc(self, doc: Dict[str, Any]
                         ) -> Tuple[int, Dict[str, Any]]:
        """``POST /admin/reload`` body -> (status, response). Fans the
        swap out sequentially (capacity never hits zero mid-rollout);
        ``"backend": i`` restricts it, ``"canary": true`` additionally
        arms the canary gate on that backend."""
        ckpt = doc.get("ckpt")
        if not isinstance(ckpt, str) or not ckpt:
            return (400, {"error": "bad_request",
                          "detail": "body must carry 'ckpt': <path>"})
        try:
            drain_s = float(doc.get("drain_timeout_s", 30.0))
        except (TypeError, ValueError):
            return (400, {"error": "bad_request",
                          "detail": "drain_timeout_s must be a number"})
        backend = doc.get("backend")
        canary = bool(doc.get("canary", False))
        if backend is not None and not (
                isinstance(backend, int)
                and 0 <= backend < len(self.backends)):
            return (400, {"error": "bad_request",
                          "detail": f"backend must be 0.."
                                    f"{len(self.backends) - 1}"})
        if canary and backend is None:
            return (400, {"error": "bad_request",
                          "detail": "canary swap needs 'backend': <index>"})
        targets = ([self.backends[backend]] if backend is not None
                   else [b for b in self.backends if b.in_rotation])
        if not targets:
            return (503, {"error": "unavailable",
                          "detail": "no backend in rotation to swap"})
        rows = []
        worst = 200
        for b in targets:
            try:
                resp = b.client.admin_reload(ckpt, drain_timeout_s=drain_s)
                rows.append({"backend": b.index, "status": resp["status"],
                             "report": resp["body"]})
                if resp["status"] != 200:
                    worst = max(worst, resp["status"])
            except (OSError, ValueError) as e:
                rows.append({"backend": b.index, "status": 0,
                             "report": {"error": "unreachable",
                                        "detail": str(e)}})
                worst = max(worst, 502)
        out: Dict[str, Any] = {"swapped": rows}
        if canary and worst == 200:
            others = [b.index for b in self.backends
                      if b.index != backend and b.in_rotation]
            if not others:
                out["canary"] = {"armed": False,
                                 "detail": "no incumbent backend to "
                                           "compare against"}
            else:
                self.arm_canary(backend, baseline=others[0])
                out["canary"] = self.canary.status()
        return (worst, out)

    def arm_canary(self, canary_backend: int, baseline: int) -> None:
        self.canary.arm(canary_backend, baseline)
        for b in self.backends:
            b.set_canary(b.index == canary_backend)

    def disarm_canary(self) -> None:
        self.canary.disarm()
        for b in self.backends:
            b.set_canary(False)

    def admin_canary_doc(self, doc: Dict[str, Any]
                         ) -> Tuple[int, Dict[str, Any]]:
        """``POST /admin/canary``: ``{"backend": i}`` arms (baseline =
        lowest-index other in-rotation backend), ``{"disarm": true}``
        disarms; either way the response is the canary status block."""
        if doc.get("disarm"):
            self.disarm_canary()
            return (200, self.canary.status())
        backend = doc.get("backend")
        if not (isinstance(backend, int)
                and 0 <= backend < len(self.backends)):
            return (400, {"error": "bad_request",
                          "detail": f"backend must be 0.."
                                    f"{len(self.backends) - 1}"})
        others = [b.index for b in self.backends
                  if b.index != backend and b.in_rotation]
        if not others:
            return (409, {"error": "no_baseline",
                          "detail": "canary needs an in-rotation "
                                    "incumbent to compare against"})
        self.arm_canary(backend, baseline=others[0])
        return (200, self.canary.status())

    # ------------------------------------------------------------- healthz --

    def health_doc(self) -> Dict[str, Any]:
        rows = [b.snapshot() for b in self.backends]
        in_rotation = [r for r in rows
                       if r["state"] in ("healthy", "degraded")]
        if not in_rotation:
            status = "unavailable"
        elif all(r["state"] == "healthy" for r in rows):
            status = "ok"
        else:
            status = "degraded"
        return {
            "status": status,
            "backends": rows,
            "buckets": self.buckets(),
            "canary": self.canary.status(),
            "fleet": {
                "poll_interval_s": self.cfg.poll_interval_s,
                "retry_after_s": self.cfg.retry_after_s,
                "cost_surface": self.cost_surface is not None,
            },
            # The whole ledger rides along so one poll of one endpoint
            # can check the reconciliation identity mid-chaos.
            "metrics": self.metrics.snapshot(),
        }


def build_fleet(targets, *, cfg: Optional[FleetConfig] = None,
                telemetry=None, cost_surface=None,
                host: str = "127.0.0.1", port: int = 0,
                quiet: bool = True) -> FleetRouter:
    """The one canonical fleet assembly (the ``build_service``
    counterpart): targets may be "host:port" strings, started
    ``ServeHTTPServer`` objects, or :class:`BackendClient` instances.
    Returns an unstarted router (``.start()`` / ``.shutdown()``)."""
    return FleetRouter(targets, cfg=cfg, telemetry=telemetry,
                       cost_surface=cost_surface, host=host, port=port,
                       quiet=quiet)
