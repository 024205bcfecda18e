"""The port's fleet tier (``pvraft_tpu_torch/fleet``) held to the JAX
package's: the cases of ``tests/test_fleet.py`` on the port (EPE canary
math, the deterministic interleave, the ledger and its Prometheus text,
the backend health states, routing, spillover, quarantine, hot swap,
canary, the HTTP surface and the chaos-artifact validator, against
stdlib fake backends, then the engine's swap on a tiny port engine); the
JAX router and the port's on the same fakes and the same requests,
choosing the same backends with the same ledger; and the port router in
front of two tiny port hosts. Every test runs under a deadline of its
own (SIGALRM), so a hung socket fails the test instead of the run."""

import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from pvraft_tpu_torch.fleet import (
    Backend,
    BackendClient,
    CanaryController,
    FleetConfig,
    FleetMetrics,
    build_fleet,
    flow_epe,
    validate_fleet_artifact,
)
from pvraft_tpu_torch.obs.events import validate_events_file
from pvraft_tpu_torch.serve.events import ServeTelemetry

REPO = Path(__file__).resolve().parents[1]
DEADLINE_S = 120


@pytest.fixture(autouse=True)
def _deadline():
    def expired(signum, frame):
        raise TimeoutError(f"test ran past its {DEADLINE_S} s deadline")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


# ------------------------------------------------------------ canary math --


def test_flow_epe_known_values():
    cand = [[1.0, 0.0, 0.0], [0.0, 3.0, 4.0]]
    base = [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]
    out = flow_epe(cand, base)
    assert out["epe"] == pytest.approx((1.0 + 5.0) / 2)
    assert out["mag"] == 0.0
    out = flow_epe(base, cand)                 # mag is the BASELINE's
    assert out["mag"] == pytest.approx(3.0)
    with pytest.raises(ValueError):
        flow_epe(cand, base[:1])               # shape mismatch
    with pytest.raises(ValueError):
        flow_epe([], [])                       # empty comparison


def test_canary_stride_is_deterministic_and_exact():
    """The interleave is a stride, not a coin flip: any window of N
    requests sends exactly floor-fraction of them to the canary, and a
    fresh controller replays the same sequence (no RNG stream)."""
    a = CanaryController(fraction=0.25, min_samples=4)
    b = CanaryController(fraction=0.25, min_samples=4)
    a.arm(1, 0)
    b.arm(1, 0)
    seq_a = [a.take() for _ in range(16)]
    seq_b = [b.take() for _ in range(16)]
    assert seq_a == seq_b
    assert sum(seq_a) == 4                     # exactly fraction * window
    assert a.verdict is None                   # no verdict from takes alone


def test_canary_verdict_once_and_bounds():
    c = CanaryController(fraction=1.0, min_samples=2, epe_bound=0.1,
                         rel_epe_bound=0.5)
    c.arm(1, 0)
    base = [[1.0, 0.0, 0.0]] * 4
    near = [[1.05, 0.0, 0.0]] * 4              # epe 0.05, rel 0.05
    assert c.record(near, base) is None        # below min_samples
    verdict = c.record(near, base)             # crosses min_samples: once
    assert verdict is not None
    assert verdict["verdict"] == "promote"
    assert verdict["epe"] == pytest.approx(0.05)
    assert verdict["rel_epe"] == pytest.approx(0.05)
    assert verdict["samples"] == 2
    assert c.record(near, base) is None        # window closed
    assert c.take() is False                   # no more canary routing
    # A swap that moves predictions past the bound is rejected.
    c.arm(1, 0)
    far = [[2.0, 0.0, 0.0]] * 4                # epe 1.0 > 0.1
    c.record(far, base)
    verdict = c.record(far, base)
    assert verdict["verdict"] == "reject"


def test_canary_arm_rejects_self_comparison():
    c = CanaryController(fraction=0.5, min_samples=2)
    with pytest.raises(ValueError):
        c.arm(1, 1)
    with pytest.raises(ValueError):
        CanaryController(fraction=0.0)         # fraction must be in (0, 1]


# ---------------------------------------------------------- fleet ledger --


def test_fleet_metrics_identity_and_per_backend():
    """requests_total == responses_total + sum(rejected) + in_flight at
    every snapshot — the identity the chaos run polls mid-load."""
    m = FleetMetrics()

    def identity(snap):
        return (snap["requests_total"]
                == snap["responses_total"]
                + sum(snap["rejected"].values()) + snap["in_flight"])

    m.record_submit()
    m.record_submit()
    m.record_submit()
    assert identity(m.snapshot()) and m.current_in_flight() == 3
    m.record_spillover()                       # dispatch fact, not ledger
    m.record_shadow()
    assert identity(m.snapshot())
    m.record_response(0, predicted_s=0.25)
    m.record_response(1, predicted_s=0.5, canary=True)
    m.record_failure("unavailable", backend=1)
    snap = m.snapshot()
    assert identity(snap) and snap["in_flight"] == 0
    assert snap["spillovers_total"] == 1
    assert snap["canary_total"] == 1 and snap["shadow_total"] == 1
    assert snap["predicted_device_seconds_total"] == pytest.approx(0.75)
    assert snap["per_backend"]["0"] == {"responses": 1, "failures": 0,
                                        "predicted_s": 0.25}
    assert snap["per_backend"]["1"]["failures"] == 1


def test_fleet_prometheus_one_hot_state():
    m = FleetMetrics()
    m.record_submit()
    m.record_response(0)
    rows = [{"backend": 0, "state": "healthy", "queue_depth": 2,
             "outstanding": 1},
            {"backend": 1, "state": "quarantined", "queue_depth": 0,
             "outstanding": 0}]
    text = m.prometheus(rows)
    assert "# TYPE pvraft_fleet_requests_total counter" in text
    assert "pvraft_fleet_requests_total 1" in text
    assert ('pvraft_fleet_backend_state{backend="0",state="healthy"} 1'
            in text)
    assert ('pvraft_fleet_backend_state{backend="1",state="healthy"} 0'
            in text)
    assert ('pvraft_fleet_backend_state{backend="1",state="quarantined"} 1'
            in text)
    assert 'pvraft_fleet_backend_queue_depth{backend="0"} 2' in text


# --------------------------------------------- backend health state walk --


def test_backend_state_machine_walk():
    """healthy -> degraded -> quarantined -> probing -> healthy, the
    supervisor vocabulary one tier up, with rotation membership tracking
    the states."""
    b = Backend(0, BackendClient("127.0.0.1", 1),
                degraded_after=1, quarantine_after=3)
    assert b.state == "healthy" and b.in_rotation
    assert b.begin_probe() is None             # only quarantined probes
    assert b.poll_failed() == ("healthy", "degraded")
    assert b.in_rotation                       # degraded still serves
    assert b.poll_failed() is None             # degraded -> degraded
    assert b.poll_failed() == ("degraded", "quarantined")
    assert not b.in_rotation
    assert b.begin_probe() == ("quarantined", "probing")
    assert b.poll_failed() == ("probing", "quarantined")   # failed probe
    assert b.begin_probe() == ("quarantined", "probing")
    health = {"in_flight": 4, "buckets": [32, 64], "dtype": "float32"}
    assert b.poll_succeeded(health) == ("probing", "healthy")
    assert b.in_rotation
    assert b.queue_depth == 4                  # polled load signal
    assert b.buckets() == [32, 64] and b.dtype() == "float32"
    snap = b.snapshot()
    assert snap["state"] == "healthy" and snap["polls_total"] == 5


def test_backend_load_score_orders_by_priced_queue():
    a = Backend(0, BackendClient("127.0.0.1", 1))
    b = Backend(1, BackendClient("127.0.0.1", 2))
    a.poll_succeeded({"in_flight": 5})
    b.poll_succeeded({"in_flight": 1})
    # Unpriced (no cost surface): raw counts break the tie, b wins.
    assert b.load_score(0.0) < a.load_score(0.0)
    # Priced: a's deeper queue costs 5 x 0.1 = 0.5 device-seconds, b's
    # open dispatch 0.5 + 1 x 0.1 = 0.6 — a wins despite more requests.
    b.begin_dispatch(0.5)
    assert a.load_score(0.1) < b.load_score(0.1)
    b.end_dispatch(0.5)
    assert b.load_score(0.0)[0] == 0.0


# ------------------------------------------------- fake backend protocol --


class _FakeBackendHandler(BaseHTTPRequestHandler):
    backend = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        pass

    def _json(self, code, doc, extra=()):
        payload = json.dumps(doc).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for name, value in extra:
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 — stdlib handler naming
        f = self.backend
        if self.path.partition("?")[0] == "/healthz":
            self._json(200, {
                "status": "ok", "buckets": list(f.buckets),
                "dtype": f.dtype, "in_flight": f.in_flight_report,
                "weights": {"digest": f.digest, "epoch": 0, "swaps": 0},
                "pool": {"replicas": 1}})
            return
        self._json(404, {"error": "not_found"})

    def do_POST(self):  # noqa: N802 — stdlib handler naming
        f = self.backend
        length = int(self.headers.get("Content-Length", "0") or "0")
        doc = json.loads(self.rfile.read(length) or b"{}")
        path = self.path.partition("?")[0]
        if path == "/predict":
            with f.lock:
                f.predicts += 1
            if f.mode == "shed":
                self._json(503, {"error": "queue_full"},
                           extra=[("Retry-After", str(f.retry_after))])
                return
            if f.mode == "client_error":
                self._json(400, {"error": "too_small"})
                return
            n = len(doc.get("pc1") or [])
            self._json(200, {"flow": [[f.flow_value, 0.0, 0.0]] * n,
                             "n": n})
            return
        if path == "/admin/reload":
            with f.lock:
                f.reloads += 1
            prev, f.digest = f.digest, f"d-{Path(doc['ckpt']).name}"
            self._json(200, {
                "digest": f.digest, "previous_digest": prev, "epoch": 1,
                "path": doc["ckpt"], "replicas": 1, "drained": 0,
                "drained_in_time": True, "swap_ms": 0.1})
            return
        self._json(404, {"error": "not_found"})


class _FakeBackend:
    """One fake serve host. ``port=<old>`` revives it on the same port
    (HTTPServer sets allow_reuse_address — the chaos run's same-port
    revival shape)."""

    def __init__(self, flow=0.5, buckets=(32, 64), dtype="float32",
                 port=0):
        self.flow_value = flow
        self.mode = "ok"                   # ok | shed | client_error
        self.retry_after = 9
        self.in_flight_report = 0
        self.digest = "d-seed"
        self.buckets = tuple(buckets)
        self.dtype = dtype
        self.predicts = 0
        self.reloads = 0
        self.lock = threading.Lock()
        handler = type("BoundFakeBackendHandler", (_FakeBackendHandler,),
                       {"backend": self})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.httpd.daemon_threads = True
        self.host = "127.0.0.1"
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def target(self):
        return f"{self.host}:{self.port}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(5.0)


def _tiny_cfg(**over):
    base = dict(poll_interval_s=0.05, poll_timeout_s=2.0,
                degraded_after=1, quarantine_after=2, retry_after_s=7,
                predict_timeout_s=10.0)
    base.update(over)
    return FleetConfig(**base)


def _predict_doc(n=20):
    return {"pc1": [[0.0, 0.0, 0.0]] * n, "pc2": [[0.0, 0.0, 0.0]] * n}


# ----------------------------------------------------- routing/spillover --


def test_router_least_loaded_then_spillover_then_total_shed():
    f0, f1 = _FakeBackend(), _FakeBackend()
    router = build_fleet([f0.target, f1.target], cfg=_tiny_cfg())
    try:
        f0.in_flight_report = 5                # f1 is the less loaded
        router.poll_once()
        assert router.bucket_for(20) == 32
        status, body, _ = router.route_predict(_predict_doc())
        assert status == 200 and len(body["flow"]) == 20
        assert (f0.predicts, f1.predicts) == (0, 1)

        # The preferred backend sheds: the request spills to the other
        # and still answers 200 — the client never sees the 503.
        f1.mode = "shed"
        status, body, _ = router.route_predict(_predict_doc())
        assert status == 200
        assert (f0.predicts, f1.predicts) == (1, 2)
        assert router.metrics.snapshot()["spillovers_total"] == 1

        # Every candidate sheds: 503 with a Retry-After no shorter than
        # the backends' own hint (9 > the router's configured 7).
        f0.mode = "shed"
        status, body, retry_after = router.route_predict(_predict_doc())
        assert status == 503 and body["error"] == "unavailable"
        assert retry_after == pytest.approx(9.0)

        snap = router.metrics.snapshot()
        assert snap["requests_total"] == 3
        assert (snap["responses_total"] + sum(snap["rejected"].values())
                + snap["in_flight"]) == 3
        assert snap["rejected"] == {"unavailable": 1}
    finally:
        f0.stop()
        f1.stop()


def test_router_client_errors_do_not_spill():
    """A 400 is deterministic — re-sending it to a second pool would
    just fail twice, so it terminates on the first backend."""
    f0, f1 = _FakeBackend(), _FakeBackend()
    router = build_fleet([f0.target, f1.target], cfg=_tiny_cfg())
    try:
        router.poll_once()
        f0.mode = f1.mode = "client_error"
        status, body, _ = router.route_predict(_predict_doc())
        assert status == 400
        assert f0.predicts + f1.predicts == 1  # exactly one attempt
        snap = router.metrics.snapshot()
        assert snap["spillovers_total"] == 0
        assert snap["rejected"] == {"too_small": 1}
    finally:
        f0.stop()
        f1.stop()


def test_router_quarantine_and_same_port_revival():
    f0, f1 = _FakeBackend(), _FakeBackend()
    router = build_fleet([f0.target, f1.target], cfg=_tiny_cfg())
    try:
        router.poll_once()
        port = f1.port
        f1.stop()                              # the mid-load kill
        router.poll_once()                     # 1 failure -> degraded
        assert router.backends[1].state == "degraded"
        assert router.backends[1].in_rotation  # degraded still routable
        router.poll_once()                     # 2 -> quarantined
        assert router.backends[1].state == "quarantined"
        assert not router.backends[1].in_rotation

        # Out of rotation: every request lands on the survivor.
        for _ in range(3):
            status, _, _ = router.route_predict(_predict_doc())
            assert status == 200
        assert f0.predicts == 3

        # Revival on the SAME port: the next poll probes and readmits.
        f1 = _FakeBackend(port=port)
        router.poll_once()
        assert router.backends[1].state == "healthy"
        assert router.backends[1].in_rotation
        assert router.health_doc()["status"] == "ok"
    finally:
        f0.stop()
        f1.stop()


# ----------------------------------------------------- hot-swap + canary --


def test_admin_reload_fans_out_and_validates():
    f0, f1 = _FakeBackend(), _FakeBackend()
    router = build_fleet([f0.target, f1.target], cfg=_tiny_cfg())
    try:
        router.poll_once()
        status, out = router.admin_reload_doc({})
        assert status == 400                   # no ckpt
        status, out = router.admin_reload_doc({"ckpt": "x", "backend": 9})
        assert status == 400                   # backend out of range
        status, out = router.admin_reload_doc({"ckpt": "x", "canary": True})
        assert status == 400                   # canary needs a backend

        status, out = router.admin_reload_doc(
            {"ckpt": "/ckpts/v2", "drain_timeout_s": 5.0})
        assert status == 200
        assert [r["backend"] for r in out["swapped"]] == [0, 1]
        for row in out["swapped"]:
            assert row["status"] == 200
            report = row["report"]
            assert report["digest"] == "d-v2"
            assert report["digest"] != report["previous_digest"]
        assert (f0.reloads, f1.reloads) == (1, 1)
    finally:
        f0.stop()
        f1.stop()


def test_canary_reload_interleaves_shadows_and_promotes():
    """The full canary story against fakes: a single-backend canary
    swap arms the gate, the stride sends the fraction to the canary,
    each canary answer is shadow-mirrored to the incumbent, and the
    verdict lands against the pinned bounds."""
    f0, f1 = _FakeBackend(flow=0.5), _FakeBackend(flow=0.51)
    cfg = _tiny_cfg(canary_fraction=1.0, canary_min_samples=3)
    router = build_fleet([f0.target, f1.target], cfg=cfg)
    try:
        router.poll_once()
        status, out = router.admin_reload_doc(
            {"ckpt": "/ckpts/v3", "backend": 1, "canary": True})
        assert status == 200
        assert out["canary"]["armed"] is True
        assert out["canary"]["canary_backend"] == 1
        assert out["canary"]["baseline_backend"] == 0
        assert router.backends[1].is_canary()
        assert f0.reloads == 0                 # restricted swap

        for _ in range(3):
            status, body, _ = router.route_predict(_predict_doc())
            assert status == 200
            assert body["flow"][0][0] == pytest.approx(0.51)  # canary-served

        cst = router.canary.status()
        # |0.51 - 0.5| = 0.01 epe, rel 0.02: inside the bf16-precedent
        # bounds, so the candidate promotes.
        assert cst["verdict"]["verdict"] == "promote"
        assert cst["verdict"]["samples"] == 3
        snap = router.metrics.snapshot()
        assert snap["canary_total"] == 3 and snap["shadow_total"] == 3
        assert (snap["requests_total"]
                == snap["responses_total"] + snap["in_flight"]
                + sum(snap["rejected"].values()))

        # Verdict in: the window is closed, traffic goes incumbent-only.
        before = f1.predicts
        status, _, _ = router.route_predict(_predict_doc())
        assert status == 200 and f1.predicts == before

        # A far-off candidate is rejected by the same gate.
        f1.flow_value = 2.0
        status, out = router.admin_canary_doc({"backend": 1})
        assert status == 200 and out["armed"] is True
        for _ in range(3):
            router.route_predict(_predict_doc())
        assert router.canary.status()["verdict"]["verdict"] == "reject"

        router.disarm_canary()
        assert not router.backends[1].is_canary()
    finally:
        f0.stop()
        f1.stop()


def test_canary_needs_an_incumbent():
    f0 = _FakeBackend()
    router = build_fleet([f0.target], cfg=_tiny_cfg())
    try:
        router.poll_once()
        status, out = router.admin_canary_doc({"backend": 0})
        assert status == 409 and out["error"] == "no_baseline"
    finally:
        f0.stop()
    with pytest.raises(ValueError):
        build_fleet([])


# ------------------------------------------------------ router HTTP face --


def _http(method, host, port, path, body=None):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        headers = ({"Content-Type": "application/json"}
                   if body is not None else {})
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def test_router_http_surface():
    """Started router end to end over real sockets: /predict, the
    aggregated /healthz (ledger embedded — the chaos run's one-poll
    identity check), JSON + Prometheus /metrics, and the 400/404 edges
    counted honestly."""
    f0, f1 = _FakeBackend(), _FakeBackend()
    router = build_fleet([f0.target, f1.target], cfg=_tiny_cfg())
    router.start()
    try:
        status, body, _ = _http(
            "POST", router.host, router.port, "/predict",
            json.dumps(_predict_doc()))
        assert status == 200
        assert len(json.loads(body)["flow"]) == 20

        status, body, _ = _http("GET", router.host, router.port,
                                "/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert [r["state"] for r in health["backends"]] == ["healthy"] * 2
        assert health["backends"][0]["weights"]["digest"] == "d-seed"
        assert health["buckets"] == [32, 64]
        assert health["canary"]["armed"] is False
        m = health["metrics"]
        assert (m["requests_total"] == m["responses_total"]
                + sum(m["rejected"].values()) + m["in_flight"])

        status, body, _ = _http(
            "POST", router.host, router.port, "/predict", "not json")
        assert status == 400

        status, body, _ = _http("GET", router.host, router.port,
                                "/metrics")
        snap = json.loads(body)
        assert snap["requests_total"] == 2
        assert snap["rejected"] == {"bad_request": 1}

        status, body, headers = _http(
            "GET", router.host, router.port, "/metrics?format=prometheus")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        assert b"pvraft_fleet_backend_state" in body

        status, _, _ = _http("GET", router.host, router.port, "/nope")
        assert status == 404
        status, _, _ = _http("POST", router.host, router.port, "/nope",
                             "{}")
        assert status == 404
    finally:
        router.shutdown()
        f0.stop()
        f1.stop()


# ------------------------------------------------------ chaos artifact --


def test_validate_fleet_artifact_red():
    assert validate_fleet_artifact([]) == ["<fleet_chaos>: not a JSON object"]
    assert any("schema" in p
               for p in validate_fleet_artifact({"schema": "nope"}))
    doc = {"schema": "pvraft_fleet_chaos/v1", "config": {"backends": 1},
           "phases": [], "recompiles": 3}
    problems = validate_fleet_artifact(doc)
    assert any("backends" in p for p in problems)       # fleet needs >= 2
    assert any("traffic_mix" in p for p in problems)
    assert any("load" in p for p in problems)
    assert any("spillovers" in p for p in problems)     # loss must re-route
    assert any("verdict" in p for p in problems)
    assert any("reconciliation" in p for p in problems)
    assert any("recompiles" in p for p in problems)     # must be 0


def test_committed_fleet_chaos_artifact_is_valid():
    """The committed evidence re-validates through the same gate the
    generator enforced — a hand-edited artifact cannot pass."""
    path = REPO / "artifacts" / "fleet_chaos.json"
    doc = json.loads(path.read_text())
    assert validate_fleet_artifact(doc, path=str(path)) == []
    assert doc["recompiles"] == 0 and doc["watchdog_trips"] == 0
    assert doc["phases"][1]["spillovers"] > 0
    assert doc["reconciliation"]["holds"] is True


# ------------------------------------------------- the port's own geometry --


def test_fleet_defaults_match_jax():
    from pvraft_tpu.programs.geometries import FLEET_DEFAULTS as JAX_DEFAULTS
    from pvraft_tpu_torch.programs.geometries import FLEET_DEFAULTS

    assert FLEET_DEFAULTS == JAX_DEFAULTS
    assert FleetConfig().canary_epe_bound == JAX_DEFAULTS["canary_epe_bound"]


def test_fleet_cli_validates_like_jax(tmp_path, capsys):
    from pvraft_tpu.fleet.__main__ import main as jax_main
    from pvraft_tpu_torch.fleet.__main__ import main

    good = str(REPO / "artifacts" / "fleet_chaos.json")
    bad = tmp_path / "bad.json"
    doc = json.loads(Path(good).read_text())
    doc["recompiles"] = 2
    bad.write_text(json.dumps(doc))
    broken = tmp_path / "broken.json"
    broken.write_text("{")
    for paths, rc in (([good], 0), ([str(bad)], 1), ([str(broken)], 1),
                      ([good, str(bad)], 1)):
        assert main(["validate", *paths]) == rc
        port_err = capsys.readouterr().err
        assert jax_main(["validate", *paths]) == rc
        assert capsys.readouterr().err == port_err


# ----------------------------------- the JAX router and the port's, side by side --


class _StubEstimate:
    def __init__(self, bucket, batch):
        self.device_seconds = 1e-4 * bucket * batch


class _StubSurface:
    """One price list handed to both routers."""

    def estimate_serve(self, bucket, batch, dtype):
        return _StubEstimate(bucket, batch)


def _routing_story(fleet_module):
    """A request sequence against fresh fakes: least loaded, priced
    queues, a dispatch held open, a shed backend, a client error, a
    total shed, then a canary window. Returns which fake answered each
    request, the statuses, the verdict and the ledger."""
    f0, f1 = _FakeBackend(flow=0.5), _FakeBackend(flow=0.52)
    cfg = fleet_module.FleetConfig(
        poll_interval_s=3600.0, poll_timeout_s=2.0, degraded_after=1,
        quarantine_after=2, retry_after_s=7, predict_timeout_s=10.0,
        canary_fraction=0.5, canary_min_samples=3)
    router = fleet_module.build_fleet([f0.target, f1.target], cfg=cfg,
                                      cost_surface=_StubSurface())
    seen = []

    def send(n=20):
        before = (f0.predicts, f1.predicts)
        status, body, retry = router.route_predict(_predict_doc(n))
        seen.append((status, f0.predicts - before[0],
                     f1.predicts - before[1], retry))

    try:
        router.poll_once()
        for n in (20, 40, 20):
            send(n)
        f0.in_flight_report = 3
        router.poll_once()
        send(40)
        router.backends[1].begin_dispatch(0.5)
        send(20)
        router.backends[1].end_dispatch(0.5)
        f1.mode = "shed"
        send(20)
        f0.mode = "client_error"
        send(20)
        f0.mode = "shed"
        send(20)
        f0.mode = f1.mode = "ok"
        f0.in_flight_report = 0
        router.poll_once()
        status, out = router.admin_reload_doc(
            {"ckpt": "/ckpts/v5", "backend": 1, "canary": True})
        seen.append((status, out["canary"]["canary_backend"]))
        for _ in range(8):
            send(30)
        verdict = router.canary.status()["verdict"]
        snap = router.metrics.snapshot()
        text = router.metrics.prometheus(
            [b.snapshot() for b in router.backends])
        health = router.health_doc()
    finally:
        f0.stop()
        f1.stop()
    for row in health["backends"]:
        row.pop("endpoint")
    return seen, verdict, snap, text, health


def test_port_router_routes_like_the_jax_router():
    import pvraft_tpu.fleet as jax_fleet
    import pvraft_tpu_torch.fleet as port_fleet

    want = _routing_story(jax_fleet)
    got = _routing_story(port_fleet)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1]["verdict"] == "promote"
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[4] == want[4]
    # The story did reach every branch.
    statuses = [row[0] for row in got[0]]
    assert {200, 400, 503} <= set(statuses)
    assert got[2]["spillovers_total"] >= 2 and got[2]["shadow_total"] >= 3


def test_router_events_pass_both_validators(tmp_path):
    from pvraft_tpu.obs.events import validate_events_file as jax_validate

    path = str(tmp_path / "fleet.events.jsonl")
    telemetry = ServeTelemetry(path)
    f0, f1 = _FakeBackend(flow=0.5), _FakeBackend(flow=0.5)
    router = build_fleet([f0.target, f1.target],
                         cfg=_tiny_cfg(canary_fraction=1.0,
                                       canary_min_samples=2),
                         telemetry=telemetry)
    try:
        router.poll_once()
        router.route_predict(_predict_doc())
        f0.mode = "shed"
        router.route_predict(_predict_doc())
        f0.mode = "ok"
        router.admin_canary_doc({"backend": 1})
        for _ in range(2):
            router.route_predict(_predict_doc())
    finally:
        f0.stop()
        f1.stop()
        telemetry.close()
    assert validate_events_file(path) == [] == jax_validate(path)
    records = [json.loads(line) for line in open(path, encoding="utf-8")]
    reasons = [r["reason"] for r in records if r["type"] == "fleet_route"]
    assert reasons == ["least_loaded", "spillover", "canary", "shadow",
                       "canary", "shadow"]
    verdicts = [r for r in records if r["type"] == "canary_verdict"]
    assert [v["verdict"] for v in verdicts] == ["promote"]
    assert verdicts[0]["samples"] == 2 and verdicts[0]["epe"] == 0.0


# ------------------------------------- the engine's swap, on a port engine --

TINY_SERVE = dict(buckets=(32, 64), batch_sizes=(1,), num_iters=2,
                  dtype="float32", replicas=1)


@pytest.fixture(scope="module")
def tiny():
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.serve import ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    model = ModelConfig(truncate_k=16, corr_knn=8, graph_k=4)
    return (model, ServeConfig(model=model, **TINY_SERVE),
            seeded_state_dict(model, 0))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clouds(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, 3)).astype(np.float32))


def test_engine_hot_swap_changes_weights_without_recapture(tiny, tmp_path):
    """A swap changes the served weights (digest and flows) while the
    captured table stays as it was."""
    from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
    from pvraft_tpu_torch.serve import InferenceEngine, params_digest
    from pvraft_tpu_torch.weights import params_to_jax

    _, cfg, state = tiny
    engine = InferenceEngine(state, cfg, device="cpu")
    pc1, pc2 = _clouds(20, 7)
    before = engine.predict(pc1, pc2)
    programs_before = engine.compile_report()
    info = engine.weights_info()
    assert info["digest"] == params_digest(state) and info["swaps"] == 0
    bumped = {k: v * 1.01 if v.is_floating_point() else v
              for k, v in state.items()}
    save_checkpoint(str(tmp_path), params_to_jax(bumped), None, 7,
                    checkpoint_interval=0)
    report = engine.reload_checkpoint(
        str(tmp_path / "last_checkpoint.msgpack"))
    assert report["digest"] != report["previous_digest"] == info["digest"]
    assert report["epoch"] == 7 and report["drained_in_time"] is True
    info = engine.weights_info()
    assert info["digest"] == report["digest"] and info["swaps"] == 1
    assert not np.allclose(before, engine.predict(pc1, pc2))
    assert engine.compile_report() == programs_before


def test_engine_swap_rejects_structure_mismatch(tiny):
    from pvraft_tpu_torch.serve import InferenceEngine

    _, cfg, state = tiny
    engine = InferenceEngine(state, cfg, device="cpu")
    digest = engine.weights_info()["digest"]
    with pytest.raises(ValueError, match="swap rejected"):
        engine.swap_params({"nope": torch.zeros(3)})
    assert engine.weights_info()["digest"] == digest


# ------------------------------------------ the port router over port hosts --


def test_port_router_over_port_hosts(tiny, tmp_path):
    """Two tiny port hosts behind the port's router: flows bitwise the
    host engine's, ``/admin/reload`` fanned out with the digest changing
    on both, a canary of the same weights promoted, and the stream of
    ``fleet_route`` and ``canary_verdict`` records valid for both
    packages' validators."""
    from pvraft_tpu.obs.events import validate_events_file as jax_validate
    from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
    from pvraft_tpu_torch.serve import (InferenceEngine, build_service,
                                        params_digest)
    from pvraft_tpu_torch.weights import params_to_jax, seeded_state_dict

    model, cfg, state = tiny
    engines = [InferenceEngine(state, cfg, device="cpu") for _ in range(2)]
    servers = [build_service(e) for e in engines]
    for s in servers:
        s.start()
    events = str(tmp_path / "fleet.events.jsonl")
    telemetry = ServeTelemetry(events)
    router = build_fleet(servers, telemetry=telemetry, cfg=FleetConfig(
        poll_interval_s=3600.0, predict_timeout_s=60.0,
        canary_fraction=1.0, canary_min_samples=2))
    router.start()
    try:
        pc1, pc2 = _clouds(20, 1)
        want = engines[0].predict(pc1, pc2)
        doc = {"pc1": pc1.tolist(), "pc2": pc2.tolist()}
        for _ in range(2):
            status, body, _ = router.route_predict(doc)
            assert status == 200
            np.testing.assert_array_equal(
                np.asarray(body["flow"], np.float32), want)
        new = seeded_state_dict(model, 9)
        paths = {}
        for name, weights in (("new", new), ("again", new)):
            save_checkpoint(str(tmp_path / name), params_to_jax(weights),
                            {}, 3, checkpoint_interval=0)
            paths[name] = str(tmp_path / name / "last_checkpoint.msgpack")
        status, out = router.admin_reload_doc({"ckpt": paths["new"]})
        assert status == 200
        assert [r["report"]["digest"] for r in out["swapped"]] == \
            [params_digest(new)] * 2
        status, out = router.admin_reload_doc(
            {"ckpt": paths["again"], "backend": 1, "canary": True})
        assert status == 200 and out["canary"]["armed"]
        for _ in range(2):
            assert router.route_predict(doc)[0] == 200
        verdict = router.canary.status()["verdict"]
        assert verdict["verdict"] == "promote" and verdict["epe"] == 0.0
        # Two least loaded to host 0, two canaries to host 1, each
        # mirrored to host 0.
        assert [s.batcher.counts["served"] for s in servers] == [4, 2]
    finally:
        router.shutdown()
        for s in servers:
            s.shutdown(drain=True)
        telemetry.close()
    assert validate_events_file(events) == [] == jax_validate(events)
    types = [json.loads(line)["type"] for line in open(events)]
    assert types.count("fleet_route") == 6 and "canary_verdict" in types
