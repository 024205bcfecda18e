"""The port's service observability against the JAX package's, on the
CPU: both services (the tiny serve model, one replica, the same weights)
built with a telemetry stream, ``trace_sample_every=1`` and
``strict_retrace=True``, get the same HTTP requests; then their span
trees (by ``trace_shape``), event types and counts, Prometheus families,
``/healthz`` telemetry blocks, concurrent ``/debug/trace`` windows and
``compile_trip`` outcomes must agree, and the port's stream must pass
JAX's validator. One scenario runs once per module; each test reads a
part of it. Waits are on joins and replies, never on wall time.
"""

import collections
import http.client
import json
import re
import threading

import numpy as np
import pytest
import torch

import pvraft_tpu.serve.server as jserver_mod
from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.obs.events import validate_events_file as jvalidate
from pvraft_tpu.serve import InferenceEngine as JEngine
from pvraft_tpu.serve import ServeConfig as JServeConfig
from pvraft_tpu.serve import ServeTelemetry as JTelemetry
from pvraft_tpu.serve import build_service as jbuild_service
from pvraft_tpu.serve import faults as jfaults
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.engine import msgpack
from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
from pvraft_tpu_torch.obs.events import read_events, validate_events_file
from pvraft_tpu_torch.obs.trace import SERVE_STAGES, trace_shape
from pvraft_tpu_torch.serve import (
    InferenceEngine,
    ServeConfig,
    ServeTelemetry,
    build_service,
)
from pvraft_tpu_torch.serve import faults as tfaults
from pvraft_tpu_torch.serve import server as tserver_mod
from pvraft_tpu_torch.weights import params_to_jax, seeded_state_dict

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 4}
SERVE = {"buckets": (32,), "batch_sizes": (1,), "num_iters": 2,
         "dtype": "float32", "replicas": 1}
# The cost plane's families (ROADMAP queue 1 item 9c): none of them is
# rendered while no cost surface is armed, on either side.
ITEM9C_FAMILIES = {
    "pvraft_serve_predicted_device_seconds_total",
    "pvraft_serve_device_busy_seconds_total",
    "pvraft_serve_replica_utilization",
    "pvraft_serve_cost_predicted_seconds_total",
    "pvraft_serve_cost_measured_seconds_total",
    "pvraft_serve_cost_dispatches_total",
    "pvraft_serve_cost_calibration_ratio"}


def _cloud(rng, n):
    return rng.uniform(-1, 1, (n, 3)).astype(np.float32)


def _requests():
    rng = np.random.default_rng(5)
    ok = (_cloud(rng, 20), _cloud(rng, 26))
    return [
        ("json", json.dumps({"pc1": ok[0].tolist(), "pc2": ok[1].tolist()}),
         "application/json"),
        ("msgpack", msgpack.packb({"pc1": ok[0].tobytes(),
                                   "pc2": ok[1].tobytes()}),
         "application/msgpack"),
        ("too_small", json.dumps({"pc1": _cloud(rng, 8).tolist(),
                                  "pc2": _cloud(rng, 8).tolist()}),
         "application/json"),
        ("not_json", "not json", "application/json"),
        ("too_large", json.dumps({"pc1": _cloud(rng, 40).tolist(),
                                  "pc2": _cloud(rng, 40).tolist()}),
         "application/json"),
    ]


def _call(conn, method, path, body=None, ctype="application/json"):
    conn.request(method, path, body=body,
                 headers={"Content-Type": ctype} if body is not None
                 else {})
    resp = conn.getresponse()
    return resp.status, resp.read(), dict(resp.getheaders())


def _families(text):
    return set(re.findall(r"^# TYPE (\S+) ", text, re.M))


def _drive(server, lock, install, clear, rule, ckpt):
    """The scenario against one started service; returns what the tests
    compare. On one keep-alive connection a request is followed by a
    ``/healthz`` whose reply orders it after the request's span emits
    (one handler thread serves the connection in turn)."""
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    out = {"traces": {}}
    try:
        for name, body, ctype in _requests():
            status, _, headers = _call(conn, "POST", "/predict", body, ctype)
            _call(conn, "GET", "/healthz")
            out["traces"][name] = (status, headers.get("X-Pvraft-Trace"))
        # Two /debug/trace windows at once: the second gets 409.
        first = {}

        def window():
            c = http.client.HTTPConnection(server.host, server.port,
                                           timeout=60)
            first["status"] = _call(c, "GET", "/debug/trace?seconds=1")[0]
            c.close()

        t = threading.Thread(target=window)
        t.start()
        deadline = threading.Event()
        for _ in range(3000):
            if lock.locked() or not t.is_alive():
                break
            deadline.wait(0.002)
        out["second_window"] = _call(conn, "GET", "/debug/trace?seconds=1")[0]
        t.join(60)
        out["first_window"] = first.get("status")
        # compile_trip under strict_retrace: 500, replica not quarantined.
        install(rule)
        try:
            body, ctype = _requests()[0][1:]
            out["trip"] = _call(conn, "POST", "/predict", body, ctype)[0]
        finally:
            clear()
        out["after_trip"] = _call(conn, "POST", "/predict", body, ctype)[0]
        out["reload"] = _call(conn, "POST", "/admin/reload",
                              json.dumps({"ckpt": ckpt}))[0]
        health = json.loads(_call(conn, "GET", "/healthz")[1])
        out["telemetry"] = health["telemetry"]
        out["replica_states"] = [r["state"] for r in health["replicas"]]
        out["prometheus"] = _call(
            conn, "GET", "/metrics?format=prometheus")[1].decode()
    finally:
        conn.close()
    return out


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_obs")
    state = seeded_state_dict(TConfig(**TINY), 0)
    save_checkpoint(str(root / "ckpt"), params_to_jax(state), {}, 1,
                    checkpoint_interval=0)
    ckpt = str(root / "ckpt" / "last_checkpoint.msgpack")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    jpath, tpath = str(root / "jax.events.jsonl"), str(root /
                                                       "port.events.jsonl")
    jtel = JTelemetry(jpath, enabled=True)
    ttel = ServeTelemetry(tpath, enabled=True)
    jengine = JEngine(params_to_jax(state),
                      JServeConfig(model=JConfig(**TINY), **SERVE),
                      telemetry=jtel)
    tengine = InferenceEngine(state, ServeConfig(model=TConfig(**TINY),
                                                 **SERVE),
                              device="cpu", telemetry=ttel)
    sides = {}
    for side, engine, tel, build, lock, faults, trace_dir in (
            ("jax", jengine, jtel, jbuild_service,
             jserver_mod._DEBUG_TRACE_LOCK, jfaults, root / "jtraces"),
            ("port", tengine, ttel, build_service,
             tserver_mod._DEBUG_TRACE_LOCK, tfaults, root / "ttraces")):
        server = build(engine, telemetry=tel, trace_sample_every=1,
                       strict_retrace=True, trace_dir=str(trace_dir))
        server.start()
        try:
            rule = faults.FaultPlan([faults.FaultRule(
                "compile_trip", nth=1, max_fires=1)])
            sides[side] = _drive(server, lock, faults.install_plan,
                                 faults.clear_plan, rule, ckpt)
        finally:
            server.shutdown(drain=True)
            tel.close()
    sides["jax"]["path"], sides["port"]["path"] = jpath, tpath
    for side in sides.values():
        side["records"] = read_events(side["path"])
    torch.set_num_threads(prev)
    return sides


def test_port_stream_passes_both_validators(scenario):
    path = scenario["port"]["path"]
    assert jvalidate(path) == [] and validate_events_file(path) == []
    records = scenario["port"]["records"]
    assert records[0]["type"] == "run_header"
    assert records[-1]["type"] == "serve_shutdown"


def test_statuses_equal_jax(scenario):
    j, t = scenario["jax"], scenario["port"]
    assert {k: s for k, (s, _) in t["traces"].items()} == \
        {k: s for k, (s, _) in j["traces"].items()} == {
            "json": 200, "msgpack": 200, "too_small": 400,
            "not_json": 400, "too_large": 413}
    assert all(tid for _, tid in t["traces"].values())


def _tree(side, name):
    trace_id = side["traces"][name][1]
    spans = [r for r in side["records"]
             if r["type"] == "span" and r["trace_id"] == trace_id]
    roots, orphans, stages, complete = trace_shape(spans, SERVE_STAGES)
    return (len(roots), len(orphans), sorted(stages), complete,
            roots[0]["attrs"]["status"])


@pytest.mark.parametrize("name", [c[0] for c in _requests()])
def test_span_trees_equal_jax(scenario, name):
    """The same tree for the same request: a 200's is complete (all seven
    stages inside the root), an error's holds the stages it reached."""
    got = _tree(scenario["port"], name)
    assert got == _tree(scenario["jax"], name)
    if got[-1] == 200:
        assert got[3] and got[2] == sorted(SERVE_STAGES)
        trace_id = scenario["port"]["traces"][name][1]
        spans = [r for r in scenario["port"]["records"]
                 if r["type"] == "span" and r["trace_id"] == trace_id]
        root = next(s for s in spans if "parent_id" not in s)
        for s in spans:
            assert root["start_ms"] <= s["start_ms"] <= s["end_ms"] \
                <= root["end_ms"]
        execute = next(s for s in spans if s["name"] == "device_execute")
        assert execute["end_ms"] > execute["start_ms"]
        assert execute["attrs"]["bucket"] == 32


def test_event_type_counts_equal_jax(scenario):
    counts = {side: collections.Counter(r["type"] for r in s["records"])
              for side, s in scenario.items()}
    assert counts["port"] == counts["jax"]
    for etype in ("serve_compile", "serve_batch", "serve_reject", "span",
                  "trace_window", "recompile", "fault_injected",
                  "weight_swap", "serve_shutdown"):
        assert counts["port"][etype] > 0, etype


def test_prometheus_families_equal_jax(scenario):
    t, j = scenario["port"]["prometheus"], scenario["jax"]["prometheus"]
    assert _families(t) == _families(j) - ITEM9C_FAMILIES
    for text in (t, j):
        assert "pvraft_serve_recompiles_total 1" in text
        # The stage histograms count the traced 200s: json, msgpack and
        # the request after the trip.
        for stage in SERVE_STAGES:
            assert (f'pvraft_serve_stage_latency_ms_count{{bucket="32",'
                    f'stage="{stage}"}} 3') in text, stage


def test_healthz_telemetry_equal_jax(scenario):
    t, j = scenario["port"]["telemetry"], scenario["jax"]["telemetry"]
    assert set(t) == set(j)
    assert (t["tracing"], t["trace_sample_every"]) == \
        (j["tracing"], j["trace_sample_every"]) == (True, 1)
    assert t["events_path"] == scenario["port"]["path"]
    assert t["trace_dir"].endswith("ttraces")


def test_concurrent_debug_trace_windows_equal_jax(scenario):
    for side in ("port", "jax"):
        s = scenario[side]
        assert (s["first_window"], s["second_window"]) == (200, 409), side
        windows = [r for r in s["records"] if r["type"] == "trace_window"]
        assert [w["action"] for w in windows] == ["start", "stop"]
    window = next(r for r in scenario["port"]["records"]
                  if r["type"] == "trace_window")
    with open(f"{window['trace_dir']}/trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_compile_trip_under_strict_equal_jax(scenario):
    for side in ("port", "jax"):
        s = scenario[side]
        assert (s["trip"], s["after_trip"], s["reload"]) == (500, 200, 200)
        assert s["replica_states"] == ["healthy"], side
        rec = [r for r in s["records"] if r["type"] == "recompile"]
        assert len(rec) == 1 and rec[0]["program"] == "serve_dispatch_b32"
        fired = [r for r in s["records"] if r["type"] == "fault_injected"]
        assert [f["point"] for f in fired] == ["compile_trip"]
        assert not [r for r in s["records"] if r["type"] == "replica_state"]
