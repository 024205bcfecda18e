"""The port's load tools held to the JAX package's: the load generator
(``serve/loadgen.py``), the SLO report (``obs/slo.py``), the bucket
advisor (``serve/advisor.py``), the capacity plan (``obs/capacity.py``),
the calibration and fleet-chaos schemas and the CLIs that validate them.

Every validator gives ``[]`` on the JAX package's committed evidence
under ``artifacts/`` (read, never written) and the JAX validator's
problem list, string for string, on mutated copies. The reports built
equal JAX's on the same inputs. ``run_load`` draws the same payloads as
JAX's from one seed, and one small run against a tiny CPU port service
(two requests shed and retried) gives a document both validators accept.
HTTP tests run under a deadline of their own (SIGALRM)."""

import copy
import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from pvraft_tpu.fleet.artifact import validate_fleet_artifact as j_fleet
from pvraft_tpu.obs.calibration import validate_calibration as j_calibration
from pvraft_tpu.obs.capacity import build_capacity_report as j_capacity
from pvraft_tpu.obs.capacity import validate_capacity as j_validate_capacity
from pvraft_tpu.obs.slo import build_slo_report as j_slo
from pvraft_tpu.obs.slo import exact_quantile as j_quantile
from pvraft_tpu.obs.slo import validate_slo_report as j_validate_slo
from pvraft_tpu.obs.trace import validate_trace_artifact as j_trace
from pvraft_tpu.serve import advisor as j_advisor
from pvraft_tpu.serve import loadgen as j_loadgen
from pvraft_tpu_torch.fleet.artifact import validate_fleet_artifact
from pvraft_tpu_torch.obs import slo
from pvraft_tpu_torch.obs.calibration import (validate_calibration,
                                              validate_calibration_file)
from pvraft_tpu_torch.obs.capacity import (build_capacity_report,
                                           validate_capacity,
                                           validate_capacity_file)
from pvraft_tpu_torch.obs.events import read_events
from pvraft_tpu_torch.obs.loading import load_json_artifact
from pvraft_tpu_torch.obs.trace import (validate_trace_artifact,
                                        validate_trace_artifact_file)
from pvraft_tpu_torch.serve import advisor, loadgen

REPO = Path(__file__).resolve().parents[1]
ART = REPO / "artifacts"
LOAD = "artifacts/serve_cpu_synthetic.json"
EVENTS = "artifacts/serve_cpu_synthetic.events.jsonl"
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


def _doc(name):
    return json.loads((ART / name).read_text())


# (port validator, JAX validator, committed artifact)
VALIDATORS = {
    "load": (loadgen.validate_load_artifact, j_loadgen.validate_load_artifact,
             "serve_cpu_synthetic.json"),
    "trace": (validate_trace_artifact, j_trace,
              "serve_cpu_synthetic.trace.json"),
    "slo": (slo.validate_slo_report, j_validate_slo,
            "serve_cpu_synthetic.slo.json"),
    "capacity": (validate_capacity, j_validate_capacity,
                 "capacity_report.json"),
    "calibration": (validate_calibration, j_calibration,
                    "serve_calibration.json"),
    "fleet": (validate_fleet_artifact, j_fleet, "fleet_chaos.json"),
}


@pytest.mark.parametrize("kind", sorted(VALIDATORS))
def test_validators_pass_the_committed_jax_evidence(kind):
    port, jax_validate, name = VALIDATORS[kind]
    doc = _doc(name)
    assert port(doc, path=name) == [] == jax_validate(doc, path=name)


def _set(path, value):
    def mutate(doc):
        *head, last = path
        for key in head:
            doc = doc[key]
        doc[last] = value
    return mutate


def _drop(path):
    def mutate(doc):
        *head, last = path
        for key in head:
            doc = doc[key]
        del doc[last]
    return mutate


def _add(path, delta):
    def mutate(doc):
        *head, last = path
        for key in head:
            doc = doc[key]
        doc[last] += delta
    return mutate


def _whole(value):
    return lambda doc: value


MUTATIONS = [
    ("load", "not_an_object", _whole([1, 2])),
    ("load", "schema", _set(["schema"], "pvraft_serve_load/v0")),
    ("load", "dropped_latency", _drop(["latency_ms"])),
    ("load", "ok_type", _set(["requests", "ok"], "256")),
    ("load", "identity", _add(["requests", "ok"], -1)),
    ("load", "quantile_order", _set(["latency_ms", "p50"], 1e9)),
    ("load", "per_request_status", _set(["per_request", 3, "status"], "ok")),
    ("load", "per_request_count", lambda d: d["per_request"].pop()),
    ("load", "forged_attempts", _set(["per_request", 0, "attempts"],
                                     [{"status": 503}, {"status": 503}])),
    ("load", "targets", _set(["config", "targets"], [])),
    ("load", "request_points", _set(["request_points", "counts"], [1])),
    ("load", "compile_type", _set(["compile"], {})),
    ("trace", "complete_flag", _set(["traces", 0, "complete"], False)),
    ("trace", "counts", _add(["counts", "spans"], 1)),
    ("trace", "no_stages", _set(["expected_stages"], [])),
    ("trace", "span_order", _set(["traces", 0, "spans", 1, "end_ms"], -1.0)),
    ("trace", "dropped_traces", _drop(["traces"])),
    ("slo", "schema", _set(["schema"], "x")),
    ("slo", "dropped_runs", _drop(["runs"])),
    ("slo", "headline", _add(["max_qps_under_slo"], 10.0)),
    ("slo", "complete_above_traced", _add(["totals", "complete"], 5)),
    ("slo", "missing_stage", _drop(["programs", 0, "stages", "respond"])),
    ("slo", "e2e_order", _set(["programs", 0, "e2e", "p50_ms"], 1e9)),
    ("slo", "totals_type", _set(["totals"], [])),
    ("slo", "p99_type", _set(["slo", "p99_ms"], "fast")),
    ("capacity", "chips_needed", _add(["demand", 1, "chips_needed"], 3)),
    ("capacity", "comparable_off_tpu",
     _set(["measured_evidence", "comparable"], True)),
    ("capacity", "ceiling", _set(["utilization_ceiling"], 1.5)),
    ("capacity", "fractions", _set(["per_bucket", 0, "traffic_fraction"],
                                   1.5)),
    ("capacity", "extrapolated_type",
     _set(["per_bucket", 0, "extrapolated"], "no")),
    ("capacity", "no_rows", _set(["per_bucket"], [])),
    ("capacity", "dropped_demand", _drop(["demand"])),
    ("calibration", "comparable_off_tpu",
     _set(["records", 0, "comparable"], True)),
    ("calibration", "violations", _set(["identity", "violations"], 2)),
    ("calibration", "no_snapshots", _set(["identity", "snapshots"], 0)),
    ("calibration", "ratio", _add(["records", 0, "ratio"], 1.0)),
    ("calibration", "negative", _set(["records", 0, "measured_s"], -1.0)),
    ("calibration", "n", _set(["records", 0, "n"], 0)),
    ("calibration", "no_records", _set(["records"], [])),
    ("calibration", "dropped_platform", _drop(["platform"])),
    ("fleet", "schema", _set(["schema"], "x")),
    ("fleet", "one_backend", _set(["config", "backends"], 1)),
    ("fleet", "phase_order", lambda d: d["phases"].reverse()),
    ("fleet", "no_spill", _set(["phases", 1, "spillovers"], 0)),
    ("fleet", "recompiles", _set(["recompiles"], 3)),
    ("fleet", "few_snapshots", _set(["reconciliation", "snapshots"], 2)),
    ("fleet", "broken_load", _drop(["load", "latency_ms"])),
    ("fleet", "verdict", _set(["phases", 3, "verdict", "verdict"], "maybe")),
    ("fleet", "same_digest", lambda d: d["phases"][2]["swap"]["swapped"][0][
        "report"].update(digest=d["phases"][2]["swap"]["swapped"][0][
            "report"]["previous_digest"])),
    ("fleet", "mix", _set(["config", "traffic_mix", 0, "fraction"], 3.0)),
]


@pytest.mark.parametrize("kind,name,mutate", MUTATIONS,
                         ids=[f"{k}-{n}" for k, n, _ in MUTATIONS])
def test_validators_agree_with_jax_on_mutated_copies(kind, name, mutate):
    port, jax_validate, artifact = VALIDATORS[kind]
    doc = copy.deepcopy(_doc(artifact))
    out = mutate(doc)
    doc = doc if out is None else out
    want = jax_validate(copy.deepcopy(doc), path=artifact)
    assert want, f"{kind}/{name}: the mutation is valid to JAX"
    assert port(doc, path=artifact) == want


@pytest.mark.parametrize("kind,port_file,jax_file", [
    ("load", loadgen.validate_load_artifact_file,
     j_loadgen.validate_load_artifact_file),
    ("trace", validate_trace_artifact_file, None),
    ("capacity", validate_capacity_file, None),
    ("calibration", validate_calibration_file, None),
])
def test_file_validators_on_unreadable_files(kind, port_file, jax_file,
                                             tmp_path):
    import pvraft_tpu.obs as jobs

    jax_file = jax_file or {
        "trace": jobs.validate_trace_artifact_file,
        "capacity": jobs.validate_capacity_file,
        "calibration": jobs.validate_calibration_file}[kind]
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    missing = tmp_path / "missing.json"
    for path in (str(bad), str(missing)):
        assert port_file(path) == jax_file(path) != []


def test_load_json_artifact_one_line(tmp_path):
    from pvraft_tpu.obs.loading import load_json_artifact as jax_load

    two = tmp_path / "two.jsonl"
    two.write_text('{"a": 1}\n{"b": 2}\n')
    one = tmp_path / "one.jsonl"
    one.write_text('\n{"a": 1}\n')
    for path in (two, one):
        for flag in (True, False):
            assert (load_json_artifact(str(path), one_line=flag)
                    == jax_load(str(path), one_line=flag))
    assert load_json_artifact(str(one), one_line=True) == ({"a": 1}, [])


# ------------------------------------------------------------- the reports --


def _sources():
    load = _doc("serve_cpu_synthetic.json")
    records = read_events(str(REPO / EVENTS))
    return [(LOAD, load, EVENTS, records)]


def test_slo_report_equals_jax_and_the_committed_report():
    committed = _doc("serve_cpu_synthetic.slo.json")
    band = tuple(committed["slo"]["ratio_band"])
    got = slo.build_slo_report(_sources(), 2000.0, ratio_band=band)
    assert got == j_slo(_sources(), 2000.0, ratio_band=band)
    assert got == committed
    assert slo.validate_slo_report(got) == []
    for q in (0.0, 0.5, 0.99, 1.0):
        assert slo.exact_quantile([3.0, 1.0, 2.0], q) == \
            j_quantile([3.0, 1.0, 2.0], q)
    assert slo.exact_quantile([], 0.5) is None


ADVISOR_CASES = [
    ([128.0, 256.0, 8192.0], [100, 100, 10, 0], 2, 0),
    ([128.0, 256.0, 8192.0], [100, 100, 10, 0], 1, 0),
    ([128.0, 256.0, 8192.0], [100, 100, 10, 0], 2, 200),
    ([1024.0, 8192.0], [100, 100, 0], 2, 0),
    ([32, 64, 128, 256, 512], [0, 7, 0, 3, 5, 2], 3, 64),
]


@pytest.mark.parametrize("edges,counts,k,floor", ADVISOR_CASES)
def test_advisor_equals_jax(edges, counts, k, floor):
    assert advisor.propose_buckets(edges, counts, k, min_bucket=floor) == \
        j_advisor.propose_buckets(edges, counts, k, min_bucket=floor)
    assert advisor.candidate_buckets(edges, counts, floor) == \
        j_advisor.candidate_buckets(edges, counts, floor)
    for table in ([128], [256, 8192], [1024]):
        assert advisor.score_buckets(table, edges, counts) == \
            j_advisor.score_buckets(table, edges, counts)
    assert advisor.build_advisor_report(
        edges, counts, [1024], n_buckets=k, min_bucket=floor) == \
        j_advisor.build_advisor_report(edges, counts, [1024], n_buckets=k,
                                       min_bucket=floor)


def test_advisor_on_the_committed_histogram_and_surface():
    from pvraft_tpu.programs.costs import CostSurface as JSurface
    from pvraft_tpu_torch.programs.costs import CostSurface

    rp = _doc("serve_cpu_synthetic.json")["request_points"]
    costs = str(ART / "programs_costs.json")
    for surface in (None, JSurface.load(costs)):
        for current, dtype in (([2048, 4096, 8192], "bfloat16"),
                               ([2048, 8192], "float32")):
            assert advisor.build_advisor_report(
                rp["edges"], rp["counts"], current, source=LOAD,
                cost_surface=surface, dtype=dtype) == \
                j_advisor.build_advisor_report(
                    rp["edges"], rp["counts"], current, source=LOAD,
                    cost_surface=surface, dtype=dtype)
    # The port's own surface over the same document prices on the H100
    # roofline: the report still takes the seconds objective.
    report = advisor.build_advisor_report(
        rp["edges"], rp["counts"], [2048, 8192], min_bucket=2048,
        cost_surface=CostSurface.load(costs), dtype="float32")
    assert report["objective"]["unit"] == "device_seconds"
    with pytest.raises(ValueError):
        advisor.propose_buckets([1.0], [0, 5], 1)


def _capacity_inputs():
    committed = _doc("capacity_report.json")
    return committed, dict(
        load_doc=_doc("serve_cpu_synthetic.json"),
        slo_doc=_doc("serve_cpu_synthetic.slo.json"),
        buckets=(2048, 4096, 8192), batch_sizes=(1, 4),
        dtype=committed["dtype"],
        qps_ladder=tuple(r["qps"] for r in committed["demand"]),
        utilization_ceiling=committed["utilization_ceiling"],
        inputs=committed["inputs"])


def test_capacity_report_equals_jax_and_the_committed_plan():
    from pvraft_tpu.programs.costs import CostSurface as JSurface
    from pvraft_tpu_torch.programs.costs import CostSurface

    committed, kw = _capacity_inputs()
    surface = JSurface.load(str(REPO / committed["inputs"]["costs"]))
    got = build_capacity_report(surface, **kw)
    assert got == j_capacity(surface, **kw) == committed
    # On the port's surface: H100 roofline seconds, the same rounding,
    # byte-deterministic, valid, and flagged not comparable off a TPU.
    port_surface = CostSurface.load(str(REPO / committed["inputs"]["costs"]))
    plan = build_capacity_report(port_surface, **kw)
    assert json.dumps(plan, sort_keys=True) == json.dumps(
        build_capacity_report(port_surface, **kw), sort_keys=True)
    assert validate_capacity(plan) == [] == j_validate_capacity(plan)
    assert plan["per_bucket"][0]["basis"] == "roofline"
    assert plan["measured_evidence"]["comparable"] is False
    with pytest.raises(ValueError):
        build_capacity_report(port_surface, **{**kw,
                                               "utilization_ceiling": 0.0})


def test_merge_measurements_equals_jax():
    load = _doc("serve_cpu_synthetic.json")
    a = {k: load[k] for k in ("requests", "latency_ms", "throughput_rps",
                              "duration_s", "per_request", "request_points",
                              "server_metrics")}
    b = copy.deepcopy(a)
    b["per_request"] = b["per_request"][:10]
    b["requests"] = {"total": 10, "ok": 10, "rejected": 0, "errors": 0}
    b["duration_s"] = 0.5
    assert loadgen.merge_measurements([a, b]) == \
        j_loadgen.merge_measurements([a, b])
    with pytest.raises(ValueError):
        loadgen.merge_measurements([])


# ----------------------------------------------------------- the payloads --


class _Recorder(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    bodies = None

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        pass

    def _json(self, doc):
        payload = json.dumps(doc).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 — stdlib handler naming
        self._json({"requests_total": len(self.bodies)})

    def do_POST(self):  # noqa: N802 — stdlib handler naming
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.bodies.append(body)
        self._json({"flow": [], "n": 0})


def _recorded(run_load, seed):
    handler = type("Recorder", (_Recorder,), {"bodies": []})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        m = run_load(targets=[f"127.0.0.1:{httpd.server_address[1]}"],
                     n_requests=5, concurrency=1, point_counts=[7, 12, 3],
                     seed=seed)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(5)
    return m, handler.bodies


def test_payloads_are_the_jax_draws():
    from pvraft_tpu.rng import host_rng

    got, bodies = _recorded(loadgen.run_load, 3)
    want_m, want_bodies = _recorded(j_loadgen.run_load, 3)
    assert bodies == want_bodies and len(bodies) == 5
    rng = host_rng(3, "serve.loadgen")
    for body, n in zip(bodies, (7, 12, 3, 7, 12)):
        doc = json.loads(body)
        pc1 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
        flow = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(doc["pc1"], np.float32),
                                      pc1)
        np.testing.assert_array_equal(np.asarray(doc["pc2"], np.float32),
                                      pc1 + flow)
    assert got["request_points"] == want_m["request_points"]
    assert got["server_metrics"] == {"requests_total": 5}
    assert [r["n"] for r in got["per_request"]] == [7, 12, 3, 7, 12]
    assert _recorded(loadgen.run_load, 4)[1] != bodies


# ------------------------------------------ one run on a tiny port service --


@pytest.fixture(scope="module")
def tiny_service():
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    model = ModelConfig(truncate_k=16, corr_knn=8, graph_k=4)
    cfg = ServeConfig(model=model, buckets=(32, 64), batch_sizes=(1,),
                      num_iters=2, dtype="float32", replicas=1)
    return InferenceEngine(seeded_state_dict(model, 0), cfg, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _artifact(m):
    return {"schema": loadgen.SCHEMA_VERSION, "config": {}, "compile": [],
            **m}


def test_run_load_on_a_port_service_and_its_slo_report(tiny_service,
                                                       tmp_path):
    from pvraft_tpu_torch.serve import ServeTelemetry, build_service

    events = str(tmp_path / "load.events.jsonl")
    telemetry = ServeTelemetry(events, cfg=tiny_service.cfg)
    server = build_service(tiny_service, telemetry=telemetry,
                           trace_sample_every=1)
    server.start()
    try:
        m = loadgen.run_load(server, n_requests=6, concurrency=2,
                             point_counts=[20, 50], seed=1)
    finally:
        server.shutdown(drain=True)
        telemetry.close()
    assert m["requests"] == {"total": 6, "ok": 6, "rejected": 0,
                             "errors": 0}
    assert m["server_metrics"]["responses_total"] == 6
    doc = {**_artifact(m), "config": {"compute_dtype": "float32",
                                      "platform": tiny_service.platform}}
    assert loadgen.validate_load_artifact(doc) == [] == \
        j_loadgen.validate_load_artifact(doc)
    out = str(tmp_path / "load.json")
    trace_path, trace = loadgen.write_load_and_trace(out, doc, events)
    assert trace["counts"]["complete"] == 6
    assert validate_trace_artifact_file(trace_path) == [] == \
        j_trace(json.loads(Path(trace_path).read_text()))
    sources = [(out, doc, events, read_events(events))]
    report = slo.build_slo_report(sources, 1e6, ratio_band=(0.5, 2.0))
    assert report == j_slo(sources, 1e6, ratio_band=(0.5, 2.0))
    assert report["totals"]["complete"] == 6
    assert [(p["bucket"], p["batch"]) for p in report["programs"]] == \
        [(32, 1), (64, 1)]
    assert slo.validate_slo_report(report) == [] == j_validate_slo(report)
    rp = m["request_points"]
    assert advisor.build_advisor_report(rp["edges"], rp["counts"],
                                        [32, 64]) == \
        j_advisor.build_advisor_report(rp["edges"], rp["counts"], [32, 64])


def test_run_load_retries_record_attempts(tiny_service, tmp_path):
    """With the pool quarantined, each request's one retry is shed too:
    both attempts recorded, final status 503, counted rejected."""
    from pvraft_tpu_torch.serve import (FaultPlan, FaultRule,
                                        SupervisorConfig, build_service,
                                        faults)

    server = build_service(tiny_service, supervisor_cfg=SupervisorConfig(
        degraded_after=1, quarantine_after=1, probe_interval_s=0))
    server.start()
    try:
        faults.install_plan(FaultPlan([
            FaultRule("replica_predict_error", nth=1, every=1)]))
        first = loadgen._post_json(
            server.host, server.port, "/predict",
            {"pc1": [[0.0, 0.0, 0.0]] * 20, "pc2": [[0.0, 0.0, 0.0]] * 20},
            timeout=60.0)
        assert first["status"] == 500
        assert server.supervisor.serving_count() == 0
        m = loadgen.run_load(server, n_requests=3, concurrency=3,
                             point_counts=[20], retries=1)
    finally:
        faults.clear_plan()
        server.shutdown(drain=True)
    assert m["requests"] == {"total": 3, "ok": 0, "rejected": 3,
                             "errors": 0}
    for r in m["per_request"]:
        assert r["status"] == 503
        assert [a["status"] for a in r["attempts"]] == [503, 503]
    doc = _artifact(m)
    assert loadgen.validate_load_artifact(doc) == [] == \
        j_loadgen.validate_load_artifact(doc)
    doc["per_request"][0]["attempts"][-1]["status"] = 200
    assert loadgen.validate_load_artifact(doc) == \
        j_loadgen.validate_load_artifact(doc) != []


# ---------------------------------------------------------------- the CLIs --


def _broken_copy(tmp_path, name, mutate):
    doc = _doc(name)
    mutate(doc)
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def test_serve_validate_load_cli_exits_like_jax(tmp_path, capsys):
    from pvraft_tpu.serve.__main__ import main as jax_main
    from pvraft_tpu_torch.serve.__main__ import main

    good = str(ART / "serve_cpu_synthetic.json")
    bad = _broken_copy(tmp_path, "serve_cpu_synthetic.json",
                       _add(["requests", "ok"], -1))
    for paths, rc in (([good], 0), ([bad], 1), ([good, bad], 1),
                      ([str(tmp_path / "none.json")], 1)):
        assert main(["validate-load", *paths]) == rc
        port = capsys.readouterr()
        assert jax_main(["validate-load", *paths]) == rc
        assert capsys.readouterr() == port


OBS_CASES = [
    ("validate", "serve_cpu_synthetic.events.jsonl", None),
    ("validate-trace", "serve_cpu_synthetic.trace.json",
     _set(["counts", "spans"], 0)),
    ("validate-slo", "serve_cpu_synthetic.slo.json",
     _add(["max_qps_under_slo"], 1.0)),
    ("validate-capacity", "capacity_report.json",
     _add(["demand", 0, "chips_needed"], 1)),
    ("validate-calibration", "serve_calibration.json",
     _set(["identity", "violations"], 1)),
]


@pytest.mark.parametrize("cmd,name,mutate", OBS_CASES,
                         ids=[c for c, _, _ in OBS_CASES])
def test_obs_cli_exits_like_jax(cmd, name, mutate, tmp_path, capsys):
    from pvraft_tpu.obs.__main__ import main as jax_main
    from pvraft_tpu_torch.obs.__main__ import main

    cases = [([str(ART / name)], 0)]
    if mutate is not None:
        cases.append(([_broken_copy(tmp_path, name, mutate)], 1))
    else:
        bad = tmp_path / name
        bad.write_text('{"type": "span"}\n')
        cases.append(([str(bad)], 1))
    for paths, rc in cases:
        assert main([cmd, *paths]) == rc
        port = capsys.readouterr()
        assert jax_main([cmd, *paths]) == rc
        assert capsys.readouterr() == port


def test_obs_cli_refuses_validate_bench(capsys):
    from pvraft_tpu_torch.obs.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["validate-bench", str(ART / "bench_baseline.json")])
    assert e.value.code == 2
    assert "benchmark cell" in capsys.readouterr().err


def test_serve_loadgen_cli_takes_the_service_defaults():
    from pvraft_tpu_torch.serve.__main__ import build_parser
    from pvraft_tpu_torch.serve.engine import (SERVE_DEFAULT_BATCH_SIZES,
                                               SERVE_DEFAULT_BUCKETS,
                                               SERVE_DEFAULT_DTYPE,
                                               SERVE_DEFAULT_ITERS)

    parser = build_parser()
    served = vars(parser.parse_args(["serve", "--ckpt", "c.msgpack"]))
    loaded = vars(parser.parse_args(["loadgen", "--out", "l.json"]))
    shared = ("buckets", "batch_sizes", "iters", "truncate_k", "corr_knn",
              "graph_k", "dtype", "replicas", "max_wait_ms", "queue_depth")
    assert {k: loaded[k] for k in shared} == {k: served[k] for k in shared}
    assert loaded["buckets"] == ",".join(map(str, SERVE_DEFAULT_BUCKETS))
    assert loaded["batch_sizes"] == ",".join(
        map(str, SERVE_DEFAULT_BATCH_SIZES))
    assert (loaded["iters"], loaded["dtype"]) == (SERVE_DEFAULT_ITERS,
                                                 SERVE_DEFAULT_DTYPE)
    assert (loaded["truncate_k"], loaded["corr_knn"],
            loaded["graph_k"]) == (512, 32, 32)


def test_serve_loadgen_cli_writes_three_valid_artifacts(tmp_path, capsys):
    from pvraft_tpu_torch.obs.events import validate_events_file
    from pvraft_tpu_torch.serve.__main__ import main

    out = str(tmp_path / "load.json")
    assert main(["loadgen", "--device", "cpu", "--out", out,
                 "--buckets", "32,64", "--batch_sizes", "1",
                 "--truncate_k", "16", "--corr_knn", "8", "--graph_k", "4",
                 "--iters", "2", "--dtype", "float32", "--requests", "4",
                 "--concurrency", "2", "--seed", "2"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ok"] == 4
    doc = json.loads(Path(out).read_text())
    assert doc["config"]["platform"] == "cpu"
    assert doc["config"]["point_counts"] == [24, 30, 56, 62]
    assert loadgen.validate_load_artifact_file(out) == [] == \
        j_loadgen.validate_load_artifact_file(out)
    assert validate_events_file(str(tmp_path / "load.events.jsonl")) == []
    assert validate_trace_artifact_file(str(tmp_path / "load.trace.json")) \
        == []
