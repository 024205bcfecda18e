"""The port's cost plane against the JAX package's, on the CPU at the
catalog's tiny size: the kernels' bounds (``ops/kernel_bounds.py``,
pinned to ``PERF.md``'s Bound column), the op counter
(``programs/costs.py``), the ``pvraft_costs/v1`` inventory under both
validators, the port's and the JAX ``CostSurface`` on one document, the
serve cost plane (``serve/costing.py``, the metrics' cost series, the
events) and the Trainer's ``cost`` block. The inventory is counted once
per module; the cases mirror ``tests/test_costs.py`` and
``tests/test_capacity.py``.
"""

import copy
import dataclasses
import http.client
import json
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pvraft_tpu.obs.events import validate_event as jvalidate_event
from pvraft_tpu.obs.events import validate_events_file as jvalidate_file
from pvraft_tpu.programs import costs as jcosts
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.models.layers import Dense
from pvraft_tpu_torch.ops import kernel_bounds
from pvraft_tpu_torch.programs import get, load_catalog, specs
from pvraft_tpu_torch.programs import costs
from pvraft_tpu_torch.programs.__main__ import main as programs_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
COST_FAMILIES = {
    "pvraft_serve_predicted_device_seconds_total",
    "pvraft_serve_device_busy_seconds_total",
    "pvraft_serve_replica_utilization",
    "pvraft_serve_cost_predicted_seconds_total",
    "pvraft_serve_cost_measured_seconds_total",
    "pvraft_serve_cost_dispatches_total",
    "pvraft_serve_cost_calibration_ratio"}


@pytest.fixture(scope="module")
def inventory(tmp_path_factory):
    """The whole catalog counted on the CPU at "tiny", and its path."""
    load_catalog()
    doc = costs.run_costs(list(specs().values()), "cpu", "tiny")
    path = str(tmp_path_factory.mktemp("costs") / "programs_costs.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return doc, path


# --- the kernels' bounds ----------------------------------------------------


def _perf_bound_column():
    with open(os.path.join(REPO, "PERF.md"), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("case", ["lookup", "voxel", "gru_general",
                                  "gru_bf16", "gru_ops"])
def test_kernel_bounds_pinned_to_perf(case):
    """Kernel 1 at 1 x 8192, K 512: 75.1 MB; kernel 3: 69.8 MB; 2g at
    hidden 32 / context 96: 7.69 MB; 2b: 7.81 MB; kernel 2: 2.52 GFLOP of
    3xTF32 operations. Each figure is the one PERF.md's Bound column
    reads, to the digit."""
    kb = kernel_bounds
    got, want = {
        "lookup": (kb.lookup_cost(1, 8192, 512, 3, 3, 32).bytes / 1e6,
                   "bytes: 75.1 MB"),
        "voxel": (kb.voxel_cost(1, 8192, 512, 3, 3).bytes / 1e6,
                  "bytes: 69.8 MB"),
        "gru_general": (kb.gru_cost(1, 8192, 32, 96, 64).bytes / 1e6,
                        "bytes: 7.69 MB"),
        "gru_bf16": (kb.gru_cost(1, 8192, 64, 64, 64, "bf16").bytes / 1e6,
                     "bytes: 7.81 MB"),
        "gru_ops": (kb.gru_cost(1, 8192, 64, 64, 64).ops / 1e9,
                    "3xTF32 operations: 2.52 GFLOP"),
    }[case]
    figure = re.search(r"([\d.]+) (MB|GFLOP)$", want).group(1)
    digits = len(figure.split(".")[1])
    assert f"{got:.{digits}f}" == figure
    assert want in _perf_bound_column()


def test_kernel_bounds_units_and_rates():
    kb = kernel_bounds
    tf32 = kb.gru_cost(2, 64, 64, 64, 64)
    fma = kb.gru_cost(2, 64, 64, 64, 64, "fma")
    assert tf32.ops == 3 * tf32.flops and tf32.rate == kb.TF32_FLOPS_PER_S
    assert (fma.ops, fma.rate) == (fma.flops, kb.FP32_FLOPS_PER_S)
    assert kb.gru_weight_elems(64, 64, 64) == 52736
    out = kb.bound(3.35e9, 1.0)
    assert out == {"bound_ms": pytest.approx(1.0), "bound_by": "bytes"}
    with pytest.raises(ValueError):
        kb.gru_cost(1, 1, 8, 8, 8, "fp64")


def test_kernel_scope_is_free_without_a_counter():
    calls = []
    scope = kernel_bounds.kernel_scope(lambda *d: calls.append(d))
    with scope as s:
        s.done(None)
    assert calls == [] and kernel_bounds.active_counter() is None


# --- the op counter ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_dense_counts_2mkn_flops(dtype):
    m, k, n = 48, 24, 40
    layer = Dense(k, n, compute_dtype=dtype)

    def fn(x):
        return layer(x)

    fn.state = tuple(layer.parameters())
    got = costs.count_program(fn, (torch.randn(m, k),))
    assert got["flops"] == 2 * m * k * n
    assert got["argument_size_in_bytes"] == 4 * (m * k + k * n + n)


def test_views_in_place_and_out_bytes():
    a, b = torch.randn(8, 16), torch.randn(8, 16)
    out = torch.empty(8, 16)
    unit = 8 * 16 * 4
    rows = {
        "view": lambda: a.view(16, 8).t(),
        "add": lambda: a + b,
        "add_": lambda: a.clone().add_(b),
        "add_out": lambda: torch.add(a, b, out=out),
        "empty": lambda: torch.empty(8, 16),
    }
    got = {k: costs.count_program(fn, ())["bytes_accessed"]
           for k, fn in rows.items()}
    # clone: read + write; add_: read both, write one.
    assert got == {"view": 0, "add": 3 * unit, "add_": 5 * unit,
                   "add_out": 3 * unit, "empty": 0}


def test_live_bytes_follow_storages():
    def fn(x):
        y = x * 2          # 4 KB, freed below
        z = y + 1          # 4 KB
        del y
        return z.sum()

    x = torch.randn(1024)
    got = costs.count_program(fn, (x,))
    assert got["live_bytes_estimate"] == 3 * 4096
    assert got["output_size_in_bytes"] == 4


@pytest.mark.parametrize("name", [
    "cuda_corr_lookup_fwd", "cuda_corr_lookup_general_fwd",
    "cuda_voxel_corr_fwd", "cuda_voxel_corr_general_fwd",
    "cuda_gru_iter_fwd", "cuda_gru_iter_bf16_fwd",
    "cuda_gru_iter_general_fwd"])
def test_kernel_spec_counts_its_analytic_numbers(name):
    """A kernel spec counts its kernel's analytic bytes and operations,
    none of the plain version's ops (on the CPU it runs the plain
    version)."""
    from pvraft_tpu_torch.ops.cuda.gru_iter import gru_cost

    load_catalog()
    spec = get(name)
    fn, inputs = spec.build("cpu", "tiny")
    got = costs.count_program(fn, inputs)
    kind, geo = next(iter(spec.geometry.items()))
    n = 64
    if kind == "lookup":
        want = kernel_bounds.lookup_cost(1, n, geo["k"], geo["levels"],
                                         geo["resolution"], geo["knn"])
    elif kind == "voxel":
        want = kernel_bounds.voxel_cost(1, n, geo["k"], geo["levels"],
                                        geo["resolution"])
    else:
        want = gru_cost(1, n, geo["hidden"], geo["context"], geo["corr"],
                        getattr(torch, geo["dtype"]))
    assert (got["bytes_accessed"], got["flops"]) == (want.bytes, want.flops)
    assert got["kernel_launches"] == 1
    assert set(got["by_op"]) == {"kernel"}


# --- the inventory and its validators ---------------------------------------


def test_inventory_passes_both_validators(inventory):
    doc, path = inventory
    assert doc["ok"] and doc["topology"] == "host"
    assert costs.validate_costs(doc) == []
    assert jcosts.validate_costs(doc) == []
    assert costs.check_coverage(doc, list(specs().values())) == []
    assert costs.validate_costs_file(path, coverage=True) == []
    for rec in doc["programs"]:
        mem = rec["memory"]
        assert mem["fits_hbm"] and mem["fits_16GiB_hbm"]
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0


def _record(**over):
    rec = {"name": "flagship_fwd_fp32", "target": "host", "tags": ["fwd"],
           "ok": True, "count_s": 0.1, "flops": 64500.0,
           "bytes_accessed": 38400.0,
           "memory": {"argument_size_in_bytes": 1024,
                      "output_size_in_bytes": 512,
                      "live_bytes_estimate": 1792, "fits_hbm": True,
                      "fits_16GiB_hbm": True}}
    rec.update(over)
    return rec


def _doc(**over):
    doc = {"schema": costs.COSTS_SCHEMA, "topology": "host",
           "hbm_limit_bytes": 80 * 10**9, "programs": [_record()]}
    doc.update(over)
    return doc


@pytest.mark.parametrize("mutate, fragment", [
    (lambda d: d.update(schema="pvraft_costs/v0"), "schema"),
    (lambda d: d.pop("topology"), "missing field 'topology'"),
    (lambda d: d.update(programs="lots"), "must be a list"),
    (lambda d: d["programs"][0].pop("flops"), "flops"),
    (lambda d: d["programs"][0].update(flops=-1.0), "flops"),
    (lambda d: d["programs"][0].update(bytes_accessed="many"),
     "bytes_accessed"),
    (lambda d: d["programs"][0].update(ok=False, error="boom"), "not ok"),
    (lambda d: d["programs"][0].update(target=""), "target"),
    (lambda d: d["programs"][0].pop("memory"), "missing memory"),
    (lambda d: d["programs"][0]["memory"].update(
        output_size_in_bytes=-5), "output_size_in_bytes"),
    (lambda d: d["programs"][0]["memory"].pop("live_bytes_estimate"),
     "live_bytes_estimate"),
    (lambda d: d["programs"][0]["memory"].update(fits_16GiB_hbm="yes"),
     "fits_16GiB_hbm"),
    (lambda d: d["programs"].append(copy.deepcopy(d["programs"][0])),
     "duplicate"),
])
def test_validate_red(mutate, fragment):
    """The JAX package's red cases: both validators flag each."""
    assert costs.validate_costs(_doc()) == jcosts.validate_costs(_doc()) == []
    doc = _doc()
    mutate(doc)
    for validate in (costs.validate_costs, jcosts.validate_costs):
        problems = validate(doc)
        assert problems and any(fragment in p for p in problems), problems


def test_validate_red_fits_hbm():
    doc = _doc()
    doc["programs"][0]["memory"].pop("fits_hbm")
    assert any("fits_hbm" in p for p in costs.validate_costs(doc))


def test_check_coverage_both_directions(inventory):
    doc, _ = inventory
    catalog = list(specs().values())
    missing = dict(doc, programs=doc["programs"][1:])
    assert any(doc["programs"][0]["name"] in p
               for p in costs.check_coverage(missing, catalog))
    stale = dict(doc, programs=doc["programs"] + [_record(name="ghost")])
    assert any("ghost" in p for p in costs.check_coverage(stale, catalog))


def test_costs_check_cli(inventory, tmp_path, capsys):
    _, path = inventory
    assert programs_main(["costs", "--check", path]) == 0
    assert "OK" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(_doc(programs=[_record(flops=-1)])))
    assert programs_main(["costs", "--check", str(bad)]) == 1


def test_costs_cli_writes_a_selection(tmp_path, capsys):
    out = tmp_path / "sel.json"
    assert programs_main(["costs", "--device", "cpu", "--size", "tiny",
                          "--only", "cuda_voxel_corr_fwd",
                          "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert [r["name"] for r in doc["programs"]] == ["cuda_voxel_corr_fwd"]
    assert jcosts.validate_costs(doc) == []


# --- CostSurface: the port's and the JAX package's on one document ----------


def test_surfaces_agree_but_for_their_peaks(inventory):
    doc, path = inventory
    j, t = jcosts.CostSurface(doc, path), costs.CostSurface.load(path)
    assert len(j) == len(t) == len(doc["programs"])
    for dtype in ("float32", "bfloat16", "bf16", "f32"):
        assert j.serve_coverage(dtype) == t.serve_coverage(dtype)
    fields = ("name", "target", "flops", "bytes_accessed", "basis",
              "comparable", "extrapolated", "scale", "reference")
    cases = [(b, bs, dt) for b in (2048, 4096, 8192, 32, 100000)
             for bs in (1, 2, 4) for dt in ("float32", "bfloat16")]
    for bucket, bs, dtype in cases:
        je, te = (s.estimate_serve(bucket, bs, dtype) for s in (j, t))
        assert [getattr(je, f) for f in fields] == \
            [getattr(te, f) for f in fields]
        peak = costs.peak_flops_for(dtype)
        assert te.device_seconds == pytest.approx(max(
            te.flops / peak, te.bytes_accessed / kernel_bounds.HBM_BYTES_PER_S))
        assert (je.basis, te.basis) == ("roofline", "roofline")
    for dtype in ("float32", "bfloat16"):
        assert j.lookup_train_step(dtype).name == \
            t.lookup_train_step(dtype).name == \
            f"flagship_train_step_{'fp32' if dtype == 'float32' else 'bf16'}"
        assert j.serve_seconds_per_request(2048, dtype) is not None
        assert t.serve_seconds_per_request(2048, dtype) is not None
    assert t.lookup("nope") is None and t.lookup_serve(32, 1, "float32") is None


def test_surface_rejects_wrong_schema(tmp_path):
    with pytest.raises(ValueError):
        costs.CostSurface({"schema": "x"})
    with pytest.raises(OSError):
        costs.CostSurface.load(str(tmp_path / "missing.json"))
    assert costs.hardware_utilization(67e12, 1.0, "float32") == 1.0
    assert costs.hardware_utilization(1.0, 0.0, "float32") is None
    assert costs.default_costs_path().endswith(
        os.path.join("pvraft_tpu_torch", "_build", "programs_costs.json"))


# --- the serve cost plane ---------------------------------------------------


class _Replica:
    def __init__(self, i):
        self.index = i
        self.device_id = i

    def predict_batch(self, requests, bucket):
        return [np.zeros((p1.shape[0], 3), np.float32) for p1, _ in requests]


class _Engine:
    def __init__(self):
        self.cfg = SimpleNamespace(buckets=(32,), batch_sizes=(1, 2),
                                   min_points=4, coord_limit=100.0,
                                   dtype="float32")
        self.replicas = [_Replica(0)]

    def validate_request(self, pc1, pc2):
        return 32

    def batch_size_for(self, n):
        return 1 if n <= 1 else 2

    def compile_report(self):
        return []

    def weights_info(self):
        return {}


def test_surface_disabled_service_has_zero_residue():
    """Without a surface: no costing on the batcher, the store disarmed,
    no cost block, no cost family in the exposition."""
    from pvraft_tpu_torch.serve import build_service

    server = build_service(_Engine(), trace_sample_every=0,
                           devmem_interval_s=0)
    server.start()
    try:
        assert server.batcher.costing is None
        metrics = server.batcher.metrics
        assert metrics.cost_armed is False
        assert metrics.cost_snapshot() is None
        text = metrics.prometheus()
        assert not any(f in text for f in COST_FAMILIES)
    finally:
        server.shutdown(drain=True)


def test_replica_utilization_covers_full_window():
    from pvraft_tpu_torch.serve.metrics import UTILIZATION_WINDOW_S, ServeMetrics

    m = ServeMetrics(buckets=(32,))
    m.arm_cost()
    now, n = 1000.0, 400
    step = UTILIZATION_WINDOW_S / n
    for i in range(n):
        t0 = now - UTILIZATION_WINDOW_S + i * step
        m.record_cost(bucket=32, batch=1, dtype="float32", replica=0,
                      predicted_s=0.01, measured_s=step, t_start=t0,
                      t_end=t0 + step, comparable=False, extrapolated=False)
    snap = m.cost_snapshot(now=now)
    assert snap["utilization"]["0"] == pytest.approx(1.0, abs=0.02)
    assert snap["calibration"][0]["n"] == n
    assert m.cost_snapshot(
        now=now + 2 * UTILIZATION_WINDOW_S)["utilization"]["0"] == 0.0


def _post(port, pc1, pc2):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/predict", json.dumps(
            {"pc1": pc1.tolist(), "pc2": pc2.tolist()}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def test_armed_service_passes_the_jax_validators(inventory, tmp_path):
    """An armed tiny service: /healthz ``cost`` rows count its dispatches,
    ``cost_surface`` reports the (extrapolated) price table, the seven
    families render, and the stream's ``cost_calibration`` events (one a
    dispatch, comparable false, roofline) pass both validators."""
    from pvraft_tpu_torch.obs.events import read_events, validate_events_file
    from pvraft_tpu_torch.serve import (InferenceEngine, ServeConfig,
                                        ServeTelemetry, build_service)
    from pvraft_tpu_torch.weights import seeded_state_dict

    _, path = inventory
    cfg = ServeConfig(model=TConfig(**TINY), buckets=(32,),
                      batch_sizes=(1,), num_iters=2, dtype="float32",
                      replicas=1)
    events = str(tmp_path / "serve.events.jsonl")
    tel = ServeTelemetry(events, cfg=cfg)
    engine = InferenceEngine(seeded_state_dict(cfg.model, 0), cfg,
                             device="cpu", telemetry=tel)
    server = build_service(engine, telemetry=tel, cost_surface=path,
                           trace_sample_every=0, devmem_interval_s=0)
    server.start()
    rng = np.random.default_rng(3)
    try:
        for _ in range(3):
            status, _ = _post(server.port,
                              *(rng.uniform(-1, 1, (24, 3)) for _ in "ab"))
            assert status == 200
        health = json.loads(_get(server.port, "/healthz"))
        prom = _get(server.port, "/metrics?format=prometheus")
    finally:
        server.shutdown(drain=True)
        tel.close()
    rows = health["cost"]["calibration"]
    assert [(r["bucket"], r["batch"], r["dtype"], r["n"]) for r in rows] == \
        [(32, 1, "float32", 3)]
    assert rows[0]["comparable"] is False and rows[0]["extrapolated"] == 3
    assert health["cost_surface"]["extrapolated_geometries"] == ["b32_bs1"]
    assert health["cost_surface"]["platform"] == "cpu"
    assert COST_FAMILIES <= set(re.findall(r"^# TYPE (\S+) ", prom, re.M))
    assert validate_events_file(events) == jvalidate_file(events) == []
    calib = [r for r in read_events(events) if r["type"] == "cost_calibration"]
    assert len(calib) == 3
    assert all(r["comparable"] is False and r["basis"] == "roofline"
               and r["platform"] == "cpu" and r["extrapolated"] is True
               for r in calib)


def test_serve_cli_bad_surface_fails_before_capture(monkeypatch, tmp_path):
    from pvraft_tpu_torch.serve import __main__ as cli
    from pvraft_tpu_torch.serve import engine as tengine

    def boom(*a, **k):
        raise AssertionError("the engine was built before the surface")

    monkeypatch.setattr(tengine.InferenceEngine, "from_checkpoint", boom)
    with pytest.raises(OSError):
        cli.main(["serve", "--ckpt", "x", "--platform", "cpu",
                  "--cost_surface", str(tmp_path / "missing.json")])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "pvraft_costs/v0"}))
    with pytest.raises(ValueError):
        cli.main(["serve", "--ckpt", "x", "--platform", "cpu",
                  "--cost-surface", str(bad)])


# --- the Trainer's cost block -----------------------------------------------


def _trainer_config(tmp_path):
    from pvraft_tpu_torch.config import Config, DataConfig, TrainConfig

    return Config(model=TConfig(**TINY),
                  data=DataConfig(dataset="synthetic", synthetic_size=4,
                                  max_points=64, num_workers=0),
                  train=TrainConfig(num_epochs=1, iters=2, eval_iters=2),
                  exp_path=str(tmp_path / "exp"))


@pytest.mark.parametrize("surface", ["given", "missing"])
def test_trainer_cost_block_passes_the_jax_validator(inventory, tmp_path,
                                                     surface):
    """With a surface, the ``epoch_summary`` carries the cost block (the
    flagship fp32 train step's roofline, platform cpu, comparable false),
    which the JAX validator accepts; with an unreadable one, no block and
    training goes on."""
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.obs.events import read_events

    _, path = inventory
    given = path if surface == "given" else str(tmp_path / "none.json")
    trainer = Trainer(_trainer_config(tmp_path), device="cpu",
                      graphs=False, cost_surface=given)
    try:
        trainer.training(0)
    finally:
        trainer.close()
    summary, = [r for r in read_events(
        os.path.join(trainer.cfg.exp_path, "train.events.jsonl"))
        if r["type"] == "epoch_summary"]
    assert jvalidate_event(summary) == []
    if surface == "missing":
        assert "cost" not in summary
        return
    cost = summary["cost"]
    rec = costs.CostSurface.load(path).lookup_train_step("float32")
    assert cost["program"] == "flagship_train_step_fp32"
    assert (cost["basis"], cost["platform"], cost["comparable"]) == \
        ("roofline", "cpu", False)
    assert cost["predicted_step_ms"] == round(rec.device_seconds * 1e3, 3)
    assert cost["step_ratio"] > 0 and cost["hw_utilization"] > 0
    bad = dict(summary, cost=dict(cost, comparable=True))
    assert jvalidate_event(bad)


def test_trainer_cost_block_dtype_follows_the_model(inventory, tmp_path):
    from pvraft_tpu_torch.engine.trainer import Trainer

    _, path = inventory
    cfg = _trainer_config(tmp_path)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    trainer = Trainer(cfg, device="cpu", graphs=False, cost_surface=path)
    try:
        report = trainer._step_cost_report(0.5)
    finally:
        trainer.close()
    assert report["program"] == "flagship_train_step_bf16"
    assert trainer._step_cost_report(0.0) is None
