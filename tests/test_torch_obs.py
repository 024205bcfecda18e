"""The port's observability modules against the JAX package's, on the CPU.

``pvraft_tpu_torch/obs/events.py`` (its streams pass JAX's
``validate_events_file``, and its validator agrees with JAX's on the
green and red cases of ``tests/test_events.py``), ``obs/trace.py`` (the
cases of ``tests/test_trace.py`` for the serve tree; ``collect_traces``
equal to JAX's), ``obs/device_memory.py`` (the cases of
``tests/test_device_memory.py`` with ``torch.cuda.memory_stats`` and
``mem_get_info`` faked) and ``obs/retrace.py::RetraceWatchdog`` (the cases
of ``tests/test_retrace.py``: a growing ``GraphCache`` for JAX's growing
jit cache, a capture for JAX's backend compile). Pure host code: seconds.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from pvraft_tpu.obs import events as jevents
from pvraft_tpu.obs.trace import collect_traces as jcollect_traces
from pvraft_tpu_torch.obs import device_memory as tdm
from pvraft_tpu_torch.obs import events as tevents
from pvraft_tpu_torch.obs.retrace import (
    GraphCache,
    RetraceError,
    RetraceWatchdog,
    compile_count,
    note_compile,
)
from pvraft_tpu_torch.obs.trace import (
    SERVE_STAGES,
    RequestTrace,
    Tracer,
    collect_traces,
    trace_shape,
)
from pvraft_tpu_torch.serve.aot import capture
from pvraft_tpu_torch.serve.batcher import BatcherConfig, MicroBatcher
from pvraft_tpu_torch.serve.events import ServeTelemetry
from pvraft_tpu_torch.serve.metrics import ServeMetrics

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_run.events.jsonl")


def _record(etype, seq=0, **fields):
    base = {"schema": "pvraft_events/v1", "type": etype, "time": 1.0,
            "seq": seq}
    base.update(fields)
    return base


# ------------------------------------------------------------- events --

_ROW = {"device_id": 0, "bytes_in_use": 1024, "peak_bytes_in_use": 2048,
        "bytes_limit": 4096, "platform": "gpu"}
_STEP = {"epoch": 0, "step": 1, "loss": 0.5, "epe": 1.0}

# tests/test_events.py's green and red records, and the serve types.
EVENT_CASES = {
    "step": _record("step", **_STEP),
    "step_nonfinite": _record("step", epoch=0, step=1, loss="NaN",
                              epe="Infinity"),
    "epoch_summary": _record("epoch_summary", epoch=0, steps=0),
    "no_schema": {k: v for k, v in _record("step", **_STEP).items()
                  if k != "schema"},
    "old_schema": _record("step", **_STEP) | {"schema": "pvraft_events/v0"},
    "unknown_type": _record("nope"),
    "missing_loss": _record("step", epoch=0, step=1, epe=1.0),
    "loss_not_number": _record("step", **(_STEP | {"loss": "oops"})),
    "extra_field": _record("step", **_STEP, extra_field=1),
    "wrong_seq": _record("step", seq=7, **_STEP),
    "bad_divergence": _record("divergence", epoch=0, step=1,
                              reason="bored", loss=1.0),
    "bad_trace_window": _record("trace_window", action="pause",
                                trace_dir="/x", epoch=0),
    "trace_window": _record("trace_window", action="start",
                            trace_dir="/x", epoch=-1),
    "recompile": _record("recompile", program="train_step", count=2,
                         baseline=1, signature="f32[2,8,3]",
                         context="train"),
    "recompile_no_program": _record("recompile", program="", count=2),
    "recompile_negative": _record("recompile", program="p", count=-1),
    "recompile_no_count": _record("recompile", program="p"),
    "device_memory": _record("device_memory", devices=[_ROW],
                             context="serve"),
    "devmem_negative": _record("device_memory",
                               devices=[_ROW | {"bytes_in_use": -1}]),
    **{f"devmem_device_{i}": _record(
        "device_memory", devices=[_ROW | {"device_id": dev}])
       for i, dev in enumerate((-1, "gpu:0", None, 1.5, True))},
    "devmem_empty": _record("device_memory", devices=[]),
    "devmem_mapping": _record("device_memory", devices={"0": _ROW}),
    "devmem_stray": _record("device_memory", devices=[_ROW | {"hbm": 1}]),
    "devmem_no_bytes": _record("device_memory",
                               devices=[{"device_id": 0}]),
    "span": _record("span", trace_id="t", span_id="s", name="ingress",
                    start_ms=1.0, end_ms=2.0, parent_id="r"),
    "span_reversed": _record("span", trace_id="t", span_id="s", name="x",
                             start_ms=2.0, end_ms=1.0),
    "serve_batch": _record("serve_batch", bucket=32, batch=2, n=1,
                           fill=0.5, latency_ms=3.0, replica=0,
                           device_id=0),
    "serve_reject_bad": _record("serve_reject", reason="bored"),
    "replica_state": _record("replica_state", replica=0, state="healthy",
                             from_state="probing", reason="probe_ok"),
    "replica_state_bad": _record("replica_state", replica=-1,
                                 state="asleep"),
    "fault_bad_point": _record("fault_injected", point="meteor"),
    "weight_swap_no_digest": _record("weight_swap", digest="", epoch=-1),
    "cost_comparable_off_tpu": _record(
        "cost_calibration", bucket=32, batch=1, dtype="float32",
        predicted_s=1.0, measured_s=1.0, platform="gpu", comparable=True),
}


GREEN = {"step", "step_nonfinite", "epoch_summary", "trace_window",
         "recompile", "device_memory", "span", "serve_batch",
         "replica_state"}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_validators_agree_on_each_record(case):
    """The port's validator and JAX's: the same verdict on every green
    and red record of ``tests/test_events.py`` (and the serve types)."""
    record = EVENT_CASES[case]
    port = tevents.validate_event(record, seq=0)
    jax_ = jevents.validate_event(record, seq=0)
    assert (port == []) == (jax_ == []) == (case in GREEN), (port, jax_)


STREAM_CASES = {
    "header_not_first": [json.dumps(_record("step", **_STEP))],
    "bare_nan": [json.dumps(_record("step", epoch=0, step=1,
                                    loss=float("nan"), epe=1.0))],
    "blank_lines": ["", ""],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_validators_agree_on_red_streams(case):
    lines = STREAM_CASES[case]
    assert tevents.validate_events(lines)
    assert jevents.validate_events(lines)


def test_golden_fixture_validates_under_the_port():
    assert tevents.validate_events_file(FIXTURE) == []
    assert set(tevents.EVENT_TYPES) == set(jevents.EVENT_TYPES)


def test_sanitize_nonfinite_numpy_and_torch():
    out = tevents.sanitize({
        "a": float("nan"), "b": float("inf"), "c": float("-inf"),
        "d": np.float32(1.5), "e": np.arange(3), "f": [float("nan")],
        "g": torch.tensor([1.0, float("inf")])})
    assert out == {"a": "NaN", "b": "Infinity", "c": "-Infinity",
                   "d": 1.5, "e": [0, 1, 2], "f": ["NaN"],
                   "g": [1.0, "Infinity"]}


def test_eventlog_writes_a_stream_jax_validates(tmp_path):
    path = str(tmp_path / "run.events.jsonl")
    log = tevents.EventLog(path, enabled=True)
    meta = tevents.run_metadata({}, mode="serve")
    assert meta["devices"] == {"platform": "cpu", "device_count": 1,
                               "process_index": 0, "process_count": 1}
    assert meta["versions"] == {"torch": torch.__version__,
                                "cuda": torch.version.cuda}
    log.emit("run_header", **meta)
    log.emit("step", epoch=0, step=1, loss=float("nan"), epe=0.5)
    log.close()
    assert jevents.validate_events_file(path) == []
    assert tevents.validate_events_file(path) == []
    # Appending continues the seq chain.
    again = tevents.EventLog(path, enabled=True)
    assert again.seq == 2
    again.emit("epoch_summary", epoch=0, steps=1)
    again.close()
    assert jevents.validate_events_file(path) == []
    assert [r["seq"] for r in tevents.read_events(path)] == [0, 1, 2]


def test_eventlog_rejects_invalid_and_disabled_is_noop(tmp_path):
    log = tevents.EventLog(str(tmp_path / "x.jsonl"), enabled=True)
    with pytest.raises(ValueError, match="invalid"):
        log.emit("step", epoch=0)
    with pytest.raises(ValueError, match="unknown event type"):
        log.emit("definitely_not_a_type", foo=1)
    log.close()
    path = str(tmp_path / "off.jsonl")
    off = tevents.EventLog(path, enabled=False)
    assert off.emit("step", **_STEP) is None
    assert not os.path.exists(path)


def test_serve_telemetry_emits_what_jax_validates(tmp_path):
    """Every emit method of ``ServeTelemetry`` writes a record JAX's
    validator takes, in one sequential stream."""
    path = str(tmp_path / "serve.events.jsonl")
    tel = ServeTelemetry(path, cfg={"buckets": [32]}, enabled=True)
    tel.emit_compile(32, 1, 0.5, 0.25, memory={"pool_bytes": 1 << 20},
                     dtype="bfloat16", replica=0, device_id=0)
    tel.emit_batch(32, 2, 1, 0.5, 3.25, queue_depth=0, replica=0,
                   device_id=0)
    tel.emit_reject("queue_full", bucket=32, queue_depth=4)
    tel.emit_trace_window("start", "/tmp/x")
    tel.emit_span(trace_id="t", span_id="r", name="request",
                  start_ms=1.0, end_ms=2.0, attrs={"status": 200})
    tel.emit_recompile("serve_dispatch_b32", 3, baseline=2,
                       signature="bucket=32 n=1", context="serve")
    tel.emit_device_memory([_ROW], context="serve")
    tel.emit_replica_state(0, "degraded", from_state="healthy",
                           reason="dispatch_error", device_id=0)
    tel.emit_fault("compile_trip", replica=0, bucket=32, traversal=1,
                   fires=1)
    tel.emit_weight_swap("abc", -1, path="x", previous_digest="def",
                         replicas=1, swap_ms=1.5, drained=0)
    tel.emit_shutdown(served=1, rejected=1, drained=0)
    tel.close()
    tel.emit_shutdown(served=1, rejected=1, drained=0)  # closed: a no-op
    assert jevents.validate_events_file(path) == []
    types = [r["type"] for r in tevents.read_events(path)]
    assert types[0] == "run_header" and len(types) == 12


# -------------------------------------------------------------- trace --


def test_tracer_sampling():
    assert Tracer(sample_every=0).begin() is None
    assert Tracer(sample_every=1).begin() is not None
    t = Tracer(sample_every=3)
    assert sum(t.begin() is not None for _ in range(30)) == 10
    with pytest.raises(ValueError):
        Tracer(sample_every=-1)


def test_request_trace_span_tree():
    trace = RequestTrace(t0=100.0)
    trace.mark("ingress", 100.0, 100.01)
    trace.mark("device_execute", 100.02, 100.5,
               attrs={"bucket": 32, "batch": 2, "n": 1})
    spans = trace.spans(t_end=100.6, root_attrs={"status": 200})
    assert [s["name"] for s in spans] == ["request", "ingress",
                                          "device_execute"]
    root = spans[0]
    assert "parent_id" not in root and root["attrs"] == {"status": 200}
    assert all(s["parent_id"] == root["span_id"] for s in spans[1:])
    assert root["end_ms"] - root["start_ms"] == pytest.approx(600.0)
    assert trace.stage_durations_ms()["device_execute"] == \
        pytest.approx(480.0)
    for i, s in enumerate(spans):
        rec = _record("span", seq=i, **s)
        assert jevents.validate_event(rec, seq=i) == []
        assert tevents.validate_event(rec, seq=i) == []


def _spans(trace_id="t1", stages=SERVE_STAGES):
    spans = [{"trace_id": trace_id, "span_id": "r", "name": "request",
              "start_ms": 0.0, "end_ms": 100.0}]
    for i, stage in enumerate(stages):
        spans.append({"trace_id": trace_id, "span_id": f"r.{i}",
                      "parent_id": "r", "name": stage,
                      "start_ms": float(i), "end_ms": float(i) + 1.0})
    return spans


@pytest.mark.parametrize("case", ["complete_and_partial", "orphan"])
def test_collect_traces_equals_jax(case):
    if case == "orphan":
        spans = _spans()
        spans[3]["parent_id"] = "nonexistent"
    else:
        spans = _spans() + _spans("t2", stages=("ingress",))
    records = [_record("span", seq=i, **s) for i, s in enumerate(spans)]
    doc = collect_traces(records, source="x.events.jsonl")
    assert doc == jcollect_traces(records, source="x.events.jsonl")
    if case == "orphan":
        assert doc["counts"]["orphan_spans"] == 1
        assert doc["counts"]["complete"] == 0
    else:
        assert doc["counts"]["complete"] == 1
        roots, orphans, stages, complete = trace_shape(_spans(),
                                                       SERVE_STAGES)
        assert complete and len(roots) == 1 and not orphans
        assert set(stages) == set(SERVE_STAGES)


# ------------------------------------------------------ device memory --

_STATS = {"allocated_bytes.all.current": 1 << 30,
          "allocated_bytes.all.peak": 2 << 30,
          "reserved_bytes.all.current": 3 << 30}


@pytest.fixture
def fake_cuda(monkeypatch):
    """Two CUDA devices whose allocators report ``_STATS``."""
    stats = {0: dict(_STATS), 1: dict(_STATS)}
    monkeypatch.setattr(tdm.torch.cuda, "memory_stats",
                        lambda d: stats[int(getattr(d, "index", d) or 0)])
    monkeypatch.setattr(tdm.torch.cuda, "mem_get_info",
                        lambda d: (1 << 33, 80 << 30))
    monkeypatch.setattr(tdm.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tdm.torch.cuda, "device_count", lambda: 2)
    return stats


def test_row_reads_allocated_bytes(fake_cuda):
    assert tdm.device_memory_row(1) == {
        "device_id": 1, "platform": "gpu", "bytes_in_use": 1 << 30,
        "peak_bytes_in_use": 2 << 30, "bytes_limit": 80 << 30}
    assert tdm.device_memory_row(torch.device("cuda", 0))["device_id"] == 0
    assert [r["device_id"] for r in tdm.sample_device_memory()] == [0, 1]


def test_row_without_stats_is_none(fake_cuda, monkeypatch):
    fake_cuda[0].clear()
    assert tdm.device_memory_row(0) is None

    def boom(d):
        raise RuntimeError("no allocator")

    monkeypatch.setattr(tdm.torch.cuda, "memory_stats", boom)
    assert tdm.device_memory_row(0) is None
    assert tdm.sample_device_memory() == []


def test_cpu_samples_to_nothing(monkeypatch):
    monkeypatch.setattr(tdm.torch.cuda, "is_available", lambda: False)
    assert tdm.sample_device_memory() == []


def test_monitor_feeds_metrics_and_events(fake_cuda, tmp_path):
    path = str(tmp_path / "serve.events.jsonl")
    tel = ServeTelemetry(path, enabled=True)
    metrics = ServeMetrics(buckets=(2048,))
    mon = tdm.DeviceMemoryMonitor(emit=tel.emit_device_memory,
                                  metrics=metrics, interval_s=0)
    rows = mon.sample_once()
    assert len(rows) == 2 and mon.samples == 1
    tel.close()
    assert jevents.validate_events_file(path) == []
    prom = metrics.prometheus()
    assert 'pvraft_device_hbm_bytes{device="0"} 1073741824' in prom
    assert 'pvraft_device_hbm_bytes{device="1"} 1073741824' in prom
    assert 'pvraft_device_hbm_peak_bytes{device="0"} 2147483648' in prom
    assert "device_memory" not in metrics.snapshot()


def test_monitor_interval_zero_and_cpu(tmp_path):
    mon = tdm.DeviceMemoryMonitor(interval_s=0)
    mon.start()
    assert mon._thread is None
    mon.stop()
    path = str(tmp_path / "serve.events.jsonl")
    tel = ServeTelemetry(path, enabled=True)
    cpu = tdm.DeviceMemoryMonitor(emit=tel.emit_device_memory,
                                  interval_s=0, devices=())
    assert cpu.sample_once() == [] and cpu.samples == 0
    tel.close()
    assert [r["type"] for r in tevents.read_events(path)] == ["run_header"]


def test_monitor_thread_lifecycle(fake_cuda):
    seen = []

    class _Sink:
        def record_device_memory(self, rows):
            seen.append(rows)

    mon = tdm.DeviceMemoryMonitor(metrics=_Sink(), interval_s=0.01,
                                  devices=[0])
    mon.start()
    deadline = time.monotonic() + 5.0
    while not seen and time.monotonic() < deadline:
        time.sleep(0.01)
    mon.stop()
    assert seen and mon._thread is None
    mon.start()  # restartable
    assert mon._thread is not None
    mon.stop()


# ------------------------------------------------------------ watchdog --


def _cache():
    """A GraphCache whose program count grows with each new signature
    (the counterpart of a jit cache)."""
    return GraphCache("prog", lambda name, inputs: capture(
        name, lambda x: (x * 2.0,), inputs, torch.device("cpu")))


def test_watchdog_learns_baseline_then_trips():
    events = []
    dog = RetraceWatchdog(emit=lambda **kw: events.append(kw))
    cache = _cache()
    dog.watch("prog", cache)
    dog.watch("nothing_to_count", object())
    assert dog.check() == []
    cache.program_for([torch.ones(4)])
    assert dog.check() == []                # warm-up
    cache.program_for([torch.ones(4)])
    assert dog.check() == []
    cache.program_for([torch.ones(5)])      # a new signature
    trips = dog.check(signature=lambda: "float32[5]")
    assert [t["program"] for t in trips] == ["prog"]
    assert trips[0]["count"] == trips[0]["baseline"] + 1
    assert events[0]["signature"] == "float32[5]"
    assert events[0]["context"] == "train"
    assert dog.check() == [] and dog.trips == 1


def test_watchdog_strict_raises():
    dog = RetraceWatchdog(strict=True)
    cache = _cache()
    dog.watch("prog", cache)
    cache.program_for([torch.ones(4)])
    dog.check()
    cache.program_for([torch.ones(2, 2)])
    with pytest.raises(RetraceError, match="prog.*recompiled after warmup"):
        dog.check(signature="float32[2,2]")


def test_watchdog_event_is_schema_valid(tmp_path):
    path = str(tmp_path / "serve.events.jsonl")
    tel = ServeTelemetry(path, enabled=True)
    dog = RetraceWatchdog(emit=tel.emit_recompile, context="serve")
    cache = _cache()
    dog.watch("predict_b2048_bs1", cache)
    cache.program_for([torch.ones(3)])
    dog.check()
    cache.program_for([torch.ones(6)])
    assert len(dog.check(signature="float32[6]")) == 1
    tel.close()
    assert jevents.validate_events_file(path) == []
    rec = [r for r in tevents.read_events(path) if r["type"] == "recompile"]
    assert rec[0]["program"] == "predict_b2048_bs1"
    assert rec[0]["signature"] == "float32[6]"


def test_captures_and_kernel_loads_count_as_compiles():
    before = compile_count()
    capture("p", lambda x: (x,), [torch.ones(2)], torch.device("cpu"))
    assert compile_count() == before + 1
    note_compile(3)                # what build_all does for 3 sources
    assert compile_count() == before + 4


def test_sealed_mode_counts_any_compile():
    dog = RetraceWatchdog(context="serve")
    assert dog.seal()
    try:
        assert dog.check() == []
        capture("x", lambda x: (x,), [torch.ones(7)], torch.device("cpu"))
        trips = dog.check(program="serve_dispatch_b2048")
        assert trips and trips[0]["program"] == "serve_dispatch_b2048"
        assert dog.check() == []
    finally:
        dog.close()
    note_compile()
    assert dog.check() == []


def test_sealed_window_one_compile_trips_once():
    dog = RetraceWatchdog(context="serve")
    dog.seal()
    dog.check()
    window_a = dog.global_compiles()
    window_b = dog.global_compiles()
    note_compile()
    assert len(dog.check(window_start=window_a)) == 1
    assert dog.check(window_start=window_b) == []
    assert dog.trips == 1
    dog.close()


def test_sealed_window_ignores_co_resident_compiles():
    dog = RetraceWatchdog(context="serve")
    dog.seal()
    note_compile()                          # another engine's capture
    window = dog.global_compiles()
    assert dog.check(window_start=window) == []
    assert dog.check() == []
    window = dog.global_compiles()
    dog.inject_compile()                    # compile_trip's effect
    trips = dog.check(program="serve_dispatch_b32", window_start=window)
    assert trips and trips[0]["baseline"] == window
    dog.close()


class _CompilingEngine:
    """Batcher double whose second dispatch captures a program (the
    fault the sealed watchdog exists to catch)."""

    def __init__(self):
        from types import SimpleNamespace

        self.cfg = SimpleNamespace(buckets=(32,), batch_sizes=(1,),
                                   min_points=4, coord_limit=100.0)
        self.calls = 0

    def validate_request(self, pc1, pc2):
        return 32

    def batch_size_for(self, n):
        return 1

    def predict_batch(self, requests, bucket):
        self.calls += 1
        if self.calls > 1:
            capture("late", lambda x: (x,), [torch.ones(self.calls)],
                    torch.device("cpu"))
        return [np.zeros((pc1.shape[0], 3), np.float32)
                for pc1, _ in requests]


def _submit_and_wait(batcher, seed):
    pc = np.random.default_rng(seed).uniform(-1, 1, (8, 3)).astype(
        np.float32)
    return batcher.submit(pc, pc + 0.1).wait(20.0)


@pytest.mark.parametrize("strict", [True, False])
def test_compile_in_a_dispatch_trips_the_sealed_watchdog(tmp_path, strict):
    """A capture inside the threaded dispatch: a ``recompile`` event and
    the Prometheus counter; strict fails the request, otherwise it is
    served."""
    path = str(tmp_path / "serve.events.jsonl")
    tel = ServeTelemetry(path, enabled=True)
    metrics = ServeMetrics(buckets=(32,))
    dog = RetraceWatchdog(emit=tel.emit_recompile, strict=strict,
                          context="serve")
    dog.seal()
    batcher = MicroBatcher(
        _CompilingEngine(),
        BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8),
        telemetry=tel, metrics=metrics, watchdog=dog)
    try:
        assert _submit_and_wait(batcher, 1).shape == (8, 3)
        if strict:
            with pytest.raises(RetraceError, match="recompiled"):
                _submit_and_wait(batcher, 2)
        else:
            assert _submit_and_wait(batcher, 2).shape == (8, 3)
    finally:
        batcher.shutdown(drain=True)
        dog.close()
        tel.close()
    assert metrics.recompiles_total == 1
    assert "pvraft_serve_recompiles_total 1" in metrics.prometheus()
    assert jevents.validate_events_file(path) == []
    records = tevents.read_events(path)
    rec = [r for r in records if r["type"] == "recompile"]
    assert len(rec) == 1 and rec[0]["signature"] == "bucket=32 n=1"
    assert rec[0]["program"] == "serve_dispatch_b32"
    assert records[-1]["type"] == "serve_shutdown"


def test_watchdog_threadsafe_check():
    dog = RetraceWatchdog()
    cache = _cache()
    dog.watch("prog", cache)
    cache.program_for([torch.ones(4)])
    dog.check()
    cache.program_for([torch.ones(3, 3)])
    trips, barrier = [], threading.Barrier(4)

    def worker():
        barrier.wait(5)
        trips.extend(dog.check())

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert len(trips) == 1 and dog.trips == 1
