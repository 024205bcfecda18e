"""The port's profiling plane against the JAX package's, on the CPU.

``pvraft_tpu_torch/profiling``: ``derive_breakdown`` and
``validate_step_profile`` give the JAX package's results on the same
records (valid ones and each way a record can be wrong); a step profile
run here at a tiny size is complete, telescopes, and both validators
say the same of it; ``obs/trace.py::trace_from_step_profile`` lays a
record out as JAX's spans, and those spans written through
``RunTelemetry.emit_span`` pass both stream validators; the CLI's
``profile`` and ``validate``; ``StepTimer``, ``trace_context`` and the
Trainer's ``profile_dir`` window (``trace_window`` records, a Chrome
trace, and a refusal while another profiler session runs); where
``profiling/windows.py`` places the records a window lost, and
``ops/cuda.device_kernels`` counting only windows its markers show whole
(a stand-in profiler that drops a window's first records).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from pvraft_tpu.obs.events import validate_events_file as jvalidate
from pvraft_tpu.obs.trace import trace_from_step_profile as jtrace
from pvraft_tpu.profiling import step_profiler as jprof
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch.obs.events import RunTelemetry, read_events
from pvraft_tpu_torch.obs.events import validate_events_file as tvalidate
from pvraft_tpu_torch.obs.trace import trace_from_step_profile
from pvraft_tpu_torch.profiling import (
    BREAKDOWN_STAGES,
    MEASUREMENTS,
    StepTimer,
    derive_breakdown,
    profile_step,
    start_profiler,
    trace_context,
    validate_step_profile,
)
from pvraft_tpu_torch.profiling.__main__ import main as cli

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
SECONDS = {"encoder": 0.006961, "corr_cum": 0.017175, "fwd1": 0.023766,
           "fwdN": 0.044222, "gru_fused": 0.043243, "fwdbwd": 0.152497,
           "step": 0.15459}


def _record(seconds=SECONDS):
    meas = {k: {"sec": v} for k, v in seconds.items()}
    record = {"schema": "pvraft_step_profile/v1", "platform": "gpu",
              "variant": "fp32", "points": 8192, "batch": 2, "iters": 8,
              "truncate_k": 512, "host_synced": True, "measurements": meas}
    record["breakdown_s"] = derive_breakdown(meas)
    record["total_step_s"] = meas["step"]["sec"]
    return record


def test_ladder_and_breakdown_match_jax():
    assert MEASUREMENTS == jprof.MEASUREMENTS
    assert BREAKDOWN_STAGES == jprof.BREAKDOWN_STAGES
    meas = _record()["measurements"]
    assert derive_breakdown(meas) == jprof.derive_breakdown(meas)


def _broken(kind):
    record = _record()
    if kind == "missing_key":
        del record["breakdown_s"]
    elif kind == "schema":
        record["schema"] = "pvraft_step_profile/v0"
    elif kind == "not_synced":
        record["host_synced"] = False
    elif kind == "no_sec":
        record["measurements"]["fwd1"] = {"error": "RuntimeError('oom')"}
    elif kind == "negative":
        record["measurements"]["corr_cum"]["sec"] = 0.001
        record["breakdown_s"] = derive_breakdown(record["measurements"])
    elif kind == "sum":
        record["total_step_s"] = 0.3
    elif kind == "stages":
        record["breakdown_s"].pop("optimizer")
    return record


@pytest.mark.parametrize("kind", ["valid", "missing_key", "schema",
                                  "not_synced", "no_sec", "negative", "sum",
                                  "stages"])
def test_validator_matches_jax(kind):
    record = _broken(kind)
    got = validate_step_profile(copy.deepcopy(record))
    assert got == jprof.validate_step_profile(copy.deepcopy(record))
    assert (got == []) == (kind == "valid")


@pytest.fixture(scope="module")
def profiled():
    torch.set_num_threads(1)
    return profile_step(tconfig.ModelConfig(**TINY), points=48, batch=2,
                        iters=2, reps=2, device="cpu", variant="tiny")


def test_profile_step_runs_the_ladder_on_the_cpu(profiled):
    record = profiled
    assert record["platform"] == "cpu" and record["graphed"] is False
    assert list(record["measurements"]) == list(MEASUREMENTS)
    for entry in record["measurements"].values():
        assert entry["sec"] > 0 and len(entry["sec_reps"]) == 2
        assert entry["sec"] == min(entry["sec_reps"])
    assert record["breakdown_s"] == derive_breakdown(record["measurements"])
    assert record["total_step_s"] == record["measurements"]["step"]["sec"]
    assert abs(sum(record["breakdown_s"].values())
               - record["total_step_s"]) < 1e-5
    # CPU timing noise may make a sub-millisecond stage negative: the two
    # validators must say the same whatever it says.
    assert validate_step_profile(record) == jprof.validate_step_profile(
        record)


def _shape(spans):
    """Spans with their random ids replaced by their positions."""
    ids = {s["span_id"]: i for i, s in enumerate(spans)}
    return [{**{k: v for k, v in s.items() if k not in ("span_id",
                                                        "parent_id")},
             "id": ids[s["span_id"]],
             "parent": ids.get(s.get("parent_id"))} for s in spans]


def test_trace_from_step_profile_matches_jax(tmp_path):
    record = _record()
    spans = trace_from_step_profile(record, trace_id="abc")
    assert _shape(spans) == _shape(jtrace(record, trace_id="abc"))
    assert [s["name"] for s in spans] == ["train_step", *BREAKDOWN_STAGES]
    negative = _broken("negative")
    assert (_shape(trace_from_step_profile(negative, "t"))
            == _shape(jtrace(negative, "t")))
    with pytest.raises(ValueError, match="no breakdown"):
        trace_from_step_profile(_broken("missing_key"))
    sink = RunTelemetry(str(tmp_path), "Profile")
    sink.emit_header(mode="profile")
    for span in spans:
        sink.emit_span(**span)
    sink.close()
    path = str(tmp_path / "profile.events.jsonl")
    assert tvalidate(path) == [] and jvalidate(path) == []


def test_cli_profile_and_validate(tmp_path, capsys):
    out = tmp_path / "profile.json"
    events = tmp_path / "profile.events.jsonl"
    rc = cli(["profile", "--device", "cpu", "--points", "48", "--k", "16",
              "--corr_knn", "8", "--graph_k", "8", "--iters", "2", "--reps",
              "1", "--out", str(out), "--events", str(events)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["schema"] == "pvraft_step_profile/v1"
    assert line["variant"] == "fp32" and rc == (0 if line["valid"] else 1)
    assert json.load(open(out)) == line
    if line["valid"]:
        assert [r["type"] for r in read_events(str(events))] == [
            "run_header"] + ["span"] * (1 + len(BREAKDOWN_STAGES))
    good = tmp_path / "good.json"
    json.dump(_record(), open(good, "w"))
    assert cli(["validate", str(good)]) == 0
    assert "OK (gpu" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    json.dump(_broken("sum"), open(bad, "w"))
    assert cli(["validate", str(bad), str(tmp_path / "missing.json")]) == 1
    text = capsys.readouterr().out
    assert "breakdown sums to" in text and "unreadable" in text


def test_step_timer_and_trace_context(tmp_path):
    timer = StepTimer()
    for _ in range(2):
        timer.start()
        timer.stop(torch.ones(3))
    assert len(timer.times) == 2 and timer.mean > 0
    with trace_context("") as window:
        assert window is None
    with trace_context(str(tmp_path / "t")) as window:
        assert window is not None
        torch.ones(8).sum()
        with pytest.raises(RuntimeError, match="one profiler at a time"):
            start_profiler()
    assert json.load(open(tmp_path / "t" / "trace.json"))["traceEvents"]


@pytest.mark.parametrize("seen,where", [
    ("abcdef", "whole"), ("cdef", "head"), ("abcd", "tail"),
    ("abef", "middle")])
def test_window_loss_is_located(seen, where):
    from pvraft_tpu_torch.profiling.windows import lost_at, summary

    full = list("abcdef")
    assert lost_at(full, list(seen)) == where
    row = summary({"r": [full, list(seen), full]})["r"]
    assert row["short"] == int(len(seen) < len(full))
    assert row["lost_at"][where] == 1 + 2 * (where == "whole")
    assert sum(row["lengths"].values()) == 3


class _Window:
    """A stand-in ``torch.profiler.profile`` whose events lose their
    first ``drop`` records, as the card's profiler can."""

    def __init__(self, log, drop):
        self.log, self.drop = log, drop

    def __enter__(self):
        self.log.clear()
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        cuda = torch.autograd.DeviceType.CUDA
        return [type("E", (), {"name": n, "device_type": cuda,
                               "time_range": type("R", (), {"start": t})})
                for t, n in enumerate(self.log)][self.drop:]


@pytest.mark.parametrize("drop,windows", [(0, 1), (17, 1), (300, 2),
                                          (5000, 3), (40000, None)])
def test_device_kernels_counts_only_whole_windows(monkeypatch, drop,
                                                  windows):
    from pvraft_tpu_torch.ops import cuda as kernels

    log = []
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: _Window(log, drop))
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: log.append("at::cuda::spin_kernel"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(kernels.time, "sleep", lambda s: None)
    kernels.window_counts.clear()

    def fn():
        log.extend(["Memcpy HtoD", "corr_lookup_kernel(float*)"])
        return 7

    if windows is None:
        with pytest.raises(RuntimeError, match="no count is whole"):
            kernels.device_kernels(fn)
        return
    assert kernels.device_kernels(fn) == (
        7, ["Memcpy HtoD", "corr_lookup_kernel(float*)"])
    assert kernels.window_counts["windows"] == windows
    assert kernels.window_counts["run_again"] == windows - 1


def _trainer_cfg(exp, profile_dir):
    return tconfig.Config(
        model=tconfig.ModelConfig(**TINY),
        data=tconfig.DataConfig(dataset="synthetic", max_points=48,
                                synthetic_size=4, num_workers=0),
        train=tconfig.TrainConfig(batch_size=2, num_epochs=2, iters=1,
                                  eval_iters=1, profile_dir=profile_dir),
        exp_path=str(exp))


def test_trainer_profiles_its_first_epoch(tmp_path):
    from pvraft_tpu_torch.engine.trainer import Trainer

    profile = str(tmp_path / "profile")
    trainer = Trainer(_trainer_cfg(tmp_path, profile), device="cpu")
    trainer.training(0)
    trainer.training(1)          # only the first epoch is profiled
    with trace_context(str(tmp_path / "other")):
        refused = Trainer(_trainer_cfg(tmp_path / "second", profile),
                          device="cpu")
        with pytest.raises(RuntimeError, match="one profiler at a time"):
            refused.training(0)
    refused.close()
    trainer.close()
    records = read_events(str(tmp_path / "train.events.jsonl"))
    windows = [(r["action"], r["epoch"], r["trace_dir"]) for r in records
               if r["type"] == "trace_window"]
    assert windows == [("start", 0, profile), ("stop", 0, profile)]
    kinds = [r["type"] for r in records]
    assert kinds.index("trace_window") < kinds.index("step")
    trace = json.load(open(os.path.join(profile, "trace.json")))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("pvraft.") for n in names)
    assert np.isfinite([r["loss"] for r in records
                        if r["type"] == "step"]).all()
