"""The port's serving tier against the JAX package's, on the CPU.

The engine's replica pool (2-3 CPU replicas of the tiny serve model,
``tests/test_serve_pool.py``'s geometry), its hot-swap without recapture,
``params_digest`` and ``probe_request``; the micro-batcher under real
threads (buckets and exact flows, backpressure, drain and no-drain
shutdown, failure accounting, no head-of-line blocking, eager dispatch,
the in-flight reconciliation and the timeout race), on gated engine
doubles as in ``tests/test_serve.py`` and ``tests/test_serve_pool.py``;
the HTTP service and its CLI; and the JAX ``build_service`` and the
port's side by side on the same weights and the same HTTP requests:
status codes, ``/healthz`` and ``/metrics`` keys, Prometheus families
(both services armed with one port cost inventory), flows within 2e-4
(the JAX-vs-torch model bar) and the swap report. Waits are on events, joins and
conditions with timeouts; nothing is asserted on wall time.
"""

import http.client
import json
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.serve import InferenceEngine as JEngine
from pvraft_tpu.serve import ServeConfig as JServeConfig
from pvraft_tpu.serve import build_service as jbuild_service
from pvraft_tpu.serve.engine import params_digest as jparams_digest
from pvraft_tpu.serve.metrics import replica_utilization as jutilization
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.engine import msgpack
from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
from pvraft_tpu_torch.serve import (
    BatcherConfig,
    InferenceEngine,
    MicroBatcher,
    QueueFullError,
    RequestError,
    ServeConfig,
    ServeHTTPServer,
    ServeMetrics,
    ShutdownError,
    build_service,
    params_digest,
)
from pvraft_tpu_torch.serve import engine as tengine
from pvraft_tpu_torch.serve.metrics import replica_utilization
from pvraft_tpu_torch.weights import params_to_jax, seeded_state_dict

REPO = Path(__file__).resolve().parents[1]
TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 4}
POOL = {"buckets": (32,), "batch_sizes": (1, 2), "num_iters": 2,
        "dtype": "float32"}
FLOW_ATOL = 2e-4
# The cost plane's families (serve/costing.py): rendered by an armed
# service only.
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


def _pc(n, seed=0):
    return _cloud(np.random.default_rng(seed), n)


def _until(predicate, timeout=10.0):
    """Wait for ``predicate()`` (a state another thread reaches), up to
    ``timeout`` seconds."""
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        tick.wait(0.002)
    return True


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def state():
    return seeded_state_dict(TConfig(**TINY), 0)


@pytest.fixture(scope="module")
def pool(state):
    """A 2-replica fp32 CPU engine."""
    return InferenceEngine(state, ServeConfig(model=TConfig(**TINY),
                                              replicas=2, **POOL),
                           device="cpu")


@pytest.fixture(scope="module")
def jpool(state):
    """The JAX engine on the same weights, 2 replicas (virtual CPU
    devices)."""
    return JEngine(params_to_jax(state),
                   JServeConfig(model=JConfig(**TINY), replicas=2, **POOL))


# ------------------------------------------------------------- engine --


@pytest.mark.parametrize("n", [1, 2, 3])
def test_replicas_on_the_cpu(state, n):
    """``replicas=n`` on the CPU builds n replicas, each with its own
    model and programs, that answer bitwise alike."""
    eng = InferenceEngine(state, ServeConfig(model=TConfig(**TINY),
                                             replicas=n, **POOL),
                          device="cpu")
    assert [r.index for r in eng.replicas] == list(range(n))
    assert len({id(r.model) for r in eng.replicas}) == n
    assert len({id(r.programs[(32, 1)]) for r in eng.replicas}) == n
    req = (_pc(20, 1), _pc(24, 2))
    flows = [r.predict_batch([req], 32)[0] for r in eng.replicas]
    for f in flows[1:]:
        np.testing.assert_array_equal(f, flows[0])
    np.testing.assert_array_equal(eng.predict(*req), flows[0])


def test_zero_replicas_on_the_cpu_is_one(state):
    eng = InferenceEngine(state, ServeConfig(model=TConfig(**TINY), **POOL),
                          device="cpu")
    assert ServeConfig().replicas == JServeConfig().replicas == 0
    assert len(eng.replicas) == 1 and eng.platform == "cpu"


def test_cuda_replica_count_like_jax(monkeypatch):
    """On CUDA, 0 replicas means every device, replica i on cuda:i, and a
    count above the device count raises with the count."""
    monkeypatch.setattr(tengine.torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    assert tengine.replica_devices(cuda, 0) == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]
    assert tengine.replica_devices(cuda, 1) == [torch.device("cuda", 0)]
    assert tengine.replica_devices(torch.device("cuda", 1), 1) == \
        [torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="replicas=3 exceeds the 2"):
        tengine.replica_devices(cuda, 3)


def test_pool_flows_match_jax(pool, jpool):
    """Each replica of both pools on the same weights and requests:
    flows within 2e-4."""
    rng = np.random.default_rng(3)
    reqs = [(_cloud(rng, 20), _cloud(rng, 25)),
            (_cloud(rng, 32), _cloud(rng, 17))]
    for tr, jr in zip(pool.replicas, jpool.replicas):
        for got, want in zip(tr.predict_batch(reqs, 32),
                             jr.predict_batch(reqs, 32)):
            np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)


def test_params_digest_equals_jax(state):
    variables = params_to_jax(state)
    digest = params_digest(state)
    assert digest == jparams_digest(variables) == params_digest(variables)
    other = seeded_state_dict(TConfig(**TINY), 1)
    assert params_digest(other) == jparams_digest(params_to_jax(other))
    assert params_digest(other) != digest


def test_probe_request_equals_jax(pool, jpool):
    got, bucket = pool.probe_request()
    want, jbucket = jpool.probe_request()
    assert bucket == jbucket == 32
    assert got.dtype == want.dtype and got.shape == want.shape == (16, 3)
    np.testing.assert_array_equal(got, want)


def test_hot_swap_equals_fresh_engine_without_recapture(state, monkeypatch,
                                                        tmp_path):
    """A swap serves flows bitwise equal to a fresh engine's on the new
    weights, with no capture and the same program table; the report has
    the JAX keys and the digests; reload_checkpoint reads a checkpoint."""
    cfg = ServeConfig(model=TConfig(**TINY), replicas=2, **POOL)
    eng = InferenceEngine(state, cfg, device="cpu")
    captures = []
    real = tengine.capture
    monkeypatch.setattr(tengine, "capture",
                        lambda *a, **k: captures.append(a[0]) or real(*a, **k))
    req = (_pc(20, 5), _pc(30, 6))
    before = eng.predict(*req)
    programs = [id(p) for r in eng.replicas for p in r.programs.values()]
    report_before = eng.compile_report()
    new = seeded_state_dict(cfg.model, 7)
    report = eng.swap_params(new, path="new", epoch=3)
    assert set(report) == {"digest", "previous_digest", "epoch", "path",
                           "replicas", "drained", "drained_in_time",
                           "swap_ms"}
    assert report["previous_digest"] == params_digest(state)
    assert report["digest"] == params_digest(new)
    assert (report["replicas"], report["drained"],
            report["drained_in_time"], report["epoch"]) == (2, 0, True, 3)
    assert captures == []
    assert [id(p) for r in eng.replicas for p in r.programs.values()] \
        == programs
    assert eng.compile_report() == report_before
    monkeypatch.setattr(tengine, "capture", real)
    fresh = InferenceEngine(new, cfg, device="cpu")
    for r in eng.replicas:
        np.testing.assert_array_equal(r.predict_batch([req], 32)[0],
                                      fresh.predict(*req))
    assert not np.array_equal(before, fresh.predict(*req))
    assert eng.weights_info() == {"path": "new", "digest": report["digest"],
                                  "epoch": 3, "swaps": 1}
    save_checkpoint(str(tmp_path), params_to_jax(state), {}, 4,
                    checkpoint_interval=0)
    path = str(tmp_path / "last_checkpoint.msgpack")
    back = eng.reload_checkpoint(path)
    assert (back["path"], back["epoch"], back["digest"]) == \
        (path, 4, params_digest(state))
    np.testing.assert_array_equal(eng.predict(*req), before)
    assert (eng.checkpoint_path, eng.checkpoint_epoch) == (path, 4)


def test_swap_waits_for_the_run_in_flight(state):
    """A swap takes each replica's lock: it waits for the run holding it
    and counts it as drained; past drain_timeout_s it reports that and
    still waits."""
    eng = InferenceEngine(state, ServeConfig(model=TConfig(**TINY),
                                             replicas=1, **POOL),
                          device="cpu")
    replica = eng.replicas[0]
    holding, release = threading.Event(), threading.Event()

    def hold():
        with replica._lock:
            with replica._count_lock:
                replica._runs += 1
                replica._running = True
            holding.set()
            release.wait(30)
            with replica._count_lock:
                replica._running = False

    # The swap's weights are built, and its arrival at the replica seen,
    # before the hold is released: under load the weights and the digest
    # could take longer than the window below.
    new = seeded_state_dict(TConfig(**TINY), 2)
    entered = threading.Event()
    replica_swap = replica.swap_params

    def spy(*args, **kw):
        entered.set()
        return replica_swap(*args, **kw)

    replica.swap_params = spy
    t = threading.Thread(target=hold)
    t.start()
    assert holding.wait(10)
    out = {}
    swap = threading.Thread(target=lambda: out.update(eng.swap_params(
        new, drain_timeout_s=0.01)))
    swap.start()
    assert entered.wait(30)
    assert not _until(lambda: "digest" in out, timeout=0.2)
    release.set()
    swap.join(30)
    t.join(30)
    assert out["drained"] == 1 and out["drained_in_time"] is False


def test_swaps_under_concurrent_requests_never_tear(state):
    """Threads predict through a 2-replica engine while the weights are
    swapped back and forth: every flow is one set's flow, bitwise (a
    replay that read half-copied weights would give neither)."""
    cfg = ServeConfig(model=TConfig(**TINY), replicas=2, **POOL)
    other = seeded_state_dict(cfg.model, 5)
    eng = InferenceEngine(state, cfg, device="cpu")
    req = (_pc(30, 3), _pc(28, 4))
    want = [eng.predict(*req),
            InferenceEngine(other, cfg, device="cpu").predict(*req)]
    stop, got = threading.Event(), []

    def client(replica):
        while not stop.is_set():
            got.append(replica.predict_batch([req], 32)[0])

    threads = [threading.Thread(target=client, args=(r,))
               for r in eng.replicas * 2]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for i in range(6):
            eng.swap_params(other if i % 2 == 0 else state)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert eng.weights_info()["swaps"] == 6
    assert got and all(np.array_equal(g, want[0])
                       or np.array_equal(g, want[1]) for g in got)


@pytest.mark.parametrize("weights", [
    {"nope": np.zeros(3, np.float32)},
    {"params": {"nope": {"kernel": np.zeros((3, 3), np.float32)}}},
    "refine", "wide"])
def test_swap_rejects_another_structure(pool, weights):
    info = pool.weights_info()
    if weights == "refine":
        weights = seeded_state_dict(TConfig(**TINY), 0, refine=True)
    elif weights == "wide":
        weights = seeded_state_dict(TConfig(**TINY, hidden_dim=32), 0)
    with pytest.raises(ValueError, match="swap rejected"):
        pool.swap_params(weights)
    assert pool.weights_info() == info


def test_no_cuda_means_no_service(monkeypatch, state):
    """No fallback: without a card the engine (so build_service) and the
    CLI raise unless the CPU is asked for."""
    monkeypatch.setattr(tengine.torch.cuda, "is_available", lambda: False)
    cfg = ServeConfig(model=TConfig(**TINY), **POOL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(state, cfg)
    server = build_service(InferenceEngine(state, cfg, device="cpu"))
    assert server.batcher.engine.device.type == "cpu"
    server.shutdown()


# ------------------------------------------------------ engine doubles --


class _GateReplica:
    """Instant flows, held per bucket by the engine's gates."""

    def __init__(self, engine, index):
        self.engine = engine
        self.index = self.device_id = index
        self.started = {b: threading.Event() for b in engine.cfg.buckets}

    def predict_batch(self, requests, bucket):
        self.started[bucket].set()
        self.engine.gates[bucket].wait(30)
        self.engine.dispatched.append((self.index, bucket, len(requests)))
        return [np.asarray(pc2[: pc1.shape[0]] - pc1, np.float32)
                for pc1, pc2 in requests]


class _FakePool:
    """Pool-shaped engine double: real routing, gated replicas."""

    def __init__(self, buckets=(32, 64), batch_sizes=(1, 2), n_replicas=1):
        self.cfg = SimpleNamespace(
            buckets=buckets, batch_sizes=batch_sizes, min_points=4,
            coord_limit=100.0, dtype="float32")
        self.gates = {b: threading.Event() for b in buckets}
        for gate in self.gates.values():
            gate.set()
        self.dispatched = []
        self.replicas = [_GateReplica(self, i) for i in range(n_replicas)]

    def validate_request(self, pc1, pc2):
        n = max(pc1.shape[0], pc2.shape[0])
        for b in self.cfg.buckets:
            if n <= b:
                return b
        raise RequestError("too_large", "too large")

    def batch_size_for(self, n):
        for bs in self.cfg.batch_sizes:
            if n <= bs:
                return bs
        return self.cfg.batch_sizes[-1]

    def compile_report(self):
        return []

    def weights_info(self):
        return {"path": None, "digest": "fake", "epoch": -1, "swaps": 0}


# ------------------------------------------------------------ batcher --


def test_batcher_buckets_and_exact_flow(state):
    """Concurrent requests across point counts land in their buckets and
    come back as the single path's flows, bitwise."""
    eng = InferenceEngine(state, ServeConfig(
        model=TConfig(**TINY), buckets=(32, 64), batch_sizes=(1,),
        num_iters=2, dtype="float32", replicas=2), device="cpu")
    metrics = ServeMetrics(eng.cfg.buckets)
    batcher = MicroBatcher(
        eng, BatcherConfig(max_batch=1, max_wait_ms=20, queue_depth=16),
        metrics=metrics)
    rng = np.random.default_rng(4)
    sizes = [20, 28, 40, 64, 17, 50]
    reqs = [(_cloud(rng, n), _cloud(rng, n)) for n in sizes]
    want = [eng.predict(*r) for r in reqs]
    handles = [None] * len(reqs)

    def client(i):
        handles[i] = batcher.submit(*reqs[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.wait(60), want[i])
    batcher.shutdown(drain=True)
    snap = metrics.snapshot(batcher.queue_depths())
    assert snap["responses_total"] == len(reqs)
    assert snap["per_bucket_requests"] == {"32": 3, "64": 3}
    assert snap["queue_depth"] == {"32": 0, "64": 0}
    stats = batcher.replica_stats()
    assert sum(s["batches_total"] for s in stats) == len(reqs)
    assert all(s["in_flight"] == 0 for s in stats)


def test_backpressure_full_queue_raises_not_blocks():
    engine = _FakePool()
    engine.gates[32].clear()
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=2))
    first = batcher.submit(_pc(20), _pc(20))
    assert engine.replicas[0].started[32].wait(10)      # executing
    batcher.submit(_pc(20, 1), _pc(20, 1))
    assert _until(lambda: batcher.batch_queue_depth() == 1)
    batcher.submit(_pc(20, 2), _pc(20, 2))               # the collector's
    assert _until(lambda: batcher.queue_depths()[32] == 0)
    batcher.submit(_pc(20, 3), _pc(20, 3))
    batcher.submit(_pc(20, 4), _pc(20, 4))               # queue 2 of 2
    with pytest.raises(QueueFullError, match="2 of 2"):
        batcher.submit(_pc(20, 5), _pc(20, 5))
    assert batcher.counts["rejected"] == 1
    engine.gates[32].set()
    assert first.wait(30).shape == (20, 3)
    batcher.shutdown(drain=True)
    assert batcher.counts["served"] == 5


def test_shutdown_drains_in_flight():
    engine = _FakePool()
    engine.gates[32].clear()
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=2, max_wait_ms=1, queue_depth=16))
    handles = [batcher.submit(_pc(20, i), _pc(20, i)) for i in range(6)]
    done = threading.Event()

    def stopper():
        batcher.shutdown(drain=True)
        done.set()

    t = threading.Thread(target=stopper)
    t.start()
    assert batcher._stopping.wait(10)
    with pytest.raises(ShutdownError):
        batcher.submit(_pc(20, 99), _pc(20, 99))
    assert not done.is_set()                  # the drain waits for the gate
    engine.gates[32].set()
    t.join(30)
    assert done.is_set()
    for h in handles:
        assert h.wait(1).shape == (20, 3)
    assert batcher.counts["served"] == 6


def test_shutdown_without_drain_fails_queued():
    engine = _FakePool()
    engine.gates[32].clear()
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=16))
    handles = [batcher.submit(_pc(20, i), _pc(20, i)) for i in range(4)]
    assert engine.replicas[0].started[32].wait(10)
    stopper = threading.Thread(target=lambda: batcher.shutdown(drain=False))
    stopper.start()
    assert batcher._stopping.wait(10)
    engine.gates[32].set()
    stopper.join(30)
    assert not stopper.is_alive()
    outcomes = []
    for h in handles:
        try:
            h.wait(5)
            outcomes.append("ok")
        except ShutdownError:
            outcomes.append("shutdown")
    assert outcomes == ["ok", "shutdown", "shutdown", "shutdown"]
    assert batcher.counts["rejected"] == 3
    assert batcher.counts["served"] == 1


def test_metrics_failure_accounting_reconciles():
    m = ServeMetrics(buckets=(32,))
    m.record_submit(32)
    m.record_submit(32)
    m.record_reject("bad_request")
    assert m.current_in_flight() == 2
    m.record_batch(1, 0.5, [3.0])
    m.record_failure("timeout")
    snap = m.snapshot()
    assert snap["requests_total"] == 3
    assert snap["responses_total"] + sum(snap["rejected"].values()) == 3
    assert snap["rejected"] == {"bad_request": 1, "timeout": 1}
    assert m.current_in_flight() == 0


def test_no_head_of_line_blocking():
    """A held large-bucket batch occupies one replica; small requests keep
    completing on the other."""
    engine = _FakePool(n_replicas=2)
    engine.gates[64].clear()
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=2, max_wait_ms=2, queue_depth=32))
    try:
        slow = batcher.submit(_pc(60), _pc(60))
        assert _until(lambda: any(r.started[64].is_set()
                                  for r in engine.replicas))
        for seed in range(5):
            h = batcher.submit(_pc(20, seed), _pc(20, seed))
            assert h.wait(10).shape == (20, 3)
        assert not slow.done.is_set()
        assert sum(s["in_flight"] for s in batcher.replica_stats()) == 1
    finally:
        engine.gates[64].set()
    assert slow.wait(30).shape == (60, 3)
    batcher.shutdown(drain=True)
    assert batcher.counts["served"] == 6


@pytest.mark.parametrize("eager", [True, False])
def test_eager_dispatch_vs_straggler_window(eager):
    """With idle capacity a lone request dispatches at once, though the
    window is a minute; without eager dispatch it waits for the window or
    a full group (a second request completes both)."""
    engine = _FakePool()
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=2, max_wait_ms=60_000,
                              queue_depth=8, eager_when_idle=eager))
    h = batcher.submit(_pc(20), _pc(20))
    if eager:
        assert h.wait(10).shape == (20, 3)
        assert engine.dispatched == [(0, 32, 1)]
    else:
        assert not h.done.wait(0.2)
        h2 = batcher.submit(_pc(20, 1), _pc(20, 1))
        assert h.wait(10).shape == h2.wait(10).shape == (20, 3)
        assert engine.dispatched == [(0, 32, 2)]
    batcher.shutdown(drain=True)


def test_many_clients_get_their_own_flows():
    """More client threads than cores, a 3-replica pool and a short
    switch interval: each request gets its own flow, and the books
    balance."""
    engine = _FakePool(n_replicas=3)
    metrics = ServeMetrics(engine.cfg.buckets)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=2, max_wait_ms=1, queue_depth=256),
        metrics=metrics)
    n_threads, calls = 32, 8
    errors = []

    def client(i):
        for c in range(calls):
            n = 10 + (i * calls + c) % 50
            pc1, pc2 = _pc(n, 1000 * i + c), _pc(n, 1000 * i + c + 500)
            got = batcher.submit(pc1, pc2).wait(30)
            if not np.array_equal(got, pc2 - pc1):
                errors.append((i, c))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and errors == []
    batcher.shutdown(drain=True)
    snap = metrics.snapshot()
    assert snap["requests_total"] == snap["responses_total"] == \
        n_threads * calls
    assert metrics.current_in_flight() == 0
    assert sum(r["batches_total"] for r in batcher.replica_stats()) == \
        snap["batches_total"]


def _identity_holds(text):
    def one(name):
        m = re.search(rf"^{name} (\S+)$", text, re.M)
        return float(m.group(1)) if m else 0.0

    rejected = sum(float(v) for v in re.findall(
        r'^pvraft_serve_rejected_total\{[^}]*\} (\S+)$', text, re.M))
    return one("pvraft_serve_requests_total") == (
        one("pvraft_serve_responses_total") + rejected
        + one("pvraft_serve_in_flight"))


def test_live_in_flight_reconciliation_and_prometheus():
    engine = _FakePool(n_replicas=2)
    engine.gates[32].clear()
    metrics = ServeMetrics(engine.cfg.buckets)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8),
        metrics=metrics)
    h = batcher.submit(_pc(20), _pc(20))
    assert _until(lambda: any(r.started[32].is_set()
                              for r in engine.replicas))
    snap = metrics.snapshot()
    assert (snap["requests_total"], snap["responses_total"]) == (1, 0)
    assert metrics.current_in_flight() == 1
    text = metrics.prometheus(
        batcher.queue_depths(), replica_stats=batcher.replica_stats(),
        batch_queue_depth=batcher.batch_queue_depth())
    assert "pvraft_serve_in_flight 1" in text
    for family in ("pvraft_serve_replica_in_flight",
                   "pvraft_serve_replica_batches_total",
                   "pvraft_serve_batch_queue_depth"):
        assert family in text
    assert _identity_holds(text)
    assert sum(s["in_flight"] for s in batcher.replica_stats()) == 1
    engine.gates[32].set()
    h.wait(10)
    batcher.shutdown(drain=True)
    text = metrics.prometheus(replica_stats=batcher.replica_stats())
    assert "pvraft_serve_in_flight 0" in text and _identity_holds(text)


def test_outcome_recorded_exactly_once_under_timeout_race():
    engine = _FakePool()
    metrics = ServeMetrics(engine.cfg.buckets)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8),
        metrics=metrics)
    h = batcher.submit(_pc(20), _pc(20))
    h.wait(10)
    batcher.record_failure_for(h, "timeout")      # the dispatch won
    snap = metrics.snapshot()
    assert snap["rejected"] == {} and metrics.current_in_flight() == 0
    assert snap["requests_total"] == snap["responses_total"] == 1
    engine.gates[32].clear()
    h2 = batcher.submit(_pc(20, 1), _pc(20, 1))
    with pytest.raises(TimeoutError):
        h2.wait(0.05)
    batcher.record_failure_for(h2, "timeout")     # the waiter won
    engine.gates[32].set()
    batcher.shutdown(drain=True)
    snap = metrics.snapshot()
    assert snap["rejected"] == {"timeout": 1}
    assert metrics.current_in_flight() == 0
    assert snap["requests_total"] == snap["responses_total"] + 1


def test_replica_utilization_equals_jax():
    intervals = {0: [(0.0, 10.0), (50.0, 70.0)], 1: [(65.0, 66.5)],
                 2: [(-100.0, 200.0)]}
    for now in (70.0, 100.0, 130.0):
        assert replica_utilization(intervals, now) == \
            jutilization(intervals, now)


# --------------------------------------------------------------- HTTP --


def _http(server, method, path, body=None, ctype="application/json",
          headers=None):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    try:
        hdrs = dict(headers or {})
        if body is not None:
            hdrs.setdefault("Content-Type", ctype)
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _json_body(pc1, pc2):
    return json.dumps({"pc1": pc1.tolist(), "pc2": pc2.tolist()})


def _msgpack_body(pc1, pc2):
    return msgpack.packb({"pc1": pc1.tobytes(), "pc2": pc2.tobytes()})


def test_healthz_reports_replicas():
    engine = _FakePool(n_replicas=2)
    metrics = ServeMetrics(engine.cfg.buckets)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=2, max_wait_ms=2, queue_depth=8),
        metrics=metrics)
    server = ServeHTTPServer(batcher, port=0, metrics=metrics)
    server.start()
    try:
        status, _, _ = _http(server, "POST", "/predict",
                             _json_body(_pc(20), _pc(20, 1)))
        assert status == 200
        health = json.loads(_http(server, "GET", "/healthz")[1])
        assert health["dtype"] == "float32" and health["in_flight"] == 0
        assert health["pool"] is None and health["cost"] is None
        assert [r["replica"] for r in health["replicas"]] == [0, 1]
        assert all(set(r) == {"replica", "device_id", "in_flight",
                              "batches_total"}
                   for r in health["replicas"])
        assert sum(r["batches_total"] for r in health["replicas"]) == 1
        snap = json.loads(_http(server, "GET", "/metrics")[1])
        assert set(snap) == {
            "requests_total", "responses_total", "rejected",
            "batches_total", "batch_fill_mean", "per_bucket_requests",
            "latency", "queue_depth"}
    finally:
        server.shutdown(drain=True)


@pytest.fixture(scope="module")
def surface(tmp_path_factory):
    """A port cost inventory of two fp32 serve specs (counted at "tiny"
    on the CPU): it prices the pool's bucket by extrapolation."""
    from pvraft_tpu_torch.programs import get, load_catalog
    from pvraft_tpu_torch.programs.costs import run_costs

    load_catalog()
    doc = run_costs([get(f"serve_predict_fp32_b2048_bs{bs}")
                     for bs in (1, 4)], "cpu", "tiny")
    path = tmp_path_factory.mktemp("surface") / "programs_costs.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture(scope="module")
def services(pool, jpool, surface):
    """The JAX service and the port's on the same weights, supervised,
    armed with one cost surface, started on ephemeral ports."""
    jserver = jbuild_service(jpool, cost_surface=surface)
    tserver = build_service(pool, cost_surface=surface)
    jserver.start()
    tserver.start()
    yield jserver, tserver
    tserver.shutdown(drain=True)
    jserver.shutdown(drain=True)


def _requests():
    rng = np.random.default_rng(11)
    ok = (_cloud(rng, 20), _cloud(rng, 26))
    nan = ok[0].copy()
    nan[3, 1] = np.nan
    return [
        ("json", "POST", "/predict", _json_body(*ok), "application/json"),
        ("msgpack", "POST", "/predict", _msgpack_body(*ok),
         "application/msgpack"),
        ("too_small", "POST", "/predict",
         _json_body(_cloud(rng, 8), _cloud(rng, 8)), "application/json"),
        ("too_large", "POST", "/predict",
         _json_body(_cloud(rng, 40), _cloud(rng, 40)), "application/json"),
        ("far", "POST", "/predict", _json_body(ok[0] * 500, ok[1]),
         "application/json"),
        ("nan", "POST", "/predict", _json_body(nan, ok[1]),
         "application/json"),
        ("not_json", "POST", "/predict", "not json", "application/json"),
        ("no_pc2", "POST", "/predict", json.dumps({"pc1": [[0, 0, 0]]}),
         "application/json"),
        ("flat", "POST", "/predict",
         json.dumps({"pc1": [0.0] * 60, "pc2": [0.0] * 60}),
         "application/json"),
        ("bad_msgpack", "POST", "/predict", b"\xc1", "application/msgpack"),
        ("odd_bytes", "POST", "/predict",
         msgpack.packb({"pc1": b"1234", "pc2": b"1234"}),
         "application/msgpack"),
        ("no_route", "POST", "/nope", "{}", "application/json"),
        ("get_no_route", "GET", "/nope", None, None),
        ("bad_format", "GET", "/metrics?format=xml", None, None),
        ("reload_no_ckpt", "POST", "/admin/reload", "{}",
         "application/json"),
        ("reload_bad_json", "POST", "/admin/reload", "{", "application/json"),
        ("reload_missing", "POST", "/admin/reload",
         json.dumps({"ckpt": "/nonexistent/ckpt.msgpack"}),
         "application/json"),
        ("reload_bad_drain", "POST", "/admin/reload",
         json.dumps({"ckpt": "x", "drain_timeout_s": "soon"}),
         "application/json"),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _requests()])
def test_status_codes_equal_jax(services, case):
    """The same HTTP request to both services gets the same status; the
    good ones flows within 2e-4, JSON and msgpack bitwise alike."""
    jserver, tserver = services
    _, method, path, body, ctype = next(c for c in _requests()
                                        if c[0] == case)
    jstatus, jbody, _ = _http(jserver, method, path, body, ctype)
    tstatus, tbody, theaders = _http(tserver, method, path, body, ctype)
    assert tstatus == jstatus, (case, tbody)
    if case in ("json", "msgpack") and tstatus == 200:
        if case == "json":
            got = np.asarray(json.loads(tbody)["flow"], np.float32)
            want = np.asarray(json.loads(jbody)["flow"], np.float32)
        else:
            import msgpack as jmsgpack

            got = np.frombuffer(msgpack.unpackb(tbody)["flow"],
                                np.float32).reshape(-1, 3)
            want = np.frombuffer(jmsgpack.unpackb(jbody)["flow"],
                                 np.float32).reshape(-1, 3)
            assert theaders["Content-Type"] == "application/msgpack"
        assert got.shape == (20, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_ATOL)
    elif tstatus != 200:
        assert set(json.loads(tbody)) == {"error", "detail"}


def test_body_limits_equal_jax(services):
    for server in services:
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=30)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", str(10 ** 9))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
    codes = []
    for server in services:
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=30)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", "-5")
        conn.endheaders()
        codes.append(conn.getresponse().status)
        conn.close()
    assert codes == [400, 400]


@pytest.mark.parametrize("query", ["seconds=0.2", "seconds=0",
                                   "seconds=61", "seconds=soon",
                                   "profiler_running"])
def test_debug_trace_answers_like_jax(services, query):
    """``/debug/trace`` takes a CPU profiler window of the port's service
    (200, the trace written); a ``seconds`` outside (0, 60] or not a
    number gets 400 on both services; while another ``torch.profiler``
    session runs in the process the port answers 500 and names it (two
    sessions at once are not supported)."""
    jserver, tserver = services
    if query == "profiler_running":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            status, body, _ = _http(tserver, "GET",
                                    "/debug/trace?seconds=0.2")
        assert status == 500 and "another torch.profiler session" in \
            json.loads(body)["detail"]
        return
    status, body, _ = _http(tserver, "GET", f"/debug/trace?{query}")
    if query == "seconds=0.2":
        doc = json.loads(body)
        assert status == 200 and doc["seconds"] == 0.2, body
        assert (Path(doc["trace_dir"]) / "trace.json").stat().st_size > 0
    else:
        assert status == _http(jserver, "GET", f"/debug/trace?{query}")[0] \
            == 400


def test_json_and_msgpack_agree_bitwise(services):
    _, tserver = services
    pc1, pc2 = _pc(23, 8), _pc(19, 9)
    _, jb, _ = _http(tserver, "POST", "/predict", _json_body(pc1, pc2))
    _, mb, _ = _http(tserver, "POST", "/predict", _msgpack_body(pc1, pc2),
                     "application/msgpack")
    doc = msgpack.unpackb(mb)
    flow = np.frombuffer(doc["flow"], np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(np.asarray(json.loads(jb)["flow"],
                                             np.float32), flow)
    assert doc["n"] == 23
    np.testing.assert_array_equal(
        flow, tserver.batcher.engine.predict(pc1, pc2))


def _keys(doc, skip=()):
    """Nested key paths of a JSON document (lists of dicts by their first
    row)."""
    out = set()
    for k, v in doc.items():
        if k in skip:
            continue
        out.add(k)
        if isinstance(v, list) and v and isinstance(v[0], dict):
            v = v[0]
        if isinstance(v, dict) and k not in ("per_bucket_requests",
                                             "queue_depth", "rejected"):
            out |= {f"{k}.{sub}" for sub in _keys(v)}
    return out


def _families(text):
    return set(re.findall(r"^# TYPE (\S+) ", text, re.M))


def test_healthz_and_metrics_keys_equal_jax(services):
    """The same keys in /healthz (the programs' rows aside: captures
    against XLA compiles; the cost block's per-replica maps aside: keyed
    by the replicas each pool happened to use) and /metrics JSON, the same
    cost-surface block, and the same Prometheus families."""
    for path in ("/predict", "/predict"):
        for server in services:
            _http(server, "POST", path, _json_body(_pc(20), _pc(21)))
    jserver, tserver = services
    jh = json.loads(_http(jserver, "GET", "/healthz")[1])
    th = json.loads(_http(tserver, "GET", "/healthz")[1])
    skip = ("programs", "cost")
    assert _keys(th, skip=skip) == _keys(jh, skip=skip)
    assert _keys(th["cost"], skip=("device_busy_seconds", "utilization")) \
        == _keys(jh["cost"], skip=("device_busy_seconds", "utilization"))
    assert th["cost_surface"] == jh["cost_surface"]
    assert [(r["bucket"], r["batch"], r["dtype"], r["comparable"])
            for r in th["cost"]["calibration"]] == \
        [(r["bucket"], r["batch"], r["dtype"], r["comparable"])
         for r in jh["cost"]["calibration"]]
    assert th["telemetry"] == jh["telemetry"] == {
        "events_path": None, "tracing": True, "trace_sample_every": 16,
        "trace_dir": None}
    assert th["pool"] == jh["pool"]
    assert [r["state"] for r in th["replicas"]] == \
        [r["state"] for r in jh["replicas"]] == ["healthy", "healthy"]
    assert [r["name"] for r in th["programs"]] == \
        [r["name"] for r in jh["programs"]]
    assert th["weights"]["digest"] == jh["weights"]["digest"]
    jm = json.loads(_http(jserver, "GET", "/metrics")[1])
    tm = json.loads(_http(tserver, "GET", "/metrics")[1])
    assert _keys(tm) == _keys(jm)
    jp = _http(jserver, "GET", "/metrics?format=prometheus")
    tp = _http(tserver, "GET", "/metrics?format=prometheus")
    assert tp[2]["Content-Type"] == jp[2]["Content-Type"]
    assert _families(tp[1].decode()) == _families(jp[1].decode())
    assert ITEM9C_FAMILIES <= _families(tp[1].decode())
    assert _identity_holds(tp[1].decode())


def test_reload_reports_equal_jax(services, state, tmp_path):
    """/admin/reload of the same checkpoints on both: the same report keys
    and digests; another structure gets 409 on both."""
    jserver, tserver = services
    new = seeded_state_dict(TConfig(**TINY), 3)
    reports = {}
    for name, weights in (("new", new), ("old", state)):
        save_checkpoint(str(tmp_path / name), params_to_jax(weights), {}, 2,
                        checkpoint_interval=0)
        ckpt = str(tmp_path / name / "last_checkpoint.msgpack")
        for server in services:
            status, body, _ = _http(server, "POST", "/admin/reload",
                                    json.dumps({"ckpt": ckpt}))
            assert status == 200
            reports[(name, server is tserver)] = json.loads(body)
    for name in ("new", "old"):
        t, j = reports[(name, True)], reports[(name, False)]
        assert set(t) == set(j)
        assert (t["digest"], t["previous_digest"], t["epoch"], t["path"]) \
            == (j["digest"], j["previous_digest"], j["epoch"], j["path"])
    wide = seeded_state_dict(TConfig(**TINY, hidden_dim=32), 0)
    save_checkpoint(str(tmp_path / "wide"), params_to_jax(wide), {}, 0,
                    checkpoint_interval=0)
    ckpt = str(tmp_path / "wide" / "last_checkpoint.msgpack")
    for server in services:
        status, body, _ = _http(server, "POST", "/admin/reload",
                                json.dumps({"ckpt": ckpt}))
        assert status == 409, body
    th = json.loads(_http(tserver, "GET", "/healthz")[1])
    assert th["weights"]["digest"] == params_digest(state)
    assert th["weights"]["swaps"] == 2


# ---------------------------------------------------------------- CLI --


OBS_DEFAULTS = {"events": "", "trace_sample": 16, "trace_dir": "",
                "strict_retrace": False, "devmem_interval": 10.0}


@pytest.mark.parametrize("case", ["defaults", "given", "strict-retrace",
                                  "cost_surface", "cost-surface",
                                  "validate_load"])
def test_cli_observability_flags(monkeypatch, capsys, case):
    """The five observability flags and ``--cost_surface`` (either
    spelling) parse to the JAX CLI's defaults and values; ``validate-load``
    answers a missing file as the JAX CLI does."""
    import pvraft_tpu.serve.__main__ as jcli
    from pvraft_tpu_torch.serve import __main__ as cli

    seen, jseen = {}, {}
    monkeypatch.setattr(cli, "_cmd_serve", lambda a: seen.update(vars(a)))
    monkeypatch.setattr(jcli, "_cmd_serve", lambda a: jseen.update(vars(a)))
    argv = {"defaults": [],
            "given": ["--events", "e.jsonl", "--trace_sample", "1",
                      "--trace_dir", "t", "--strict_retrace",
                      "--devmem_interval", "0.5"],
            "strict-retrace": ["--strict-retrace"],
            "cost_surface": ["--cost_surface", "x"],
            "cost-surface": ["--cost-surface=x"]}.get(case)
    if argv is None:
        assert cli.main(["validate-load", "a.json"]) == 1
        err = capsys.readouterr().err
        assert jcli.main(["validate-load", "a.json"]) == 1
        assert capsys.readouterr().err == err and "unreadable" in err
        return
    cli.main(["serve", "--ckpt", "x", *argv])
    jcli.main(["serve", "--ckpt", "x", *argv])
    keys = (*OBS_DEFAULTS, "cost_surface")
    got = {k: seen[k] for k in keys}
    assert got == {k: jseen[k] for k in keys}
    if case == "defaults":
        assert got == {**OBS_DEFAULTS, "cost_surface": ""}
    if case.startswith("cost"):
        assert got["cost_surface"] == "x"


def test_cli_needs_the_card_unless_cpu(monkeypatch, state, tmp_path):
    from pvraft_tpu_torch.serve.__main__ import main

    monkeypatch.setattr(tengine.torch.cuda, "is_available", lambda: False)
    save_checkpoint(str(tmp_path), params_to_jax(state), {}, 0,
                    checkpoint_interval=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--ckpt", str(tmp_path / "last_checkpoint.msgpack")])


def test_cli_serves_and_drains_on_sigint(state, tmp_path):
    """``python -m pvraft_tpu_torch.serve serve --platform cpu`` answers
    /healthz and /predict, and exits 0 after draining on SIGINT."""
    save_checkpoint(str(tmp_path), params_to_jax(state), {}, 5,
                    checkpoint_interval=0)
    ckpt = str(tmp_path / "last_checkpoint.msgpack")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pvraft_tpu_torch.serve", "serve",
         "--ckpt", ckpt, "--platform", "cpu", "--port", "0",
         "--buckets", "32", "--batch_sizes", "1", "--iters", "2",
         "--truncate_k", "16", "--corr_knn", "8", "--graph_k", "4",
         "--dtype", "float32"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "listening on" in line:
                break
        host, port = re.search(r"http://([\d.]+):(\d+)",
                               lines[-1]).groups()
        target = SimpleNamespace(host=host, port=int(port))
        health = json.loads(_http(target, "GET", "/healthz")[1])
        assert health["weights"]["path"] == ckpt
        assert health["weights"]["epoch"] == 5
        assert health["dtype"] == "float32"
        status, body, _ = _http(target, "POST", "/predict",
                                _json_body(_pc(20), _pc(22)))
        assert status == 200 and json.loads(body)["n"] == 20
        proc.send_signal(signal.SIGINT)
        rest = proc.stdout.read()
        assert proc.wait(30) == 0, "".join(lines) + rest
        assert "draining" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
