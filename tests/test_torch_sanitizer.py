"""The port's lock-order sanitizer
(``pvraft_tpu_torch/analysis/concurrency/sanitizer.py``): the JAX
sanitizer's cases (``tests/test_threadcheck.py``) run against both
implementations, and the port's tiny service under ``PVRAFT_CHECKS=1``:
every serving lock an ``OrderedLock``, concurrent requests served
bitwise as without checks, no ``LockOrderError``."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pvraft_tpu.analysis.concurrency import sanitizer as jsan
from pvraft_tpu_torch.analysis.concurrency import sanitizer as tsan
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig, build_service
from pvraft_tpu_torch.weights import seeded_state_dict

REPO = Path(__file__).resolve().parents[1]
SANITIZERS = {"port": tsan, "jax": jsan}


@pytest.fixture(autouse=True)
def _fresh_graph():
    for san in SANITIZERS.values():
        san.reset_order_graph()
    yield
    for san in SANITIZERS.values():
        san.reset_order_graph()


def _consistent_order(san):
    a, b = san.OrderedLock("t.a"), san.OrderedLock("t.b")
    for _ in range(3):
        with a:
            with b:
                pass
    assert ("t.a", "t.b") in san.order_edges()


def _inversion_names_both_sites(san):
    a, b = san.OrderedLock("t.a"), san.OrderedLock("t.b")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(san.LockOrderError) as err:
            a.acquire()
    msg = str(err.value)
    assert "t.a" in msg and "t.b" in msg and "opposite order" in msg
    assert not a.locked()  # raised before it blocked


def _inversion_across_threads(san):
    a, b = san.OrderedLock("t.a"), san.OrderedLock("t.b")

    def leg_ab():
        with a:
            with b:
                pass

    t = threading.Thread(target=leg_ab)
    t.start()
    t.join()
    with b:
        with pytest.raises(san.LockOrderError):
            with a:
                pass


def _recursive_acquire(san):
    a = san.OrderedLock("t.a")
    with a:
        with pytest.raises(san.LockOrderError, match="recursive"):
            a.acquire()
    with a:
        pass


def _trylock_never_raises(san):
    a, b = san.OrderedLock("t.a"), san.OrderedLock("t.b")
    with a:
        with b:
            pass
    with b:
        assert a.acquire(blocking=False) is True
        a.release()
    assert ("t.b", "t.a") not in san.order_edges()


def _trylock_held_constrains(san):
    a, b = san.OrderedLock("t.a"), san.OrderedLock("t.b")
    assert a.acquire(blocking=False)
    with b:
        pass
    a.release()
    assert ("t.a", "t.b") in san.order_edges()
    with b:
        with pytest.raises(san.LockOrderError):
            a.acquire()


def _release_out_of_order(san):
    a, b = san.OrderedLock("t.a"), san.OrderedLock("t.b")
    a.acquire()
    b.acquire()
    a.release()
    b.release()
    with a:
        pass


def _factory_gates_on_env(san, monkeypatch):
    monkeypatch.delenv("PVRAFT_CHECKS", raising=False)
    assert not isinstance(san.ordered_lock("t.x"), san.OrderedLock)
    monkeypatch.setenv("PVRAFT_CHECKS", "1")
    lock = san.ordered_lock("t.x")
    assert isinstance(lock, san.OrderedLock) and lock.name == "t.x"


CASES = {f.__name__[1:]: f for f in (
    _consistent_order, _inversion_names_both_sites,
    _inversion_across_threads, _recursive_acquire, _trylock_never_raises,
    _trylock_held_constrains, _release_out_of_order)}


@pytest.mark.parametrize("impl", sorted(SANITIZERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_sanitizer_cases(case, impl):
    CASES[case](SANITIZERS[impl])


@pytest.mark.parametrize("impl", sorted(SANITIZERS))
def test_factory_gates_on_env(monkeypatch, impl):
    _factory_gates_on_env(SANITIZERS[impl], monkeypatch)


def test_checks_enabled_reads_pvraft_checks(monkeypatch):
    monkeypatch.setenv("PVRAFT_CHECKS", "0")
    assert not tsan.checks_enabled()
    monkeypatch.setenv("PVRAFT_CHECKS", "1")
    assert tsan.checks_enabled()


# --------------------------------------------- the service under checks --

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 4}
SERVE = {"buckets": (32,), "batch_sizes": (1, 2), "num_iters": 2,
         "dtype": "float32", "replicas": 2}


def serving_locks(server):
    """Every lock of a built service, by its sanitizer name."""
    batcher, engine = server.batcher, server.batcher.engine
    handler = server.httpd.RequestHandlerClass
    locks = {
        "InferenceEngine._swap_lock": engine._swap_lock,
        "MicroBatcher._intake_lock": batcher._intake_lock,
        "MicroBatcher._count_lock": batcher._count_lock,
        "ServeMetrics._lock": handler.metrics._lock,
        "ReplicaSupervisor._lock": server.supervisor._lock,
        "ReplicaSupervisor._thread_lock": server.supervisor._thread_lock,
        "RetraceWatchdog._lock": batcher.watchdog._lock,
        "Tracer._lock": server.tracer._lock,
        "DeviceMemoryMonitor._state_lock":
            server.devmem_monitor._state_lock,
    }
    for r in engine.replicas:
        locks[f"Replica._lock[{r.index}]"] = r._lock
        locks[f"Replica._count_lock[{r.index}]"] = r._count_lock
    if handler.telemetry is not None:
        locks["ServeTelemetry._lock"] = handler.telemetry._lock
    return locks


def _serve_concurrently(server, requests, threads=4):
    out = [None] * len(requests)

    def client(i):
        for k in range(i, len(requests), threads):
            h = server.batcher.submit(*requests[k])
            out[k] = h.wait(60)

    workers = [threading.Thread(target=client, args=(i,))
               for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(120)
    return out


def test_service_under_checks_uses_ordered_locks(monkeypatch, tmp_path):
    """``PVRAFT_CHECKS=1`` set before the engine and ``build_service``:
    every serving lock is an ``OrderedLock``, four clients' concurrent
    requests are served bitwise as serially, and no order is inverted."""
    from pvraft_tpu_torch.serve.events import ServeTelemetry

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    requests = [(rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                 rng.uniform(-1, 1, (n + 2, 3)).astype(np.float32))
                for n in (17, 20, 23, 26, 18, 21, 24, 28)]
    state = seeded_state_dict(TConfig(**TINY), 0)
    cfg = ServeConfig(model=TConfig(**TINY), **SERVE)
    try:
        monkeypatch.setenv("PVRAFT_CHECKS", "1")
        tel = ServeTelemetry(str(tmp_path / "s.events.jsonl"), enabled=True)
        engine = InferenceEngine(state, cfg, device="cpu", telemetry=tel)
        server = build_service(engine, telemetry=tel, trace_sample_every=1,
                               devmem_interval_s=0.01)
        server.start()
        try:
            locks = serving_locks(server)
            plain = {k for k, v in locks.items()
                     if not isinstance(v, tsan.OrderedLock)}
            assert not plain, plain
            got = _serve_concurrently(server, requests)
            engine.swap_params(state)
        finally:
            server.shutdown(drain=True)
            tel.close()
        monkeypatch.delenv("PVRAFT_CHECKS")
        want = [engine.predict(*r) for r in requests]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        edges = tsan.order_edges()
        assert ("MicroBatcher._intake_lock", "ServeMetrics._lock") in edges
        assert ("Replica._lock", "Replica._count_lock") in edges
        assert ("InferenceEngine._swap_lock", "Replica._lock") in edges
    finally:
        torch.set_num_threads(prev)


def test_process_wide_locks_under_checks_from_the_start():
    """The two locks made at import (the fault injector's and the
    ``/debug/trace`` window's) are ``OrderedLock``s when
    ``PVRAFT_CHECKS=1`` is set before the import."""
    code = ("import json\n"
            "from pvraft_tpu_torch.serve import faults, server\n"
            "print(json.dumps([type(faults._INJECTOR._lock).__name__,\n"
            "                  type(server._DEBUG_TRACE_LOCK).__name__]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env={**os.environ, "PVRAFT_CHECKS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        ["OrderedLock", "OrderedLock"]
