"""The port's fault plans, replica supervisor and the batcher's
fault-tolerance paths against the JAX package's
(``tests/test_supervisor.py``): fault-rule semantics (the same schedule
fires on the same traversals in both packages), the health state
machine, probe revival, the wedge scan, the bounded hung probe, retry
once on another replica, every replica quarantined, degraded admission,
and the two supervisors side by side under the same fault plans. Engine
doubles and real threads, no model; waits are on events, joins and
conditions with timeouts, and nothing is asserted on wall time."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from pvraft_tpu.obs.events import FAULT_POINTS as JFAULT_POINTS
from pvraft_tpu.obs.events import REPLICA_STATES as JREPLICA_STATES
from pvraft_tpu.programs.geometries import SUPERVISOR_DEFAULTS as JDEFAULTS
from pvraft_tpu.serve import faults as jfaults
from pvraft_tpu.serve.supervisor import ReplicaSupervisor as JSupervisor
from pvraft_tpu.serve.supervisor import SupervisorConfig as JSupervisorConfig
from pvraft_tpu_torch.serve import faults
from pvraft_tpu_torch.serve.batcher import (
    BatcherConfig,
    MicroBatcher,
    PoolUnavailableError,
    QueueFullError,
)
from pvraft_tpu_torch.serve.engine import RequestError
from pvraft_tpu_torch.serve.faults import (
    FAULT_POINTS,
    FaultPlan,
    FaultRule,
    InjectedFaultError,
)
from pvraft_tpu_torch.serve.metrics import ServeMetrics
from pvraft_tpu_torch.serve.supervisor import (
    REPLICA_STATES,
    SUPERVISOR_DEFAULTS,
    ReplicaSupervisor,
    SupervisorConfig,
)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear_plan()
    jfaults.clear_plan()


def _until(predicate, timeout=10.0):
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        tick.wait(0.002)
    return True


class _Replica:
    """Fails while ``fail`` is set; held while the gate is clear."""

    def __init__(self, index):
        self.index = self.device_id = index
        self.calls = 0
        self.fail = False
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()

    def predict_batch(self, requests, bucket):
        self.calls += 1
        self.entered.set()
        self.gate.wait(30)
        if self.fail:
            raise RuntimeError(f"replica {self.index} broke")
        return [np.asarray(pc2[: pc1.shape[0]] - pc1, np.float32)
                for pc1, pc2 in requests]


class _Engine:
    def __init__(self, buckets=(32, 64), batch_sizes=(1, 2), n=2):
        self.cfg = SimpleNamespace(
            buckets=buckets, batch_sizes=batch_sizes, min_points=4,
            coord_limit=100.0, dtype="float32")
        self.replicas = [_Replica(i) for i in range(n)]

    def validate_request(self, pc1, pc2):
        m = max(pc1.shape[0], pc2.shape[0])
        for b in self.cfg.buckets:
            if m <= b:
                return b
        raise RequestError("too_large", "too large")

    def batch_size_for(self, n):
        for bs in self.cfg.batch_sizes:
            if n <= bs:
                return bs
        return self.cfg.batch_sizes[-1]


def _pc(n, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, 3)).astype(np.float32)


TIGHT = dict(degraded_after=1, quarantine_after=2, probe_interval_s=0,
             wedge_timeout_s=0.2, latency_min_samples=3,
             latency_outlier_after=2, latency_outlier_factor=3.0)


def _tight():
    return SupervisorConfig(**TIGHT)


# ------------------------------------------------------- fault schedule --


def test_vocabularies_equal_jax():
    assert FAULT_POINTS == JFAULT_POINTS
    assert REPLICA_STATES == JREPLICA_STATES
    assert SUPERVISOR_DEFAULTS == JDEFAULTS
    assert SupervisorConfig() == SupervisorConfig(**{
        k: getattr(JSupervisorConfig(), k) for k in SUPERVISOR_DEFAULTS})


@pytest.mark.parametrize("kw", [
    {"point": "not_a_point"}, {"point": "queue_stall", "nth": 0},
    {"point": "queue_stall", "every": -1},
    {"point": "queue_stall", "max_fires": -1},
    {"point": "queue_stall", "after_s": -1.0},
    {"point": "replica_latency_ms", "value": -1.0}])
def test_fault_rule_validation_like_jax(kw):
    with pytest.raises(ValueError):
        jfaults.FaultRule(**kw)
    with pytest.raises(ValueError):
        FaultRule(**kw)


def test_fault_plan_validation():
    with pytest.raises(ValueError):
        FaultPlan([])
    with pytest.raises(TypeError):
        FaultPlan(["queue_stall"])


SCHEDULES = {
    "nth_once": [{"point": "queue_stall", "nth": 2}],
    "every_capped": [{"point": "compile_trip", "nth": 1, "every": 2,
                      "max_fires": 2}],
    "per_replica": [{"point": "replica_latency_ms", "nth": 2, "every": 3,
                     "replica": 1}],
    "two_rules": [{"point": "queue_stall", "nth": 3},
                  {"point": "queue_stall", "nth": 1, "every": 4}],
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_fire_schedules_equal_jax(name):
    """The same plan and traversals fire the same records in both
    packages (and the same snapshot)."""
    rules = SCHEDULES[name]
    traversals = [(r, b) for r in (0, 1, None) for b in (32, 64)] * 3
    records = []
    for mod in (faults, jfaults):
        got = []
        with mod.injected(mod.FaultPlan([mod.FaultRule(**r)
                                         for r in rules])):
            for point in {r["point"] for r in rules}:
                for replica, bucket in traversals:
                    got.extend(mod.fire(point, replica=replica,
                                        bucket=bucket))
            snap = mod.plan_snapshot()
        records.append((got, snap))
    assert records[0] == records[1]
    assert records[0][0]


def test_fire_counts_per_replica():
    with faults.injected(FaultPlan([
            FaultRule("replica_predict_error", nth=2, replica=1)])):
        for _ in range(5):
            faults.fire("replica_predict_error", replica=0)
        faults.fire("replica_predict_error", replica=1)
        with pytest.raises(InjectedFaultError):
            faults.fire("replica_predict_error", replica=1)


def test_fire_after_s_window():
    with faults.injected(FaultPlan([FaultRule("queue_stall", nth=1, every=1,
                                              after_s=30.0)])):
        assert faults.fire("queue_stall") == ()


def test_install_is_exclusive_and_clear_unblocks_wedge():
    plan = FaultPlan([FaultRule("replica_wedge", nth=1, replica=0)])
    faults.install_plan(plan)
    with pytest.raises(RuntimeError):
        faults.install_plan(plan)
    entered, released = threading.Event(), threading.Event()

    def wedged():
        entered.set()
        faults.fire("replica_wedge", replica=0)
        released.set()

    t = threading.Thread(target=wedged, daemon=True)
    t.start()
    assert entered.wait(5)
    assert _until(lambda: faults.plan_snapshot()["fired_total"] == 1)
    assert not released.is_set()
    faults.clear_plan()
    assert released.wait(5)
    t.join(5)


def test_disarmed_is_inert():
    for point in FAULT_POINTS:
        assert faults.fire(point, replica=0) == ()
    faults.replica_faults(0, bucket=32)
    assert faults.plan_snapshot() == jfaults.plan_snapshot() == {
        "armed": False, "rules": [], "fired_total": 0, "rule_fires": []}


# --------------------------------------------------------- state machine --


def test_supervisor_config_validation_like_jax():
    for kw in ({"degraded_after": 0},
               {"degraded_after": 3, "quarantine_after": 2},
               {"latency_outlier_factor": 1.0}, {"probe_timeout_s": 0.0},
               {"wedge_timeout_s": 0.0}, {"probe_interval_s": -1.0}):
        with pytest.raises(ValueError):
            JSupervisorConfig(**kw)
        with pytest.raises(ValueError):
            SupervisorConfig(**kw)
    for interval in (0.3, 2.5, 0.0):
        assert SupervisorConfig(probe_interval_s=interval).retry_after_s == \
            JSupervisorConfig(probe_interval_s=interval).retry_after_s


def test_failure_streak_degrades_then_quarantines():
    sup = ReplicaSupervisor(_Engine(), cfg=_tight())
    assert [r["state"] for r in sup.states()] == ["healthy", "healthy"]
    sup.record_failure(1)
    assert sup.state_of(1) == "degraded" and sup.in_rotation(1)
    sup.record_failure(1)
    assert sup.state_of(1) == "quarantined" and not sup.in_rotation(1)
    assert sup.serving_count() == 1
    assert sup.retry_target(exclude=0) is None
    assert sup.retry_target(exclude=1) == 0
    sup.record_success(1, 32, 0.001)      # a straggler does not revive
    assert sup.state_of(1) == "quarantined"
    health = sup.pool_health()
    assert (health["state"], health["healthy_replicas"]) == ("degraded", 1)


def test_success_resets_streak_and_recovers_degraded():
    sup = ReplicaSupervisor(_Engine(), cfg=_tight())
    sup.record_failure(0)
    sup.record_success(0, 32, 0.001)
    assert sup.state_of(0) == "healthy"
    sup.record_failure(0)
    assert sup.state_of(0) == "degraded"


def test_latency_outliers_degrade_but_never_quarantine():
    sup = ReplicaSupervisor(_Engine(), cfg=_tight())
    for _ in range(TIGHT["latency_min_samples"]):
        sup.record_success(0, 32, 0.010)
    for _ in range(TIGHT["latency_outlier_after"]):
        sup.record_success(0, 32, 0.200)
    assert sup.state_of(0) == "degraded"
    for _ in range(10):
        sup.record_success(0, 32, 0.200)
    assert sup.state_of(0) == "degraded"
    sup.record_success(0, 32, 0.010)
    assert sup.state_of(0) == "healthy"


def test_probe_revives_quarantined_replica():
    engine = _Engine()
    sup = ReplicaSupervisor(engine, cfg=_tight())
    engine.replicas[1].fail = True
    sup.record_failure(1)
    sup.record_failure(1)
    sup.poll()
    assert sup.state_of(1) == "quarantined"
    assert sup.counts["probe_failures"] == 1
    engine.replicas[1].fail = False
    sup.poll()
    assert sup.state_of(1) == "healthy"
    assert sup.counts["probes"] == 2 and engine.replicas[1].calls == 2


def test_probe_traverses_fault_points():
    sup = ReplicaSupervisor(_Engine(), cfg=_tight())
    sup.record_failure(1)
    sup.record_failure(1)
    with faults.injected(FaultPlan([FaultRule(
            "replica_predict_error", nth=1, every=1, replica=1)])):
        sup.poll()
        assert sup.state_of(1) == "quarantined"
    sup.poll()
    assert sup.state_of(1) == "healthy"


def test_wedge_scan_quarantines_stuck_dispatch():
    sup = ReplicaSupervisor(_Engine(), cfg=_tight())
    token = sup.note_dispatch_start(0, time.monotonic() - 1.0)
    sup._scan_wedged()
    assert sup.state_of(0) == "quarantined"
    sup.note_dispatch_end(0, token)
    sup.record_success(0, 32, 0.5)
    assert sup.state_of(0) == "quarantined"


def test_wedge_survives_concurrent_dispatch_on_same_replica():
    sup = ReplicaSupervisor(_Engine(), cfg=_tight())
    wedged = sup.note_dispatch_start(0, time.monotonic() - 1.0)
    retry = sup.note_dispatch_start(0, time.monotonic())
    sup.note_dispatch_end(0, retry)
    sup._scan_wedged()
    assert sup.state_of(0) == "quarantined"
    sup.note_dispatch_end(0, wedged)


def test_probe_skips_replica_with_stuck_dispatch():
    engine = _Engine()
    sup = ReplicaSupervisor(engine, cfg=_tight())
    token = sup.note_dispatch_start(0, time.monotonic() - 1.0)
    sup.poll()
    assert sup.state_of(0) == "quarantined"
    sup.poll()
    assert engine.replicas[0].calls == 0
    sup.note_dispatch_end(0, token)
    sup.poll()
    assert sup.state_of(0) == "healthy" and engine.replicas[0].calls == 1


def test_hung_probe_is_bounded_and_does_not_block_siblings():
    """A probe that hangs costs one probe_timeout_s and fails; the
    sibling is probed and revived in the same pass (poll returns while
    the hung replica is still held)."""
    engine = _Engine()
    engine.replicas[0].gate.clear()
    sup = ReplicaSupervisor(engine, cfg=SupervisorConfig(
        degraded_after=1, quarantine_after=1, probe_interval_s=0,
        probe_timeout_s=0.2))
    sup.record_failure(0)
    sup.record_failure(1)
    sup.poll()
    assert engine.replicas[0].entered.is_set()
    assert not engine.replicas[0].gate.is_set()     # still hung
    assert sup.state_of(0) == "quarantined"
    assert sup.state_of(1) == "healthy"
    engine.replicas[0].gate.set()


def test_probe_thread_lifecycle_restartable():
    engine = _Engine()
    sup = ReplicaSupervisor(engine, cfg=SupervisorConfig(
        probe_interval_s=0.02))
    engine.replicas[0].fail = True
    for _ in range(3):
        sup.record_failure(0)
    assert sup.state_of(0) == "quarantined"
    sup.start()
    thread = sup._thread
    try:
        assert _until(lambda: sup.counts["probes"] >= 1)
        sup.stop()
        assert not thread.is_alive() and sup._thread is None
        engine.replicas[0].fail = False
        sup.start()
        assert _until(lambda: sup.state_of(0) == "healthy")
    finally:
        sup.stop()


def test_probe_payload_equals_jax():
    """The supervisor's probe cloud for an engine without probe_request is
    the JAX supervisor's, bitwise."""
    got = ReplicaSupervisor(_Engine(), cfg=_tight())
    want = JSupervisor(_Engine(), cfg=JSupervisorConfig(**TIGHT))
    np.testing.assert_array_equal(got._probe_cloud, want._probe_cloud)
    assert got._probe_bucket == want._probe_bucket == 32


# Scripted walks: (action, replica) steps; "fail"/"ok" feed dispatch
# outcomes, "poll" runs one supervision pass; "plan"/"clear" arm and
# disarm the same FaultPlan in both packages.
WALKS = {
    "quarantine_then_revive": [
        ("fail", 1), ("fail", 1), ("fail", 1), ("poll", None),
        ("plan", None), ("poll", None), ("clear", None), ("poll", None)],
    "degrade_recover": [
        ("fail", 0), ("ok", 0), ("fail", 0), ("fail", 0), ("fail", 1),
        ("ok", 1), ("fail", 0), ("poll", None)],
    "error_plan_on_both": [
        ("plan", None), ("fail", 0), ("fail", 1), ("fail", 0), ("fail", 1),
        ("fail", 0), ("fail", 1), ("poll", None), ("clear", None),
        ("poll", None)],
}


@pytest.mark.parametrize("name", sorted(WALKS))
def test_supervisor_states_equal_jax_under_the_same_fault_plans(name):
    rule = {"point": "replica_predict_error", "nth": 1, "every": 1}
    walks = []
    for mod, sup_cls, cfg_cls in ((faults, ReplicaSupervisor,
                                   SupervisorConfig),
                                  (jfaults, JSupervisor, JSupervisorConfig)):
        sup = sup_cls(_Engine(), cfg=cfg_cls(probe_interval_s=0))
        states = []
        for action, i in WALKS[name]:
            if action == "fail":
                sup.record_failure(i)
            elif action == "ok":
                sup.record_success(i, 32, 0.001)
            elif action == "poll":
                sup.poll()
            elif action == "plan":
                mod.install_plan(mod.FaultPlan([mod.FaultRule(**rule)]))
            else:
                mod.clear_plan()
            states.append([r["state"] for r in sup.states()])
        walks.append((states, sup.counts, sup.pool_health()))
        mod.clear_plan()
    assert walks[0] == walks[1]


# ------------------------------------------- batcher retry + degradation --


def test_retry_once_on_other_replica_no_double_resolve():
    engine = _Engine(n=2)
    metrics = ServeMetrics(engine.cfg.buckets)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8),
        metrics=metrics, supervisor=ReplicaSupervisor(engine, cfg=_tight()))
    with faults.injected(FaultPlan([FaultRule(
            "replica_predict_error", nth=1, every=1, replica=1)])):
        for seed in range(6):
            h = batcher.submit(_pc(20, seed), _pc(20, seed))
            assert h.wait(10).shape == (20, 3)
    batcher.shutdown(drain=True)
    counts = batcher.counts
    assert (counts["served"], counts["rejected"]) == (6, 0)
    snap = metrics.snapshot()
    assert snap["requests_total"] == snap["responses_total"] == 6
    assert metrics.current_in_flight() == 0
    assert counts["retries"] == metrics.retries_total


def test_failed_retry_fails_group_once():
    engine = _Engine(n=2)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8),
        supervisor=ReplicaSupervisor(engine, cfg=_tight()))
    with faults.injected(FaultPlan([FaultRule(
            "replica_predict_error", nth=1, every=1)])):
        h = batcher.submit(_pc(20), _pc(20))
        with pytest.raises(InjectedFaultError):
            h.wait(10)
        assert batcher.counts["retries"] == 1
    batcher.shutdown(drain=True)


def test_quarantined_replica_leaves_rotation():
    engine = _Engine(n=2)
    sup = ReplicaSupervisor(engine, cfg=_tight())
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=16),
        supervisor=sup)
    with faults.injected(FaultPlan([FaultRule(
            "replica_predict_error", nth=1, every=1, replica=1)])):
        seed = 0
        while sup.state_of(1) != "quarantined" and seed < 200:
            batcher.submit(_pc(20, seed), _pc(20, seed)).wait(10)
            seed += 1
        assert sup.state_of(1) == "quarantined"
        calls = engine.replicas[1].calls
        for s in range(seed, seed + 8):
            batcher.submit(_pc(20, s), _pc(20, s)).wait(10)
        assert engine.replicas[1].calls == calls
    batcher.shutdown(drain=True)


def test_all_quarantined_rejects_unavailable():
    engine = _Engine(n=2)
    sup = ReplicaSupervisor(engine, cfg=_tight())
    metrics = ServeMetrics(engine.cfg.buckets)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8),
        metrics=metrics, supervisor=sup)
    for i in range(2):
        sup.record_failure(i)
        sup.record_failure(i)
    assert sup.pool_health()["state"] == "unavailable"
    with pytest.raises(PoolUnavailableError):
        batcher.submit(_pc(20), _pc(20))
    snap = metrics.snapshot()
    assert snap["rejected"] == {"unavailable": 1}
    assert snap["requests_total"] == 1 and metrics.current_in_flight() == 0
    batcher.shutdown(drain=True)


def test_degraded_pool_shrinks_admission():
    """With one of two replicas quarantined the admissible queue depth
    halves: 2 of 4."""
    engine = _Engine(n=2)
    sup = ReplicaSupervisor(engine, cfg=_tight())
    sup.record_failure(1)
    sup.record_failure(1)
    engine.replicas[0].gate.clear()
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=4),
        supervisor=sup)
    handles = [batcher.submit(_pc(20), _pc(20))]
    assert engine.replicas[0].entered.wait(10)       # executing
    for seed in (1, 2):                              # the batch queue
        handles.append(batcher.submit(_pc(20, seed), _pc(20, seed)))
        assert _until(lambda: batcher.queue_depths()[32] == 0)
    handles.append(batcher.submit(_pc(20, 3), _pc(20, 3)))
    assert _until(lambda: batcher.queue_depths()[32] == 0)  # collector's
    for seed in (4, 5):
        handles.append(batcher.submit(_pc(20, seed), _pc(20, seed)))
    with pytest.raises(QueueFullError, match="2 of 4"):
        batcher.submit(_pc(20, 6), _pc(20, 6))
    engine.replicas[0].gate.set()
    for h in handles:
        assert h.wait(10).shape == (20, 3)
    assert engine.replicas[1].calls == 0
    batcher.shutdown(drain=True)


def test_replica_stats_carry_state_and_prometheus_series():
    engine = _Engine(n=2)
    sup = ReplicaSupervisor(engine, cfg=_tight())
    metrics = ServeMetrics(engine.cfg.buckets)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8),
        metrics=metrics, supervisor=sup)
    sup.record_failure(1)
    sup.record_failure(1)
    rows = batcher.replica_stats()
    assert [r["state"] for r in rows] == ["healthy", "quarantined"]
    text = metrics.prometheus(replica_stats=rows)
    assert ('pvraft_serve_replica_state{replica="1",'
            'state="quarantined"} 1') in text
    assert ('pvraft_serve_replica_state{replica="1",'
            'state="healthy"} 0') in text
    assert "pvraft_serve_retries_total 0" in text
    batcher.shutdown(drain=True)


def test_unsupervised_batcher_rows():
    engine = _Engine(n=2)
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8))
    assert batcher.submit(_pc(20), _pc(20)).wait(10).shape == (20, 3)
    assert all(set(r) == {"replica", "device_id", "in_flight",
                          "batches_total"}
               for r in batcher.replica_stats())
    batcher.shutdown(drain=True)


def test_wedge_fault_is_outside_the_replica_lock():
    """On a real (tiny, CPU) engine: while a dispatch is wedged by
    ``replica_wedge``, the replica's lock is free, so the probe's request
    runs; the wedge scan quarantines the replica; once the plan clears the
    wedged request gets its flow and the probe revives the replica."""
    import torch

    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    torch.set_num_threads(1)
    cfg = ServeConfig(model=ModelConfig(truncate_k=16, corr_knn=8,
                                        graph_k=4),
                      buckets=(32,), batch_sizes=(1,), num_iters=1,
                      dtype="float32", replicas=1)
    engine = InferenceEngine(seeded_state_dict(cfg.model, 0), cfg,
                             device="cpu")
    sup = ReplicaSupervisor(engine, cfg=_tight())
    batcher = MicroBatcher(
        engine, BatcherConfig(max_batch=1, max_wait_ms=0, queue_depth=8),
        supervisor=sup)
    faults.install_plan(FaultPlan([FaultRule("replica_wedge", nth=1,
                                             replica=0)]))
    req = (_pc(20), _pc(24, 1))
    h = batcher.submit(*req)
    assert _until(lambda: faults.plan_snapshot()["fired_total"] == 1)
    cloud, bucket = engine.probe_request()
    assert engine.replicas[0].predict_batch([(cloud, cloud)],
                                            bucket)[0].shape == (16, 3)
    assert _until(lambda: (sup._scan_wedged(), sup.state_of(0))[1]
                  == "quarantined")
    faults.clear_plan()
    np.testing.assert_array_equal(h.wait(30), engine.predict(*req))
    assert _until(lambda: (sup.poll(), sup.state_of(0))[1] == "healthy")
    batcher.shutdown(drain=True)
