"""The fleet acceptance of the port's serving tier: two port hosts
(``build_service`` on tiny CPU engines) behind the JAX package's
jax-free fleet router (``pvraft_tpu.fleet.build_fleet``), imported and
used as it is. Routing (least loaded, flows equal to the host engine's),
``/admin/reload`` fanned out with the digest changing on both hosts, and
a host whose fault plan quarantines its replica: its pool reads
``unavailable`` through the router, its 503s spill over to the other
host, and when it stops answering the router walks it through degraded
and quarantined, then probing and healthy once it serves again on the
same port. (The router's own states follow its ``/healthz`` polls, which
a quarantined pool still answers.)"""

import numpy as np
import pytest
import torch

from pvraft_tpu.fleet import FleetConfig, build_fleet
from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.engine.checkpoint import save_checkpoint
from pvraft_tpu_torch.serve import (
    FaultPlan,
    FaultRule,
    InferenceEngine,
    ServeConfig,
    SupervisorConfig,
    build_service,
    params_digest,
)
from pvraft_tpu_torch.serve import faults
from pvraft_tpu_torch.weights import params_to_jax, seeded_state_dict

TINY = ModelConfig(truncate_k=16, corr_knn=8, graph_k=4)
SERVE = ServeConfig(model=TINY, buckets=(32, 64), batch_sizes=(1,),
                    num_iters=2, dtype="float32", replicas=1)
# Host 1 runs no probe loop: its replica stays quarantined.
QUARANTINE = SupervisorConfig(degraded_after=1, quarantine_after=2,
                              probe_interval_s=0)


def _doc(n, seed):
    rng = np.random.default_rng(seed)
    return {"pc1": rng.uniform(-1, 1, (n, 3)).astype(np.float32).tolist(),
            "pc2": rng.uniform(-1, 1, (n, 3)).astype(np.float32).tolist()}


def _fleet_cfg():
    return FleetConfig(poll_interval_s=3600.0, poll_timeout_s=5.0,
                       degraded_after=1, quarantine_after=2,
                       retry_after_s=1, predict_timeout_s=30.0)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    faults.clear_plan()


@pytest.fixture()
def hosts():
    state = seeded_state_dict(TINY, 0)
    engines = [InferenceEngine(state, SERVE, device="cpu") for _ in range(2)]
    servers = [build_service(engines[0]),
               build_service(engines[1], supervisor_cfg=QUARANTINE)]
    for s in servers:
        s.start()
    router = build_fleet(servers, cfg=_fleet_cfg())
    router.start()
    yield state, engines, servers, router
    router.shutdown()
    for s in servers:
        s.shutdown(drain=True)


def test_router_routes_to_port_hosts(hosts):
    """The least-loaded host answers with its engine's flow, bitwise;
    the router's /healthz reads the hosts' weights and pool blocks."""
    state, engines, servers, router = hosts
    doc = _doc(20, 1)
    want = engines[0].predict(np.asarray(doc["pc1"], np.float32),
                              np.asarray(doc["pc2"], np.float32))
    status, body, _ = router.route_predict(doc)
    assert status == 200
    np.testing.assert_array_equal(np.asarray(body["flow"], np.float32), want)
    # A dispatch open on host 0 sends the next request to host 1.
    router.backends[0].begin_dispatch(0.0)
    try:
        status, body, _ = router.route_predict(_doc(40, 2))
    finally:
        router.backends[0].end_dispatch(0.0)
    assert status == 200 and len(body["flow"]) == 40
    snap = router.metrics.snapshot()
    assert snap["per_backend"]["0"]["responses"] == 1
    assert snap["per_backend"]["1"]["responses"] == 1
    assert [s.batcher.counts["served"] for s in servers] == [1, 1]
    router.poll_once()
    rows = router.health_doc()["backends"]
    assert [r["state"] for r in rows] == ["healthy", "healthy"]
    assert all(r["weights"]["digest"] == params_digest(state) for r in rows)
    assert all(r["pool"]["state"] == "ok" for r in rows)
    assert router.health_doc()["buckets"] == [32, 64]


def test_admin_reload_fans_out(hosts, tmp_path):
    state, engines, servers, router = hosts
    new = seeded_state_dict(TINY, 9)
    save_checkpoint(str(tmp_path), params_to_jax(new), {}, 6,
                    checkpoint_interval=0)
    ckpt = str(tmp_path / "last_checkpoint.msgpack")
    status, out = router.admin_reload_doc({"ckpt": ckpt})
    assert status == 200
    assert [r["backend"] for r in out["swapped"]] == [0, 1]
    for row in out["swapped"]:
        assert row["status"] == 200
        assert row["report"]["previous_digest"] == params_digest(state)
        assert row["report"]["digest"] == params_digest(new)
    for engine in engines:
        assert engine.weights_info() == {"path": ckpt,
                                         "digest": params_digest(new),
                                         "epoch": 6, "swaps": 1}
    router.poll_once()
    assert [r["weights"]["digest"] for r in router.health_doc()["backends"]] \
        == [params_digest(new)] * 2
    status, out = router.admin_reload_doc({"ckpt": str(tmp_path / "none")})
    assert status == 400


def test_quarantined_host_spills_over_then_walks_router_states(hosts):
    state, engines, servers, router = hosts
    faults.install_plan(FaultPlan([FaultRule(
        "replica_predict_error", nth=1, every=1, replica=0,
        max_fires=QUARANTINE.quarantine_after)]))
    host1 = router.backends[1].client
    for seed in range(QUARANTINE.quarantine_after):
        assert host1.predict(_doc(20, seed))["status"] == 500
    assert servers[1].supervisor.state_of(0) == "quarantined"
    assert faults.plan_snapshot()["fired_total"] == QUARANTINE.quarantine_after
    shed = host1.predict(_doc(20, 5))
    assert shed["status"] == 503 and shed["retry_after"] == 1
    assert shed["body"]["error"] == "unavailable"
    router.poll_once()
    rows = router.health_doc()["backends"]
    assert rows[1]["pool"]["state"] == "unavailable"
    assert rows[0]["pool"]["state"] == "ok"
    # Host 1 first in line: its 503 spills the request over to host 0.
    router.backends[0].begin_dispatch(0.0)
    try:
        status, body, _ = router.route_predict(_doc(20, 6))
    finally:
        router.backends[0].end_dispatch(0.0)
    assert status == 200 and router.metrics.snapshot()["spillovers_total"] == 1
    # The quarantined host goes down: degraded, then quarantined.
    port = servers[1].port
    servers[1].shutdown(drain=True)
    router.poll_once()
    assert router.backends[1].state == "degraded"
    assert router.backends[1].in_rotation
    router.poll_once()
    assert router.backends[1].state == "quarantined"
    assert router.health_doc()["status"] == "degraded"
    for seed in range(3):
        assert router.route_predict(_doc(20, 10 + seed))[0] == 200
    # Served again on the same port: the next poll probes the host and
    # readmits it.
    faults.clear_plan()
    servers[1] = build_service(engines[1], port=port,
                               supervisor_cfg=QUARANTINE)
    servers[1].start()
    router.poll_once()
    assert router.backends[1].state == "healthy"
    assert router.health_doc()["status"] == "ok"
    assert host1.predict(_doc(20, 20))["status"] == 200
