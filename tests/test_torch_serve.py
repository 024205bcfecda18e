"""The port's InferenceEngine against the JAX package's, at the tiny
serve geometry of ``tests/test_serve.py`` (buckets (32, 64), one batch
size of 2, fp32), on the same weights and requests: padded buckets,
validity masks and the filled batch slot. Flows agree to 2e-4 (the
JAX-vs-torch model bar; 2 iterations). At the default serving dtype,
bfloat16: the JAX package's accuracy gate of bf16 against fp32 serving
on its own geometry (``tests/test_serve_pool.py``), and the port's bf16
flows against the JAX engine's at 1 iteration at the JAX model-level
bf16 bar (rtol 0.05 / atol 0.03). Concurrent callers: eight threads'
flows equal the serial flows of the same requests bitwise."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.serve import InferenceEngine as JEngine
from pvraft_tpu.serve import RequestError as JRequestError
from pvraft_tpu.serve import ServeConfig as JServeConfig
from pvraft_tpu.serve.engine import pad_points as jpad_points
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.serve import InferenceEngine as TEngine
from pvraft_tpu_torch.serve import RequestError as TRequestError
from pvraft_tpu_torch.serve import ServeConfig as TServeConfig
from pvraft_tpu_torch.serve import pad_points as tpad_points
from pvraft_tpu_torch.serve import engine as tengine
from pvraft_tpu_torch.weights import seeded_state_dict

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 4}
SERVE = {"buckets": (32, 64), "batch_sizes": (2,), "num_iters": 2,
         "dtype": "float32", "replicas": 1}


def _cloud(rng, n):
    return rng.uniform(-1, 1, (n, 3)).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def variables():
    """The JAX serve tests' weights (``tests/test_serve_pool.py::pool``)."""
    rng = np.random.default_rng(0)
    pc = jnp.asarray(_cloud(rng, 24)[None])
    return jax.jit(JRaft(JConfig(**TINY)).init, static_argnums=3)(
        jax.random.key(0), pc, pc, 2)


@pytest.fixture(scope="module")
def engines(variables):
    jeng = JEngine(variables, JServeConfig(model=JConfig(**TINY), **SERVE))
    teng = TEngine(variables, TServeConfig(model=TConfig(**TINY), **SERVE),
                   device="cpu")
    return jeng, teng


def test_predict_and_predict_batch_match_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(1)
    # A padded single request (slot fill), an exact bucket fit, and a
    # two-request batch with n1 != n2 in the larger bucket.
    single = (_cloud(rng, 20), _cloud(rng, 24))
    exact = (_cloud(rng, 32), _cloud(rng, 32))
    pair = [(_cloud(rng, 40), _cloud(rng, 52)), (_cloud(rng, 60), _cloud(rng, 33))]
    for pc1, pc2 in (single, exact):
        want, got = jeng.predict(pc1, pc2), teng.predict(pc1, pc2)
        assert got.shape == (pc1.shape[0], 3) and got.dtype == np.float32
        np.testing.assert_allclose(want, got, rtol=0, atol=2e-4)
    assert teng.validate_request(*pair[0]) == jeng.validate_request(*pair[0]) == 64
    want = jeng.predict_batch(pair, 64)
    got = teng.predict_batch(pair, 64)
    assert [g.shape for g in got] == [(40, 3), (60, 3)]
    for w, g in zip(want, got):
        np.testing.assert_allclose(w, g, rtol=0, atol=2e-4)
    # A request's flow does not depend on its batch mate.
    alone = teng.predict_batch(pair[:1], 64)[0]
    np.testing.assert_allclose(alone, got[0], rtol=0, atol=1e-5)


def test_request_contract_matches_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(2)
    ok = _cloud(rng, 20)
    bad = [
        (_cloud(rng, 10), ok, "too_small"),
        (_cloud(rng, 65), ok, "too_large"),
        (ok * 200, ok, "bad_request"),
        (np.full((20, 3), np.nan, np.float32), ok, "bad_request"),
        (ok[:, :2], ok, "bad_request"),
    ]
    for pc1, pc2, reason in bad:
        with pytest.raises(JRequestError) as je:
            jeng.validate_request(pc1, pc2)
        with pytest.raises(TRequestError) as te:
            teng.validate_request(pc1, pc2)
        assert je.value.reason == te.value.reason == reason
    for n in (1, 2, 3):
        assert teng.batch_size_for(n) == jeng.batch_size_for(n)
    for n in (16, 32, 33, 64, 65):
        assert teng.bucket_for(n) == jeng.bucket_for(n)


def test_pad_points_matches_jax():
    pc = _cloud(np.random.default_rng(3), 20)
    np.testing.assert_array_equal(jpad_points(pc, 32, 100.0),
                                  tpad_points(pc, 32, 100.0))


def test_engine_needs_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(tengine.torch.cuda, "is_available", lambda: False)
    cfg = TServeConfig(model=TConfig(**TINY), **SERVE)
    weights = seeded_state_dict(cfg.model, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(weights, cfg)
    assert TEngine(weights, cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("kw", [
    {"dtype": "float16"}, {"buckets": ()}, {"buckets": (64, 32)},
    {"batch_sizes": ()}, {"batch_sizes": (2, 2)}, {"coord_limit": 0.0},
    {"buckets": (2, 64)}, {"replicas": -1},
])
def test_serve_config_rejects_like_jax(kw):
    base = {"buckets": (32, 64), **kw}
    with pytest.raises(ValueError):
        JServeConfig(model=JConfig(**TINY), **base)
    with pytest.raises(ValueError):
        TServeConfig(model=TConfig(**TINY), **base)


def test_serve_config_defaults_are_the_flagship_table():
    cfg = TServeConfig()
    assert cfg.buckets == (2048, 4096, 8192)
    assert cfg.batch_sizes == (1, 4)
    assert cfg.num_iters == 8 and cfg.coord_limit == 100.0
    assert cfg.model == TConfig()
    jcfg = JServeConfig()
    assert (jcfg.buckets, jcfg.batch_sizes, jcfg.num_iters) == \
        (cfg.buckets, cfg.batch_sizes, cfg.num_iters)
    # Both serve bf16 by default, one replica per device.
    assert cfg.dtype == jcfg.dtype == "bfloat16"
    assert (jcfg.replicas, cfg.replicas) == (0, 0)


def test_bf16_default_within_the_jax_serve_bound(variables):
    """The gate the JAX package's bf16 default rides on
    (``tests/test_serve_pool.py::test_bf16_default_within_pinned_accuracy_bound``),
    on its geometry, for the port: bf16 against fp32 serving of the same
    weights, mean EPE <= SERVE_BF16_EPE_BOUND and relative to the mean
    fp32 flow magnitude <= SERVE_BF16_REL_EPE_BOUND; the flow stays
    float32 and the programs are named by dtype. Measured: mean EPE
    0.034, relative 0.032 (the JAX package's own: ~0.033 / ~0.047)."""
    serve = dict(model=TConfig(**TINY), buckets=(32,), batch_sizes=(1,),
                 num_iters=2)
    bf16 = TEngine(variables, TServeConfig(**serve), device="cpu")
    f32 = TEngine(variables, TServeConfig(dtype="float32", **serve),
                  device="cpu")
    assert bf16.cfg.dtype == "bfloat16"
    assert [r["name"] for r in bf16.compile_report()] == \
        ["predict_bf16_b32_bs1"]
    rng = np.random.default_rng(3)
    epe, mag = [], []
    for n in (18, 24, 32):
        pc1, pc2 = _cloud(rng, n), _cloud(rng, n)
        want, got = f32.predict(pc1, pc2), bf16.predict(pc1, pc2)
        assert got.dtype == np.float32
        epe.append(np.linalg.norm(got - want, axis=1).mean())
        mag.append(np.linalg.norm(want, axis=1).mean())
    mean_epe = float(np.mean(epe))
    assert mean_epe <= tengine.SERVE_BF16_EPE_BOUND, epe
    assert mean_epe / float(np.mean(mag)) <= \
        tengine.SERVE_BF16_REL_EPE_BOUND, (mean_epe, mag)


def test_bf16_serving_matches_jax_at_one_iteration(variables):
    """Port and JAX engines at their bf16 default, padded buckets and a
    filled batch slot, 1 iteration: the JAX model-level bf16 bar
    (measured 0.011 at worst)."""
    serve = dict(buckets=(32, 64), batch_sizes=(2,), num_iters=1)
    jeng = JEngine(variables, JServeConfig(model=JConfig(**TINY),
                                           dtype="bfloat16", replicas=1,
                                           **serve))
    teng = TEngine(variables, TServeConfig(model=TConfig(**TINY), **serve),
                   device="cpu")
    rng = np.random.default_rng(4)
    pair = [(_cloud(rng, 40), _cloud(rng, 52)),
            (_cloud(rng, 60), _cloud(rng, 33))]
    for want, got in zip(jeng.predict_batch(pair, 64),
                         teng.predict_batch(pair, 64)):
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.03)
    pc1, pc2 = _cloud(rng, 20), _cloud(rng, 24)
    np.testing.assert_allclose(teng.predict(pc1, pc2), jeng.predict(pc1, pc2),
                               rtol=0.05, atol=0.03)


# The engine under concurrent load: random weights at truncate_k 32,
# graph_k 8, corr_knn 8, one bucket of 512 at batch size 1, 2 iterations.
LOAD = {"threads": 8, "calls": 3}
LOAD_MODEL = {"truncate_k": 32, "graph_k": 8, "corr_knn": 8}
LOAD_SERVE = {"buckets": (512,), "batch_sizes": (1,), "num_iters": 2,
              "dtype": "float32"}


def test_concurrent_requests_get_their_own_flows():
    """Eight threads call ``predict`` three times each, each on its own
    request of 400-470 points, started together: every flow equals the
    serial flow of the same request bitwise. (Without the engine's lock
    the threads overwrite each other's static inputs and outputs.)"""
    cfg = TServeConfig(model=TConfig(**LOAD_MODEL), **LOAD_SERVE)
    engine = TEngine(seeded_state_dict(cfg.model, 0), cfg, device="cpu")
    rng = np.random.default_rng(5)
    requests = []
    for _ in range(LOAD["threads"]):
        n1, n2 = rng.integers(400, 471, size=2)
        requests.append((_cloud(rng, n1), _cloud(rng, n2)))
    serial = [engine.predict(*r) for r in requests]
    got = [[] for _ in requests]
    start = threading.Barrier(len(requests))

    def serve(i):
        start.wait()
        for _ in range(LOAD["calls"]):
            got[i].append(engine.predict(*requests[i]))

    threads = [threading.Thread(target=serve, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, want in enumerate(serial):
        assert len(got[i]) == LOAD["calls"]
        for flow in got[i]:
            np.testing.assert_array_equal(flow, want, err_msg=f"thread {i}")
