"""The port's InferenceEngine against the JAX package's, at the tiny
serve geometry of ``tests/test_serve.py`` (buckets (32, 64), one batch
size of 2, fp32), on the same weights and requests: padded buckets,
validity masks and the filled batch slot. Flows agree to 2e-4 (the
JAX-vs-torch model bar; 2 iterations)."""

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
def engines():
    rng = np.random.default_rng(0)
    pc = jnp.asarray(_cloud(rng, 24)[None])
    variables = jax.jit(JRaft(JConfig(**TINY)).init, static_argnums=3)(
        jax.random.key(0), pc, pc, 2)
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


@pytest.mark.parametrize("kw", [{"dtype": "bfloat16"}, {"replicas": 2},
                                {"refine": True}])
def test_serve_config_rejects_later_slices(kw):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TServeConfig(model=TConfig(**TINY), buckets=(32, 64), **kw)


def test_serve_config_defaults_are_the_flagship_table():
    cfg = TServeConfig()
    assert cfg.buckets == (2048, 4096, 8192)
    assert cfg.batch_sizes == (1, 4)
    assert cfg.num_iters == 8 and cfg.coord_limit == 100.0
    assert cfg.model == TConfig()
    jcfg = JServeConfig()
    assert (jcfg.buckets, jcfg.batch_sizes, jcfg.num_iters) == \
        (cfg.buckets, cfg.batch_sizes, cfg.num_iters)
