"""The model levers of the port against the JAX package's, on the CPU.

``corr_chunk`` and ``graph_chunk`` (the streaming top-k of
``ops/corr.py::corr_init`` and ``ops/geometry.py::knn_indices``) against
JAX's chunked scans and the port's own dense paths, values and indices,
on tie-free inputs (continuous random coordinates and features); their
fallback and error cases (``tests/test_corr.py``,
``tests/test_geometry.py``) parametrised over port and JAX, in JAX's
order; ``approx_topk``/``approx_knn`` (exact in the port, as
``lax.approx_max_k`` is off the TPU) against JAX's ``approx_max_k``;
every remat policy's gradients bitwise equal to no remat in the port and
within the bars of ``tests/test_torch_grad.py`` (cosine >= 0.9999,
relative error <= 1e-3) of JAX's under the same policy; and the masked
serve path with ``corr_chunk``, which raises for a bucket larger than the
chunk and passes for one the chunk covers, as JAX's does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.engine.loss import sequence_loss as jsequence_loss
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.ops import corr as jcorr
from pvraft_tpu.ops import geometry as jgeo
from pvraft_tpu_torch.config import REMAT_POLICIES
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.data import SyntheticDataset, collate
from pvraft_tpu_torch.engine.loss import sequence_loss
from pvraft_tpu_torch.models import PVRaft as TRaft
from pvraft_tpu_torch.ops import corr as tcorr
from pvraft_tpu_torch.ops import geometry as tgeo
from pvraft_tpu_torch.serve import InferenceEngine as TEngine
from pvraft_tpu_torch.serve import ServeConfig as TServeConfig
from pvraft_tpu_torch.weights import params_from_jax, params_to_jax
from pvraft_tpu_torch.weights import seeded_state_dict

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
B, N, ITERS, GAMMA = 2, 48, 2, 0.8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _corr_inputs(seed, n1=24, n2=64, d=16, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n1, d)).astype(np.float32),
            rng.normal(size=(b, n2, d)).astype(np.float32),
            rng.normal(size=(b, n2, 3)).astype(np.float32))


def _jcorr(f1, f2, x2, k, **kw):
    out = jcorr.corr_init(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(x2),
                          k, **kw)
    return np.asarray(out.corr), np.asarray(out.xyz)


def _tcorr(f1, f2, x2, k, **kw):
    out = tcorr.corr_init(_t(f1), _t(f2), _t(x2), k, **kw)
    return out.corr.numpy(), out.xyz.numpy()


# --- corr_chunk ---------------------------------------------------------------


@pytest.mark.parametrize("k,chunk", [(16, 16), (16, 8), (4, 32), (24, 16)])
def test_chunked_corr_init_matches_jax_and_dense(k, chunk):
    """Values and the selected candidates' xyz: the port's chunked path
    bitwise equal to its dense path, and within float32 rounding of JAX's
    chunked scan (JAX scales by 1/sqrt(D), the port divides, as both
    dense paths do), the same candidates in the same order."""
    f1, f2, x2 = _corr_inputs(k + chunk)
    got = _tcorr(f1, f2, x2, k, chunk=chunk)
    dense = _tcorr(f1, f2, x2, k)
    want = _jcorr(f1, f2, x2, k, chunk=chunk)
    np.testing.assert_array_equal(got[0], dense[0])
    np.testing.assert_array_equal(got[1], dense[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])


def test_chunked_corr_init_gradient_reaches_both_feature_maps():
    """The gradient reaches ``fmap1`` and ``fmap2`` through the selected
    values, as JAX's scan does (``jax.grad`` of the same sum)."""
    f1, f2, x2 = _corr_inputs(5)
    a, b = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    tcorr.corr_init(a, b, _t(x2), 8, chunk=16).corr.sum().backward()
    ja, jb = jax.grad(lambda p, q: jcorr.corr_init(
        p, q, jnp.asarray(x2), 8, chunk=16).corr.sum(), argnums=(0, 1))(
            jnp.asarray(f1), jnp.asarray(f2))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb), atol=1e-5)
    assert float(b.grad.abs().sum()) > 0


CORR_CASES = [
    # (kwargs, M, the error's match or None where it passes)
    ({"k": 80}, 64, "truncate_k"),
    ({"k": 8, "approx": True, "valid2": True}, 64, "approx"),
    ({"k": 8, "approx": True, "chunk": 16}, 64, "approx_topk"),
    ({"k": 8, "approx": True, "chunk": 128}, 64, "approx_topk"),
    ({"k": 8, "chunk": 64, "valid2": True}, 64, None),
    ({"k": 8, "chunk": 128}, 64, None),
    ({"k": 8, "chunk": 16, "valid2": True}, 64, "valid2"),
    ({"k": 8, "chunk": 24}, 64, "divide"),
]


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("case", range(len(CORR_CASES)))
def test_corr_init_errors_and_fallbacks_match_jax(side, case):
    """JAX's checks in JAX's order: ``truncate_k > M``; ``valid2`` with
    ``approx``; ``approx`` with ``chunk`` before the size fallback;
    ``chunk >= M`` takes the dense path; ``valid2`` with a chunk still in
    force; ``M % chunk``. Where a case passes, it equals the dense path."""
    kw, m, match = CORR_CASES[case]
    kw = dict(kw)
    k = kw.pop("k")
    f1, f2, x2 = _corr_inputs(case, n2=m)
    if kw.pop("valid2", False):
        kw["valid2"] = np.ones((2, m), bool)
    run = _tcorr if side == "port" else _jcorr
    if side == "port" and "valid2" in kw:
        kw["valid2"] = _t(kw["valid2"])
    elif "valid2" in kw:
        kw["valid2"] = jnp.asarray(kw["valid2"])
    if match is not None:
        with pytest.raises(ValueError, match=match):
            run(f1, f2, x2, k, **kw)
        return
    got, dense = run(f1, f2, x2, k, **kw), run(f1, f2, x2, k)
    np.testing.assert_array_equal(got[0], dense[0])
    np.testing.assert_array_equal(got[1], dense[1])


# --- graph_chunk --------------------------------------------------------------


@pytest.mark.parametrize("nq,np_,k,chunk", [(24, 48, 6, 16), (48, 48, 8, 8),
                                            (10, 64, 12, 4), (32, 96, 5, 32)])
def test_chunked_knn_matches_jax_and_dense(nq, np_, k, chunk):
    rng = np.random.default_rng(nq + np_ + k)
    q = rng.normal(size=(2, nq, 3)).astype(np.float32)
    p = rng.normal(size=(2, np_, 3)).astype(np.float32)
    got = tgeo.knn_indices(_t(q), _t(p), k, chunk=chunk).numpy()
    np.testing.assert_array_equal(got, tgeo.knn_indices(_t(q), _t(p),
                                                        k).numpy())
    np.testing.assert_array_equal(got, np.asarray(jgeo.knn_indices(
        jnp.asarray(q), jnp.asarray(p), k, chunk=chunk)))


KNN_CASES = [
    ({"chunk": 16, "approx": True}, "approx"),
    ({"chunk": 128, "approx": True}, "approx"),
    ({"chunk": 64}, None),
    ({"chunk": 128}, None),
    ({"chunk": 24}, "divide"),
]


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("case", range(len(KNN_CASES)))
def test_knn_errors_and_fallbacks_match_jax(side, case):
    """``approx`` with ``chunk`` refused whatever the size; ``chunk >= M``
    takes the dense path; ``M % chunk`` raises (``tests/test_geometry.py``)."""
    kw, match = KNN_CASES[case]
    pc = np.random.default_rng(case).normal(size=(1, 64, 3)).astype(
        np.float32)
    if side == "port":
        run = lambda **a: tgeo.knn_indices(_t(pc), _t(pc), 6, **a).numpy()
    else:
        run = lambda **a: np.asarray(jgeo.knn_indices(
            jnp.asarray(pc), jnp.asarray(pc), 6, **a))
    if match is not None:
        with pytest.raises(ValueError, match=match):
            run(**kw)
        return
    np.testing.assert_array_equal(run(**kw), run())


# --- approx_topk / approx_knn ------------------------------------------------


def test_approx_topk_equals_jax_approx_max_k():
    """The port computes the exact top-k for ``approx``; XLA computes
    ``lax.approx_max_k`` exactly on the CPU, so the two agree: the same
    candidates, values within rounding."""
    f1, f2, x2 = _corr_inputs(11, n2=96)
    got = _tcorr(f1, f2, x2, 16, approx=True)
    want = _jcorr(f1, f2, x2, 16, approx=True)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], _tcorr(f1, f2, x2, 16)[0])


def test_approx_knn_equals_jax_approx_max_k():
    pc = np.random.default_rng(12).uniform(-1, 1, (2, 96, 3)).astype(
        np.float32)
    got = tgeo.build_graph(_t(pc), 8, approx=True)
    want = jgeo.build_graph(jnp.asarray(pc), 8, approx=True)
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))
    np.testing.assert_allclose(got.rel_pos.numpy(), np.asarray(want.rel_pos),
                               atol=1e-6)


# --- the levers through the model ---------------------------------------------


def _batch(seed):
    ds = SyntheticDataset(size=B, nb_points=N, noise=0.01, seed=seed,
                          n_objects=2)
    return collate([ds[i] for i in range(B)])


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights and the same as a JAX variables tree."""
    state = seeded_state_dict(TConfig(**TINY), 0)
    return state, jax.tree_util.tree_map(jnp.asarray, params_to_jax(state))


@pytest.mark.parametrize("kw", [{"corr_chunk": 16}, {"graph_chunk": 16},
                                {"corr_chunk": 16, "graph_chunk": 8},
                                {"approx_topk": True, "approx_knn": True}])
def test_model_levers_flows_match_jax_and_dense(weights, kw):
    """Flows through the port's model with the lever equal its dense
    flows to float32 rounding, and JAX's with the same lever at the model
    bar of ``tests/test_torch_model.py`` (2e-4)."""
    state, variables = weights
    batch = _batch(3)
    model = TRaft(TConfig(**TINY, **kw))
    model.load_state_dict(state)
    dense = TRaft(TConfig(**TINY))
    dense.load_state_dict(state)
    with torch.no_grad():
        got = model(_t(batch["pc1"]), _t(batch["pc2"]), ITERS)[0]
        ref = dense(_t(batch["pc1"]), _t(batch["pc2"]), ITERS)[0]
    want, _ = jax.jit(lambda v, a, b: JRaft(JConfig(**TINY, **kw)).apply(
        v, a, b, ITERS))(variables, jnp.asarray(batch["pc1"]),
                         jnp.asarray(batch["pc2"]))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def _port_grads(state, batch, **kw):
    model = TRaft(TConfig(**TINY, **kw))
    model.load_state_dict(state)
    flows, _ = model(_t(batch["pc1"]), _t(batch["pc2"]), ITERS)
    loss = sequence_loss(flows, _t(batch["mask"]), _t(batch["flow"]), GAMMA)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("fused_gru", [False, True])
@pytest.mark.parametrize("policy", REMAT_POLICIES[1:])
def test_remat_gradients_bitwise_equal_no_remat(weights, policy, fused_gru):
    """Each policy recomputes (or keeps) exactly what the forward computed,
    and the backward runs the same operations in the same order: the
    loss and every gradient bitwise equal to no remat's. ``remat=True``
    is "full"."""
    state, _ = weights
    batch = _batch(4)
    want = _port_grads(state, batch, fused_gru=fused_gru)
    for kw in ({"remat_policy": policy},) + (
            ({"remat": True},) if policy == "full" else ()):
        got = _port_grads(state, batch, fused_gru=fused_gru, **kw)
        assert got[0] == want[0]
        for name, g in want[1].items():
            assert torch.equal(got[1][name], g), (kw, name)


def test_remat_changes_nothing_without_autograd(weights):
    """Under ``no_grad`` (serving, evaluation, the stage-2 backbone) no
    checkpoint runs: flows bitwise equal to no remat's."""
    state, _ = weights
    batch = _batch(5)
    flows = {}
    for policy in REMAT_POLICIES:
        model = TRaft(TConfig(**TINY, remat_policy=policy))
        model.load_state_dict(state)
        with torch.no_grad():
            flows[policy] = model(_t(batch["pc1"]), _t(batch["pc2"]),
                                  ITERS)[0]
    for policy in REMAT_POLICIES[1:]:
        assert torch.equal(flows[policy], flows["none"]), policy


def _leaf_stats(got, want):
    a = got.double().flatten()
    b = torch.from_numpy(np.asarray(want, np.float64)).flatten()
    na, nb = a.norm(), b.norm()
    if na == 0 and nb == 0:
        return 1.0, 0.0
    return float(a @ b / (na * nb)), float((a - b).norm() / nb)


@pytest.mark.parametrize("policy", REMAT_POLICIES[1:])
def test_remat_gradients_match_jax_under_the_same_policy(weights, policy):
    """The port's gradients under each policy against ``jax.grad`` of the
    JAX model under the same ``remat_policy`` (its ``nn.remat`` with
    ``jax.checkpoint`` policies), at ``tests/test_torch_grad.py``'s bars:
    loss atol 1e-5, cosine >= 0.9999, relative error <= 1e-3."""
    state, variables = weights
    batch = _batch(6)
    model = JRaft(JConfig(use_pallas=False, remat_policy=policy, **TINY))

    def loss_fn(v):
        flows, _ = model.apply(v, jnp.asarray(batch["pc1"]),
                               jnp.asarray(batch["pc2"]), ITERS)
        return jsequence_loss(flows, jnp.asarray(batch["mask"]),
                              jnp.asarray(batch["flow"]), GAMMA)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    loss, grads = _port_grads(state, batch, remat_policy=policy)
    assert abs(loss - float(jloss)) <= 1e-5
    want = params_from_jax(jgrads)
    assert set(want) == set(grads)
    for name, g in grads.items():
        cos, rel = _leaf_stats(g, want[name])
        assert cos >= 0.9999 and rel <= 1e-3, (name, cos, rel)


# --- serving with corr_chunk --------------------------------------------------


SERVE = {"batch_sizes": (1,), "num_iters": 2, "dtype": "float32",
         "replicas": 1}


@pytest.mark.parametrize("bucket,raises", [(32, False), (64, True)])
def test_masked_path_with_corr_chunk_matches_jax(weights, bucket, raises):
    """``corr_chunk`` with the serve masks: the chunk covers a 32-point
    bucket, so the dense path runs (flows as without the chunk); a
    64-point bucket keeps the chunk in force, and the masked truncation
    raises, in the port's model and engine as in JAX's model."""
    state, variables = weights
    rng = np.random.default_rng(bucket)
    pc1 = rng.uniform(-1, 1, (1, bucket, 3)).astype(np.float32)
    pc2 = rng.uniform(-1, 1, (1, bucket, 3)).astype(np.float32)
    valid = np.ones((1, bucket), bool)
    valid[:, -4:] = False
    pc1[:, -4:] += 50.0
    pc2[:, -4:] += 50.0
    jcfg = JConfig(**TINY, corr_chunk=32)
    jrun = jax.jit(lambda v, a, b, m: JRaft(jcfg).apply(v, a, b, ITERS, m, m))
    model = TRaft(TConfig(**TINY, corr_chunk=32))
    model.load_state_dict(state)
    engine = TEngine(state, TServeConfig(model=TConfig(**TINY, corr_chunk=32),
                                         buckets=(bucket,), **SERVE),
                     device="cpu")
    tin = (_t(pc1), _t(pc2), ITERS, _t(valid), _t(valid))
    request = (pc1[0, :-4], pc2[0, :-4])
    if raises:
        with pytest.raises(ValueError, match="corr_chunk"):
            jrun(variables, pc1, pc2, valid)
        with pytest.raises(ValueError, match="corr_chunk"), torch.no_grad():
            model(*tin)
        with pytest.raises(ValueError, match="corr_chunk"):
            engine.predict(*request)
        return
    want, _ = jrun(variables, pc1, pc2, valid)
    with torch.no_grad():
        got = model(*tin)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    dense = TEngine(state, TServeConfig(model=TConfig(**TINY),
                                        buckets=(bucket,), **SERVE),
                    device="cpu")
    np.testing.assert_array_equal(engine.predict(*request),
                                  dense.predict(*request))
