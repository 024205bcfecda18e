"""Gradients of the port against the JAX package's, on the CPU.

Each kernel's ``torch.autograd.Function`` runs here with its plain
forward and the hand-written backward that also runs on the card; its
backward is held against ``jax.vjp`` of the JAX kernel (Pallas in
interpret mode, as the JAX package's own tests run it) at the
tolerances of ``tests/test_pallas_fused.py`` (1e-4) and
``tests/test_pallas_voxel.py`` (1e-4); the GRU's at 1e-6 against the
port's own plain autograd and 1e-5 against JAX (the reason is in its
test). The whole train step's loss and per-leaf gradients are held
against ``jax.value_and_grad`` of ``make_train_step``'s loss at the bars
of ``artifacts/grad_parity.json`` (loss atol 1e-5, cosine >= 0.9999,
relative error <= 1e-3), with the Functions (``use_pallas=True``) and
without, ``fused_gru`` both ways; two coupled Adam steps at atol 2*lr.
The JAX side runs its XLA path (``use_pallas=False``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.engine.loss import sequence_loss as jsequence_loss
from pvraft_tpu.engine.schedule import make_lr_schedule as jschedule
from pvraft_tpu.engine.steps import make_train_step as jmake_train_step
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.ops.pallas import corr_lookup as jlookup
from pvraft_tpu.ops.pallas import gru_iter as jgru
from pvraft_tpu.ops.pallas import voxel_corr as jvoxel
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.data import SyntheticDataset, collate, to_device
from pvraft_tpu_torch.engine.schedule import make_lr_schedule
from pvraft_tpu_torch.engine.steps import make_train_step
from pvraft_tpu_torch.models import PVRaft as TRaft
from pvraft_tpu_torch.ops.cuda import corr_lookup as tlookup
from pvraft_tpu_torch.ops.cuda import gru_iter as tgru
from pvraft_tpu_torch.ops.cuda import voxel_corr as tvoxel
from pvraft_tpu_torch.ops.voxel import voxel_bin_means
from pvraft_tpu_torch.weights import params_from_jax

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
B, N, ITERS, GAMMA, LR = 2, 48, 2, 0.8, 1e-3
GEO = (3, 0.25, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lookup_inputs(seed, b=2, n=24, k=32):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    xyz = (coords[:, :, None, :]
           + rng.normal(0, 0.6, (b, n, k, 3))).astype(np.float32)
    corr = rng.normal(size=(b, n, k)).astype(np.float32)
    return corr, xyz, coords, rng


# --- each Function: CPU forward = plain version, output has a grad_fn -------


def test_functions_forward_equals_plain_and_records_a_graph():
    corr, xyz, coords, _ = _lookup_inputs(0)
    c = _t(corr).requires_grad_()
    got = tlookup.fused_corr_lookup(c, _t(xyz), _t(coords), *GEO, 8)
    want = tlookup.corr_lookup_plain(_t(corr), _t(xyz), _t(coords), *GEO, 8)
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)
    assert got[0].grad_fn is not None and got[1].grad_fn is not None
    assert not got[3].requires_grad                  # indices: no gradient

    rel = _t(xyz - coords[:, :, None, :])
    vox = tvoxel.voxel_bin_means_pallas(c, rel, *GEO)
    assert torch.equal(vox.detach(), voxel_bin_means(_t(corr), rel, *GEO))
    assert vox.grad_fn is not None

    me, gru, net, inp, cor, flow = _gru_inputs(1, n=20)
    raw = [_t(a).requires_grad_() for a in (*me, *gru)]
    w = tgru.pack_gru_weights(raw[:6], raw[6:], 64, 64)
    args = (_t(net), _t(inp), _t(cor), tgru.pad_flow(_t(flow)))
    out = tgru.fused_gru_update(*args, w)
    assert torch.equal(out.detach(), tgru.gru_math(*args, w).detach())
    assert out.grad_fn is not None
    before = (tlookup.fused_corr_lookup.launches,
              tvoxel.voxel_bin_means_pallas.launches,
              tgru.fused_gru_update.launches)
    out.sum().backward()
    assert all(r.grad is not None for r in raw)
    assert before == (tlookup.fused_corr_lookup.launches,
                      tvoxel.voxel_bin_means_pallas.launches,
                      tgru.fused_gru_update.launches)


# --- backward passes against jax.vjp ----------------------------------------


def test_lookup_backward_matches_jax_vjp():
    corr, xyz, coords, rng = _lookup_inputs(2)
    knn = 8
    jargs = (jnp.asarray(corr), jnp.asarray(xyz), jnp.asarray(coords))
    out, vjp = jax.vjp(lambda c: jlookup.fused_corr_lookup(
        c, jargs[1], jargs[2], *GEO, knn), jargs[0])
    cots = tuple(rng.normal(size=o.shape).astype(np.float32) for o in out)
    want, = vjp(tuple(jnp.asarray(g) for g in cots))
    c = _t(corr).requires_grad_()
    got = tlookup.fused_corr_lookup(c, _t(xyz), _t(coords), *GEO, knn)
    torch.autograd.backward(got[:3], [_t(g) for g in cots])
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want), atol=1e-4)


def test_voxel_backward_matches_jax_vjp():
    corr, xyz, coords, rng = _lookup_inputs(3)
    rel = (xyz - coords[:, :, None, :]).astype(np.float32)
    out, vjp = jax.vjp(lambda c: jvoxel.voxel_bin_means_pallas(
        c, jnp.asarray(rel), *GEO), jnp.asarray(corr))
    g = rng.normal(size=out.shape).astype(np.float32)
    want, = vjp(jnp.asarray(g))
    c = _t(corr).requires_grad_()
    r = _t(rel).requires_grad_()
    tvoxel.voxel_bin_means_pallas(c, r, *GEO).backward(_t(g))
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want), atol=1e-4)
    assert r.grad is None                            # rel gets no gradient


def _gru_inputs(seed, n=37):
    rng = np.random.default_rng(seed)
    h = c = d = 64

    def a(*s):
        return (0.3 * rng.normal(size=s)).astype(np.float32)

    me = (a(d, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3))
    gru = (a(2 * h + c, h), a(h), a(2 * h + c, h), a(h), a(2 * h + c, h), a(h))
    net = np.tanh(rng.normal(size=(2, n, h))).astype(np.float32)
    inp = np.abs(rng.normal(size=(2, n, c))).astype(np.float32)
    cor = rng.normal(size=(2, n, d)).astype(np.float32)
    flow = rng.normal(size=(2, n, 3)).astype(np.float32)
    return me, gru, net, inp, cor, flow


def test_gru_backward_matches_jax_vjp():
    # Two bars. The Function's backward against autograd through the
    # port's own plain version, same arithmetic: 1e-6, the bar of
    # tests/test_fused_gru.py (which holds two JAX paths of identical
    # arithmetic). Against jax.vjp the fp32 matmuls of the two frameworks
    # sum in another order: measured up to 2.8e-6 at width 64, so that
    # comparison keeps the cross-framework forward bar of this op, 1e-5
    # (tests/test_torch_kernels_ref.py).
    me, gru, net, inp, cor, flow = _gru_inputs(4)
    jw = jgru.pack_gru_weights(tuple(map(jnp.asarray, me)),
                               tuple(map(jnp.asarray, gru)), 64, 64)
    jargs = (jnp.asarray(net), jnp.asarray(inp), jnp.asarray(cor),
             jgru.pad_flow(jnp.asarray(flow)), jw)
    out, vjp = jax.vjp(lambda *x: jgru.fused_gru_update(*x, "float32", 512),
                       *jargs)
    g = np.random.default_rng(5).normal(size=out.shape).astype(np.float32)
    want = jax.tree_util.tree_leaves(vjp(jnp.asarray(g)))
    tw = tgru.pack_gru_weights(tuple(map(_t, me)), tuple(map(_t, gru)), 64, 64)
    leaves = (_t(net), _t(inp), _t(cor), tgru.pad_flow(_t(flow)), *tw)
    got = []
    for fn in (tgru.fused_gru_update, tgru.gru_math):
        xs = [t.clone().requires_grad_() for t in leaves]
        fn(*xs[:4], tuple(xs[4:])).backward(_t(g))
        got.append([x.grad.numpy() for x in xs])
    assert len(want) == len(got[0]) == 12
    for w, fn_grad, plain_grad in zip(want, *got):
        np.testing.assert_allclose(fn_grad, plain_grad, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(fn_grad, np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# --- the whole train step ---------------------------------------------------


def _batch(seed):
    ds = SyntheticDataset(size=B, nb_points=N, noise=0.01, seed=seed,
                          n_objects=2)
    return collate([ds[i] for i in range(B)])


@pytest.fixture(scope="module")
def jax_setup():
    batch = _batch(0)
    init = JRaft(JConfig(use_pallas=False, **TINY)).init
    params = jax.jit(init, static_argnums=3)(
        jax.random.key(0), jnp.asarray(batch["pc1"]),
        jnp.asarray(batch["pc2"]), 1)
    cache = {}

    def value_and_grad(fused_gru):
        if fused_gru not in cache:
            model = JRaft(JConfig(use_pallas=False, fused_gru=fused_gru,
                                  **TINY))

            def loss_fn(p):
                flows, _ = model.apply(p, jnp.asarray(batch["pc1"]),
                                       jnp.asarray(batch["pc2"]), ITERS)
                return jsequence_loss(flows, jnp.asarray(batch["mask"]),
                                      jnp.asarray(batch["flow"]), GAMMA)

            cache[fused_gru] = jax.jit(jax.value_and_grad(loss_fn))(params)
        return cache[fused_gru]

    return batch, params, value_and_grad


def _port(params, **kw):
    model = TRaft(TConfig(**TINY, **kw))
    model.load_state_dict(params_from_jax(params), strict=True)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    return model, opt


def _leaf_stats(got, want):
    a = got.double().flatten()
    b = torch.from_numpy(np.asarray(want, np.float64)).flatten()
    na, nb = a.norm(), b.norm()
    if na == 0 and nb == 0:
        return 1.0, 0.0
    return float(a @ b / (na * nb)), float((a - b).norm() / nb)


@pytest.mark.parametrize("fused_gru", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_step_matches_jax_value_and_grad(jax_setup, use_pallas,
                                               fused_gru):
    batch, params, value_and_grad = jax_setup
    jloss, jgrads = value_and_grad(fused_gru)
    model, opt = _port(params, use_pallas=use_pallas, fused_gru=fused_gru)
    step = make_train_step(model, opt, lambda s: LR, GAMMA, ITERS)
    out = step(to_device(batch, "cpu"))
    assert abs(float(out["loss"]) - float(jloss)) <= 1e-5
    want = params_from_jax(jgrads)
    names = [n for n, _ in model.named_parameters()]
    assert set(want) == set(names) and len(names) == 95
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        cos, rel = _leaf_stats(p.grad, want[name])
        assert cos >= 0.9999 and rel <= 1e-3, (name, cos, rel)


def test_two_coupled_steps_match_jax(jax_setup):
    batch, params, _ = jax_setup
    second = _batch(1)
    sched = ("parity", LR, 2, 1, 2)
    tx = optax.adam(jschedule(*sched))
    jstep = jmake_train_step(JRaft(JConfig(use_pallas=False, **TINY)), tx,
                             GAMMA, ITERS, donate=False)
    jp, js = params, tx.init(params)
    model, opt = _port(params, use_pallas=True)
    step = make_train_step(model, opt, make_lr_schedule(*sched), GAMMA, ITERS)
    for b in (batch, second):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tm = step(to_device(b, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4
        assert abs(float(tm["epe"]) - float(jm["epe"])) <= 1e-4
    want = params_from_jax(jp)
    worst = max(float((p.detach() - want[n]).abs().max())
                for n, p in model.named_parameters())
    assert worst <= 2 * LR
