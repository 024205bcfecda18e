"""The bfloat16 slice of the port against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, and the same float32
parameters go through ``pvraft_tpu`` at ``compute_dtype="bfloat16"`` (its
XLA path, ``use_pallas=False``; the fused GRU as the JAX package's own
tests run it, Pallas in interpret mode) and through ``pvraft_tpu_torch``.

The port rounds where the jaxpr rounds (each bf16 op's result); XLA on
the CPU keeps a fused chain of bf16 elementwise ops in float32 and rounds
once at its end (``1 - z``, ``z * q`` and the bf16 logistic in
``ConvGRU``), so the two part by a few bf16 ulps: the op-level bar is the
JAX package's own bf16 bar, rtol/atol 1e-2
(``tests/test_fused_gru.py::test_op_forward_parity_bf16``; measured here:
``gru_math`` against ``_gru_reference`` 9.3e-3 at worst, the unfused
update 1.0e-2, a SetConv 1e-6), and the model flows at 1 iteration are
held at its model-level bar, rtol 0.05 / atol 0.03
(``test_model_forward_parity_bf16_one_iter``; measured: stage 1 9.6e-3).
Every module's output dtype equals the jaxpr's.

Stage 2's refined flow is held in two parts: the backbone's flows at the
model-level bar, and the head (three bf16 SetConvs and a float32 Dense)
on the JAX backbone's own last flow and graph at the same bar (measured
2.5e-3). The refined flow end to end is not: its head amplifies the
backbone's bf16 rounding about tenfold (random weights; the JAX package
itself, fused against unfused GRU at bf16, parts by 0.065 there, the
port against JAX by 0.096), so that is held to 3x the JAX package's own
fused-against-unfused spread on the same inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.engine.loss import sequence_loss as jsequence_loss
from pvraft_tpu.engine.steps import maybe_cast_grads as jmaybe_cast_grads
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu.models import PVRaftRefine as JRefine
from pvraft_tpu.models.layers import SetConv as JSetConv
from pvraft_tpu.models.raft import UpdateIter as JUpdateIter
from pvraft_tpu.ops.corr import CorrState as JCorrState
from pvraft_tpu.ops.geometry import build_graph as jbuild_graph
from pvraft_tpu.ops.pallas import gru_iter as jgru
from pvraft_tpu_torch import test as ttest_cli
from pvraft_tpu_torch import train as ttrain_cli
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.config import compute_dtype
from pvraft_tpu_torch.data import SyntheticDataset, collate, to_device
from pvraft_tpu_torch.engine.steps import maybe_cast_grads, make_train_step
from pvraft_tpu_torch.models import PVRaft as TRaft
from pvraft_tpu_torch.models import PVRaftRefine as TRefine
from pvraft_tpu_torch.models import corr_block as tcorr_block
from pvraft_tpu_torch.models.layers import SetConv as TSetConv
from pvraft_tpu_torch.models.raft import UpdateIter as TUpdateIter
from pvraft_tpu_torch.ops.corr import CorrState as TCorrState
from pvraft_tpu_torch.ops.cuda import gru_iter as tgru
from pvraft_tpu_torch.ops.geometry import Graph as TGraph
from pvraft_tpu_torch.weights import params_from_jax

TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
B, N, GAMMA = 2, 48, 0.8
OP_TOL = {"rtol": 1e-2, "atol": 1e-2}
MODEL_TOL = {"rtol": 0.05, "atol": 0.03}
BF16 = "bfloat16"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _f32(x):
    """A JAX or torch array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _clouds(seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    x2 = (x1 + rng.normal(0, 0.1, (B, N, 3))).astype(np.float32)
    return x1, x2


def _leaves(out):
    """Floating-point tensors of a module's output, in order."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return []


def _torch_outputs(model, run):
    """Run ``run()`` with a forward hook on every submodule of ``model``:
    name -> the floating outputs of each of its calls, in call order."""
    rec = {}

    def hook(name):
        return lambda m, i, o: rec.setdefault(name, []).extend(_leaves(o))

    handles = [m.register_forward_hook(hook(n))
               for n, m in model.named_modules()]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return rec


def _jax_outputs(intermediates):
    """flax ``capture_intermediates``: path -> floating outputs, in call
    order (the port's submodule names are the flax paths)."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                out[".".join(path)] = [
                    leaf for call in v for leaf in jax.tree_util.tree_leaves(call)
                    if jnp.issubdtype(leaf.dtype, jnp.floating)]
            else:
                walk(v, path + [k])

    walk(intermediates["intermediates"], [])
    return out


def _dtypes(leaves):
    return [str(x.dtype).replace("torch.", "") for x in leaves]


# --- the config ---------------------------------------------------------------


def test_configs_take_the_bf16_dtypes():
    for name in ("float32", "f32", BF16):
        cfg = TConfig(compute_dtype=name)
        assert compute_dtype(cfg) == getattr(torch, {"f32": "float32"}.get(
            name, name))
    with pytest.raises(ValueError, match="compute_dtype"):
        TConfig(compute_dtype="float16")
    from pvraft_tpu_torch.config import TrainConfig

    assert TrainConfig(grad_dtype=BF16).grad_dtype == BF16


# --- the fused update's plain version -----------------------------------------


def _gru_operands(seed, n=37, h=64, c=64, f=64):
    rng = np.random.default_rng(seed)

    def a(*s, scale=0.15):
        return (scale * rng.normal(size=s)).astype(np.float32)

    me = (a(f, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3))
    gru = (a(2 * h + c, h), a(h)) * 3
    net = np.tanh(a(1, n, h, scale=1.0))
    inp = np.maximum(a(1, n, c, scale=1.0), 0)
    cor = a(1, n, f, scale=1.0).astype(ml_dtypes.bfloat16)
    flow = a(1, n, 3, scale=0.3)
    return me, gru, net, inp, cor, flow


@pytest.mark.parametrize("seed,n,h,c", [(0, 37, 64, 64), (1, 64, 32, 96),
                                        (2, 20, 48, 80)])
def test_gru_math_bf16_matches_jax_reference_and_pallas(seed, n, h, c):
    """``gru_math(..., bfloat16)`` against ``_gru_reference(...,
    "bfloat16")`` and the Pallas kernel in interpret mode: OP_TOL, a
    float32 result; the bf16 update differs from the float32 one by more
    than that (the dtype is really applied)."""
    me, gru, net, inp, cor, flow = _gru_operands(seed, n, h, c)
    jw = jgru.pack_gru_weights(tuple(map(jnp.asarray, me)),
                               tuple(map(jnp.asarray, gru)), h, c)
    jargs = (jnp.asarray(net), jnp.asarray(inp), jnp.asarray(cor),
             jgru.pad_flow(jnp.asarray(flow)), jw)
    ref = jgru._gru_reference(*jargs, BF16)
    pallas = jgru.fused_gru_update(*jargs, BF16, 16)
    tw = tgru.pack_gru_weights(tuple(map(_t, me)), tuple(map(_t, gru)), h, c)
    targs = (_t(net), _t(inp), _t(cor.astype(np.float32)).to(torch.bfloat16),
             tgru.pad_flow(_t(flow)), tw)
    got = tgru.gru_math(*targs, torch.bfloat16)
    assert got.dtype == torch.float32
    for want in (ref, pallas):
        np.testing.assert_allclose(got.numpy(), _f32(want), **OP_TOL)
    # The Function's CPU path is the plain version, and launches nothing.
    before = (tgru.fused_gru_update.launches, tgru.gru_iter_bf16.launches)
    assert torch.equal(tgru.fused_gru_update(*targs, torch.bfloat16), got)
    assert (tgru.fused_gru_update.launches,
            tgru.gru_iter_bf16.launches) == before
    f32 = tgru.gru_math(*targs[:2], targs[2].float(), *targs[3:])
    assert float((got - f32).abs().max()) > 1e-3


def test_bf16_kernel_wrapper_refuses_cpu_tensors_and_other_dtypes():
    """The bf16 kernel launches or raises: a CPU tensor raises, and so
    does a float32 ``cor`` (no operand is cast), without a launch."""
    me, gru, net, inp, cor, flow = _gru_operands(3, n=8)
    tw = tgru.pack_gru_weights(tuple(map(_t, me)), tuple(map(_t, gru)),
                               64, 64)
    args = [_t(net), _t(inp), _t(cor.astype(np.float32)).to(torch.bfloat16),
            tgru.pad_flow(_t(flow)), tw]
    before = tgru.gru_iter_bf16.launches
    with pytest.raises(ValueError, match="CUDA device"):
        tgru.gru_iter_bf16(*args)
    assert tgru.gru_iter_bf16.launches == before


# --- modules against flax ------------------------------------------------------


@pytest.mark.parametrize("in_ch,out_ch", [(3, 32), (32, 64), (64, 64)])
def test_setconv_bf16_matches_flax(in_ch, out_ch):
    rng = np.random.default_rng(in_ch)
    pc = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    x = rng.normal(0, 0.5, (B, N, in_ch)).astype(np.float32)
    graph = jbuild_graph(jnp.asarray(pc), 8)
    jm = JSetConv(out_ch, dtype=jnp.bfloat16)
    params = jm.init(jax.random.key(in_ch), jnp.asarray(x), graph)
    want = jm.apply(params, jnp.asarray(x), graph)
    tm = TSetConv(in_ch, out_ch, torch.bfloat16)
    tm.load_state_dict(params_from_jax(params), strict=True)
    tgraph = TGraph(_t(graph.neighbors).long(), _t(graph.rel_pos))
    with torch.no_grad():
        got = tm(_t(x), tgraph)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), _f32(want), **OP_TOL)


def _update_iter_inputs(seed):
    rng = np.random.default_rng(seed)
    k, h = TINY["truncate_k"], 64
    coords = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    xyz = (coords[:, :, None, :]
           + rng.normal(0, 0.4, (B, N, k, 3))).astype(np.float32)
    corr = rng.normal(size=(B, N, k)).astype(np.float32)
    net = np.tanh(rng.normal(size=(B, N, h))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(B, N, 64)), 0).astype(np.float32)
    graph = jbuild_graph(jnp.asarray(coords), TINY["graph_k"])
    return coords, xyz, corr, net, inp, graph


@pytest.mark.parametrize("fused_gru", [False, True])
def test_corr_lookup_and_update_block_bf16_match_flax(fused_gru):
    """One GRU iteration (``UpdateIter``: CorrLookup, then UpdateBlock) at
    bf16 on the same inputs and parameters: every submodule's output
    dtype equals flax's; CorrLookup's output within OP_TOL (measured
    7.8e-3, one bf16 ulp at its scale); UpdateBlock's new hidden state
    and flow delta, a chain of MotionEncoder, ConvGRU and FlowHead, within
    MODEL_TOL (measured 9.3e-3 and 1.3e-2)."""
    coords, xyz, corr, net, inp, graph = _update_iter_inputs(5)
    cfg = dict(use_pallas=False, fused_gru=fused_gru, compute_dtype=BF16,
               **TINY)
    jm = JUpdateIter(JConfig(**cfg))
    c1 = jnp.asarray(coords)
    jargs = ((jnp.asarray(net), c1 + 0.05, c1),
             JCorrState(jnp.asarray(corr), jnp.asarray(xyz)),
             jnp.asarray(inp), graph)
    params = jm.init(jax.random.key(3), *jargs)
    _, inter = jm.apply(params, *jargs, capture_intermediates=True,
                        mutable=["intermediates"])
    want = _jax_outputs(inter)
    tm = TUpdateIter(TConfig(**cfg))
    tm.load_state_dict(params_from_jax(params), strict=True)
    t1 = _t(coords)
    targs = (_t(net), t1 + 0.05, t1, TCorrState(_t(corr), _t(xyz)), _t(inp),
             TGraph(_t(graph.neighbors).long(), _t(graph.rel_pos)))
    with torch.no_grad():
        got = _torch_outputs(tm, lambda: tm(*targs))
    common = (set(want) & set(got)) - {""}
    must = {"corr_lookup", "corr_lookup.out_conv1", "corr_lookup.out_gn",
            "corr_lookup.out_prelu", "corr_lookup.knn_conv",
            "corr_lookup.knn_out", "update_block", "update_block.flow_head",
            "update_block.flow_head.setconv.fc1",
            "update_block.flow_head.setconv.gn1",
            "update_block.flow_head.out_conv2"}
    if not fused_gru:
        must |= {"update_block.motion_encoder", "update_block.gru",
                 "update_block.gru.convq"}
    assert must <= common, must - common
    for name in sorted(common):
        assert _dtypes(got[name]) == _dtypes(want[name]), name
    assert _dtypes(got["corr_lookup"]) == ["bfloat16"]
    assert _dtypes(got["update_block"]) == ["float32", "float32"]
    for name, tol in (("corr_lookup", OP_TOL), ("update_block", MODEL_TOL)):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_allclose(_f32(g), _f32(w), **tol)


def test_model_dtypes_match_the_jaxpr():
    """Every submodule of ``PVRaftRefine`` that flax records (the encoders,
    their SetConvs' Denses and GroupNorms, the head) returns the dtype the
    bf16 jaxpr gives it: bf16 Denses, float32 GroupNorms and SetConvs,
    float32 encoders, a float32 head Dense and refined flow."""
    x1, x2 = _clouds(1)
    cfg = dict(use_pallas=False, compute_dtype=BF16, **TINY)
    jm = JRefine(JConfig(**cfg))
    params = jax.jit(jm.init, static_argnums=3)(
        jax.random.key(0), jnp.asarray(x1), jnp.asarray(x2), 1)
    _, inter = jm.apply(params, jnp.asarray(x1), jnp.asarray(x2), 1,
                        capture_intermediates=True, mutable=["intermediates"])
    want = _jax_outputs(inter)
    tm = TRefine(TConfig(**cfg))
    tm.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = _torch_outputs(tm, lambda: tm(_t(x1), _t(x2), 1))
    common = set(want) & set(got)
    assert len(common) >= 60
    for name in sorted(common):
        assert _dtypes(got[name]) == _dtypes(want[name]), name
    assert _dtypes(got["backbone.feature_extractor.conv2.fc2"]) == \
        ["bfloat16"] * 2
    assert _dtypes(got["ref_conv3.gn3"]) == ["float32"]


def test_lookup_operands_stay_float32_under_bf16(monkeypatch):
    """At bf16 the correlation cache and the lookup's operands are float32
    in both packages (the encoders' GroupNorms return float32, and
    ``corr_volume`` accumulates in float32): kernels 1 and 3 take the
    same operands at both dtypes."""
    seen = []
    plain = tcorr_block.corr_lookup_plain

    def spy(corr, xyz, coords, *rest):
        seen.append((corr.dtype, xyz.dtype, coords.dtype))
        return plain(corr, xyz, coords, *rest)

    monkeypatch.setattr(tcorr_block, "corr_lookup_plain", spy)
    x1, x2 = _clouds(2)
    tm = TRaft(TConfig(compute_dtype=BF16, **TINY))
    with torch.no_grad():
        tm(_t(x1), _t(x2), 2)
    assert seen == [(torch.float32,) * 3] * 2

    from pvraft_tpu.models import corr_block as jcorr_block

    jseen = []
    jvox = jcorr_block.voxel_bin_means

    def jspy(corr, rel, *rest):
        jseen.append((corr.dtype, rel.dtype))
        return jvox(corr, rel, *rest)

    monkeypatch.setattr(jcorr_block, "voxel_bin_means", jspy)
    jm = JRaft(JConfig(use_pallas=False, compute_dtype=BF16, **TINY))
    params = jm.init(jax.random.key(0), jnp.asarray(x1), jnp.asarray(x2), 1)
    jm.apply(params, jnp.asarray(x1), jnp.asarray(x2), 2)
    assert jseen and all(d == (jnp.float32, jnp.float32) for d in jseen)


# --- the models at 1 iteration -------------------------------------------------


@pytest.fixture(scope="module")
def refine_params():
    x1, x2 = _clouds(0)
    init = JRefine(JConfig(use_pallas=False, **TINY)).init
    return jax.jit(init, static_argnums=3)(
        jax.random.key(0), jnp.asarray(x1), jnp.asarray(x2), 1)


def _jax_refine(params, fused_gru, x1, x2):
    jm = JRefine(JConfig(use_pallas=False, fused_gru=fused_gru,
                         compute_dtype=BF16, **TINY))
    return jax.jit(jm.apply, static_argnums=3)(
        params, jnp.asarray(x1), jnp.asarray(x2), 1)


@pytest.mark.parametrize("fused_gru", [False, True])
def test_pvraft_bf16_flows_match_jax_at_one_iteration(refine_params,
                                                      fused_gru):
    x1, x2 = _clouds(0)
    backbone = {"params": refine_params["params"]["backbone"]}
    cfg = dict(fused_gru=fused_gru, compute_dtype=BF16, **TINY)
    jm = JRaft(JConfig(use_pallas=False, **cfg))
    want, _ = jax.jit(jm.apply, static_argnums=3)(
        backbone, jnp.asarray(x1), jnp.asarray(x2), 1)
    tm = TRaft(TConfig(**cfg))
    tm.load_state_dict(params_from_jax(backbone), strict=True)
    with torch.no_grad():
        got, _ = tm(_t(x1), _t(x2), 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _f32(want), **MODEL_TOL)


@pytest.mark.parametrize("fused_gru", [False, True])
def test_pvraft_refine_bf16_matches_jax_at_one_iteration(refine_params,
                                                         fused_gru):
    """The refine head on the JAX backbone's last flow and graph at
    MODEL_TOL; the refined flow end to end within 3x the JAX package's
    own fused-against-unfused spread (module docstring)."""
    x1, x2 = _clouds(0)
    cfg = dict(fused_gru=fused_gru, compute_dtype=BF16, **TINY)
    want = _jax_refine(refine_params, fused_gru, x1, x2)
    tm = TRefine(TConfig(**cfg))
    tm.load_state_dict(params_from_jax(refine_params), strict=True)
    jb = JRaft(JConfig(use_pallas=False, **cfg))
    flows, graph = jax.jit(jb.apply, static_argnums=3)(
        {"params": refine_params["params"]["backbone"]}, jnp.asarray(x1),
        jnp.asarray(x2), 1)
    flow = _t(flows[-1])
    tgraph = TGraph(_t(graph.neighbors).long(), _t(graph.rel_pos))
    with torch.no_grad():
        x = tm.ref_conv3(tm.ref_conv2(tm.ref_conv1(flow, tgraph), tgraph),
                         tgraph)
        head = flow + tm.fc(x)
        got = tm(_t(x1), _t(x2), 1)
    assert head.dtype == got.dtype == torch.float32
    np.testing.assert_allclose(head.numpy(), _f32(want), **MODEL_TOL)
    spread = np.abs(_f32(_jax_refine(refine_params, not fused_gru, x1, x2))
                    - _f32(want)).max()
    assert np.abs(got.numpy() - _f32(want)).max() <= 3 * spread


# --- gradients ------------------------------------------------------------------


def test_maybe_cast_grads_is_bitwise_jax():
    """float32 gradients through bf16 and back, ties to even included,
    against the JAX package's ``maybe_cast_grads`` on the same arrays."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1e-3, (257,)).astype(np.float32)
    bits = x.view(np.uint32).copy()
    bits[:64] = (bits[:64] & 0xFFFF0000) | 0x8000     # exact halfway cases
    bits[64:96] = (bits[64:96] & 0xFFFF0000) | 0x7FFF
    x = bits.view(np.float32)
    y = np.concatenate([x, np.array([0.0, -0.0, 1e-40, -3e38, np.inf],
                                    np.float32)])
    grads = {"a": x.reshape(1, 257), "b": y}
    want = jmaybe_cast_grads({k: jnp.asarray(v) for k, v in grads.items()},
                             BF16)
    got = maybe_cast_grads([_t(grads["a"]), _t(grads["b"])], BF16)
    for g, k in zip(got, ("a", "b")):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(want[k]).view(np.uint32))
    same = maybe_cast_grads([_t(y)], "float32")
    assert torch.equal(same[0], _t(y))


def _batch(seed):
    ds = SyntheticDataset(size=B, nb_points=N, noise=0.01, seed=seed,
                          n_objects=2)
    return collate([ds[i] for i in range(B)])


@pytest.mark.parametrize("fused_gru", [False, True])
def test_bf16_train_step_matches_jax(fused_gru):
    """One bf16 train step (1 iteration, ``grad_dtype="bfloat16"``)
    against ``jax.value_and_grad`` of the bf16 model's sequence loss and
    the JAX ``maybe_cast_grads``; every port gradient is a bf16 value.

    bf16 gradients are noisy: a leaf sums many terms that cancel, each
    carrying bf16 rounding, and the port rounds at each op where XLA
    keeps fused chains in float32. Measured (fused_gru off / on): loss
    relative 7.5e-4 / 1.9e-3; all gradients concatenated, relative error
    0.050 / 0.073; per leaf, median relative error 0.10 / 0.15, worst
    leaf 0.38 / 0.40, worst cosine 0.969 / 0.931. The control, the port's
    step with its compute in float32 (gradients still cast to bf16)
    against the same JAX bf16 gradients, which is also JAX's own float32
    against its bf16 gradients: loss 3.1e-3 / 4.0e-3, concatenated
    0.115 / 0.115, median leaf 0.247 / 0.247, worst leaf 0.94 / 0.96,
    worst cosine 0.900 / 0.886. So float32 gradients are only ~1.6x
    farther than the port's bf16 ones, and bars at 3-5x the gap cannot
    tell them apart. Two bars sit between the gap and the control and
    fail a float32 step: median leaf 0.2 and worst leaf 0.6. The others
    are 3-5x the gap: loss 1e-2 relative, concatenated 0.25, every
    leaf's cosine >= 0.75."""
    batch = _batch(0)
    cfg = dict(fused_gru=fused_gru, compute_dtype=BF16, **TINY)
    jm = JRaft(JConfig(use_pallas=False, **cfg))
    params = jax.jit(JRaft(JConfig(use_pallas=False, **TINY)).init,
                     static_argnums=3)(
        jax.random.key(0), jnp.asarray(batch["pc1"]),
        jnp.asarray(batch["pc2"]), 1)

    def loss_fn(p):
        flows, _ = jm.apply(p, jnp.asarray(batch["pc1"]),
                            jnp.asarray(batch["pc2"]), 1)
        return jsequence_loss(flows, jnp.asarray(batch["mask"]),
                              jnp.asarray(batch["flow"]), GAMMA)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = params_from_jax(jmaybe_cast_grads(jgrads, BF16))
    model = TRaft(TConfig(**cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, opt, lambda s: 1e-3, GAMMA, 1,
                           grad_dtype=BF16)
    out = step(to_device(batch, "cpu"))
    loss_rel = abs(float(out["loss"]) - float(jloss)) / abs(float(jloss))
    got, want, rels, coss = [], [], [], []
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32
        # The step's gradients went through bf16: each is a bf16 value.
        assert torch.equal(p.grad, p.grad.bfloat16().float()), name
        g, w = p.grad.double().flatten(), jgrads[name].double().flatten()
        got.append(g)
        want.append(w)
        if w.norm() > 0:
            rels.append(float((g - w).norm() / w.norm()))
            coss.append(float(g @ w / (g.norm() * w.norm())))
    g, w = torch.cat(got), torch.cat(want)
    total_rel = float((g - w).norm() / w.norm())
    assert loss_rel <= 1e-2, loss_rel
    assert total_rel <= 0.25, total_rel
    assert float(np.median(rels)) <= 0.2, rels
    assert max(rels) <= 0.6, rels
    assert min(coss) >= 0.75, coss


# --- the CLIs -----------------------------------------------------------------


def test_cli_bf16_flags_train_and_evaluate(tmp_path, capsys):
    base = ["--dataset", "synthetic", "--device", "cpu", "--max_points",
            "64", "--synthetic_size", "2", "--truncate_k", "16",
            "--corr_knn", "8", "--num_workers", "0"]
    exp = str(tmp_path / "bf16")
    ttrain_cli.main(base + ["--iters", "1", "--eval_iters", "1",
                            "--num_epochs", "1", "--batch_size", "2",
                            "--exp_path", exp, "--bf16", "--grad_dtype",
                            BF16, "--fused_gru"])
    cfg = ttrain_cli.config_from_args(ttrain_cli.parse_args(
        base + ["--bf16", "--grad_dtype", BF16]))
    assert (cfg.model.compute_dtype, cfg.train.grad_dtype) == (BF16, BF16)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and '"test"' in lines[-1]
    best = str(tmp_path / "bf16" / "checkpoints" / "best_checkpoint.msgpack")
    ttest_cli.main(base + ["--eval_iters", "1", "--weights", best, "--bf16"])
    assert ttest_cli.config_from_args(ttest_cli.parse_args(
        base + ["--bf16"])).model.compute_dtype == BF16
    means = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"epe3d"' in means
