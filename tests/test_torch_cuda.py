"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(the check is made inside the fixture, never at import). On a machine
with the card: ``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
Shapes are small and ragged (tails of warps and of point tiles); the
flagship shapes are ``chip_smoke.py``'s. The edge cases hold the
selection and the binning at exact distance ties, at cell boundaries
(+-0.5 r, +-1.5 r), at K = 37 (the scalar-load path) and 40, and at
base_scale 0.3 (the division path). Bars: identical kNN indices,
atol 1e-5, bitwise-equal repeated launches; each Function's gradient
against autograd through its plain version, atol 1e-5; one train step
with the kernels against the plain versions at the bars of
``tests/test_torch_grad.py``. The general kernels (``corr_lookup_general``,
``gru_iter_general``) against the plain versions at shapes the tuned
kernels do not take (K past 512, knn past 32 and up to K, resolutions
1, 2, 4 and 5, GRU widths 32, 48, 96 and 128), forward and gradient;
the general lookup also on every distance equal (the lowest index wins),
K = 1, K not a multiple of 4, rows off 16-byte alignment, keys past
1,024 candidates, no levels, NaN and infinite offsets, and its
voxel-only pass.
The bf16 GRU kernel against ``gru_math`` at bf16 (rtol/atol 1e-2, atol
widened to twice the plain version's own spread across sum orders where
that is larger), with its weights resident in shared memory (widths 64,
32/96, 33/50/37), read from global memory (96, 128) and with its inputs
read from global memory too (context 7100), up to 4 x 8192 points, and
its refusal to run anything else. Concurrent requests to
one engine get their own flows bitwise.
The captured paths: a config the tuned kernels do not take runs the
general kernel under ``use_pallas=None`` and ``True`` and the plain
version under ``False``; the serve programs' replays (their kernel launches measured
by the profiler) and three graphed train steps, stage 1's and stage 2's
(refine), equal their eager runs bitwise; a weight hot-swap keeps the
captured graphs and serves a fresh engine's flows bitwise. On a host
with several cards, the replica pool: a replica per card, bitwise alike,
all serving a burst, swapped together, one quarantined and revived.
The train levers: the packed step, its host round trip and the K-step
graph bitwise equal to the unpacked graphed steps; each remat policy's
gradients bitwise equal to no remat's and its graphed step to its eager
one; the chunked correlation and kNN selecting the dense candidates.
"""

import numpy as np
import pytest
import torch

from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.data import SyntheticDataset, collate, to_device
from pvraft_tpu_torch.engine.steps import sequence_loss_of
from pvraft_tpu_torch.models import PVRaft
from pvraft_tpu_torch.ops.cuda import corr_lookup as lk
from pvraft_tpu_torch.ops.cuda import gru_iter as gr
from pvraft_tpu_torch.ops.cuda import voxel_corr as vx
from pvraft_tpu_torch.ops.voxel import voxel_bin_means
from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
from pvraft_tpu_torch.weights import seeded_state_dict

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,n,k,knn", [(2, 100, 512, 32), (1, 37, 64, 8),
                                       (3, 5, 40, 32)])
def test_lookup_kernel_matches_plain(dev, b, n, k, knn):
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    xyz = (coords[:, :, None] + rng.normal(0, 0.6, (b, n, k, 3))).astype(np.float32)
    corr = rng.normal(size=(b, n, k)).astype(np.float32)
    args = (*(torch.from_numpy(a).to(dev) for a in (corr, xyz, coords)),
            3, 0.25, 3, knn)
    before = lk.fused_corr_lookup.launches
    got = lk.fused_corr_lookup(*args)
    again = lk.fused_corr_lookup(*args)
    want = lk.corr_lookup_plain(*args)
    assert lk.fused_corr_lookup.launches == before + 2
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_lookup_kernel_rejects_what_it_does_not_take(dev):
    """K = 600 is beyond the tuned kernel and runs the general one; a
    resolution whose cell table does not fit a block's shared memory
    raises and names the limit."""
    z = torch.zeros(1, 4, 600, device=dev)
    xyz, coords = torch.zeros(1, 4, 600, 3, device=dev), \
        torch.zeros(1, 4, 3, device=dev)
    before = lk.corr_lookup_general.launches
    lk.fused_corr_lookup(z, xyz, coords, 3, 0.25, 3, 8)
    assert lk.corr_lookup_general.launches == before + 1
    with pytest.raises(ValueError, match="232448"):
        lk.fused_corr_lookup(z, xyz, coords, 1, 0.25, 10, 8)


# Point counts off the kernel's 64-point tile, the flagship 1 x 8192, and
# activations scaled x10 that saturate sigmoid and tanh. There fp32
# gru_math itself is ~1e-5 from fp64 (tests/test_torch_gru_split.py), so
# that case holds atol 1e-4; the scale-1 cases hold 1e-5.
@pytest.mark.parametrize("b,n,scale,tol", [
    (2, 37, 1.0, 1e-5), (2, 65, 1.0, 1e-5), (2, 127, 1.0, 1e-5),
    (2, 2056, 1.0, 1e-5), (1, 8192, 1.0, 1e-5), (2, 2056, 10.0, 1e-4)])
def test_gru_kernel_matches_plain(dev, b, n, scale, tol):
    rng = np.random.default_rng(1)

    def a(*s, scale=0.15):
        return torch.from_numpy((scale * rng.normal(size=s)).astype(np.float32)).to(dev)

    h = 64
    w = gr.pack_gru_weights((a(h, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3)),
                            (a(3 * h, h), a(h), a(3 * h, h), a(h), a(3 * h, h), a(h)),
                            h, h)
    args = (torch.tanh(a(b, n, h, scale=scale)), torch.relu(a(b, n, h, scale=scale)),
            a(b, n, h, scale=scale), gr.pad_flow(a(b, n, 3, scale=0.3 * scale)).contiguous(),
            w)
    before = gr.fused_gru_update.launches
    got = gr.fused_gru_update(*args)
    assert gr.fused_gru_update.launches == before + 1
    torch.testing.assert_close(got, gr.gru_math(*args), rtol=tol, atol=tol)
    assert torch.equal(got, gr.fused_gru_update(*args))


def test_engine_on_the_card_matches_the_cpu(dev):
    tiny = ModelConfig(truncate_k=16, corr_knn=8, graph_k=4, fused_gru=True)
    cfg = ServeConfig(model=tiny, buckets=(32, 64), batch_sizes=(2,),
                      num_iters=1, dtype="float32")
    weights = seeded_state_dict(tiny, 0)
    rng = np.random.default_rng(2)
    pc1 = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    pc2 = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    gpu = InferenceEngine(weights, cfg).predict(pc1, pc2)
    cpu = InferenceEngine(weights, cfg, device="cpu").predict(pc1, pc2)
    np.testing.assert_allclose(gpu, cpu, rtol=0, atol=1e-4)


def test_concurrent_requests_get_their_own_flows_on_the_card(dev):
    """The load of ``tests/test_torch_serve.py::
    test_concurrent_requests_get_their_own_flows`` on captured programs:
    eight threads call ``predict`` three times each on their own request
    of 400-470 points (random weights, truncate_k 32, graph_k 8, corr_knn
    8, one bucket of 512 at batch size 1, 2 iterations), started
    together; every flow equals the serial flow of the same request
    bitwise."""
    import threading

    model = ModelConfig(truncate_k=32, graph_k=8, corr_knn=8)
    cfg = ServeConfig(model=model, buckets=(512,), batch_sizes=(1,),
                      num_iters=2, dtype="float32")
    engine = InferenceEngine(seeded_state_dict(model, 0), cfg)
    rng = np.random.default_rng(5)
    requests = [tuple(rng.uniform(-1, 1, (n, 3)).astype(np.float32)
                      for n in rng.integers(400, 471, size=2))
                for _ in range(8)]
    serial = [engine.predict(*r) for r in requests]
    got = [[] for _ in requests]
    start = threading.Barrier(len(requests))

    def serve(i):
        start.wait()
        for _ in range(3):
            got[i].append(engine.predict(*requests[i]))

    threads = [threading.Thread(target=serve, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, want in enumerate(serial):
        assert len(got[i]) == 3
        for flow in got[i]:
            np.testing.assert_array_equal(flow, want, err_msg=f"thread {i}")


def _candidates(dev, b, n, k, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    xyz = (coords[:, :, None] + rng.normal(0, 0.6, (b, n, k, 3))).astype(np.float32)
    corr = rng.normal(size=(b, n, k)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (corr, xyz, coords))


@pytest.mark.parametrize("b,n,k", [(2, 100, 512), (1, 37, 64), (3, 5, 40)])
def test_voxel_kernel_matches_plain(dev, b, n, k):
    corr, xyz, coords = _candidates(dev, b, n, k)
    rel = (xyz - coords[:, :, None]).contiguous()
    before = vx.voxel_bin_means_pallas.launches
    got = vx.voxel_bin_means_pallas(corr, rel, 3, 0.25, 3)
    again = vx.voxel_bin_means_pallas(corr, rel, 3, 0.25, 3)
    assert vx.voxel_bin_means_pallas.launches == before + 2
    torch.testing.assert_close(got, voxel_bin_means(corr, rel, 3, 0.25, 3),
                               rtol=0, atol=1e-5)
    assert torch.equal(got, again)
    # K = 600 is beyond the tuned kernel: the general one runs it.
    before = lk.corr_lookup_general.launches
    corr, xyz, coords = _candidates(dev, 1, 4, 600)
    rel = (xyz - coords[:, :, None]).contiguous()
    torch.testing.assert_close(vx.voxel_bin_means_pallas(corr, rel, 3, 0.25, 3),
                               voxel_bin_means(corr, rel, 3, 0.25, 3),
                               rtol=0, atol=1e-5)
    assert lk.corr_lookup_general.launches == before + 1


def _edge(dev, kind, b, n, k, seed=5):
    """Exactly representable inputs: ``ties`` (every offset four times:
    itself twice, negated, axes permuted, so equal distances straddle the
    kNN cut), ``boundaries`` (offsets m * r/2, m in -3..3, r a random
    level's edge: candidates at exactly +-0.5 r and +-1.5 r), ``random``."""
    rng = np.random.default_rng(seed)
    coords = (rng.integers(-64, 65, (b, n, 3)) / 64).astype(np.float32)
    if kind == "ties":
        base = np.round(rng.normal(0, 0.6, (b, n, -(-k // 4), 3)) * 256) / 256
        off = np.concatenate([base, base, -base, base[..., ::-1]], axis=2)
        off = off[:, :, rng.permutation(off.shape[2])[:k]]
    elif kind == "boundaries":
        lvl = rng.integers(0, 3, (b, n, k, 1))
        off = rng.integers(-3, 4, (b, n, k, 3)) * 0.125 * 2.0**lvl
    else:
        off = rng.normal(0, 0.6, (b, n, k, 3))
    xyz = (coords[:, :, None] + off).astype(np.float32)
    corr = rng.normal(size=(b, n, k)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (corr, xyz, coords))


EDGES = [("ties", 512, 32, 0.25), ("ties", 37, 16, 0.25),
         ("boundaries", 512, 32, 0.25), ("random", 40, 8, 0.25),
         ("random", 512, 32, 0.3), ("boundaries", 64, 32, 0.3)]


@pytest.mark.parametrize("kind,k,knn,scale", EDGES)
def test_lookup_kernel_edge_cases(dev, kind, k, knn, scale):
    args = (*_edge(dev, kind, 2, 45, k), 3, scale, 3, knn)
    got = lk.fused_corr_lookup(*args)
    want = lk.corr_lookup_plain(*args)
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    assert all(torch.equal(x, y)
               for x, y in zip(got, lk.fused_corr_lookup(*args)))


@pytest.mark.parametrize("kind,k,knn,scale", EDGES)
def test_voxel_kernel_edge_cases(dev, kind, k, knn, scale):
    corr, xyz, coords = _edge(dev, kind, 2, 45, k)
    rel = (xyz - coords[:, :, None]).contiguous()
    got = vx.voxel_bin_means_pallas(corr, rel, 3, scale, 3)
    torch.testing.assert_close(got, voxel_bin_means(corr, rel, 3, scale, 3),
                               rtol=0, atol=1e-5)
    assert torch.equal(got, vx.voxel_bin_means_pallas(corr, rel, 3, scale, 3))


def test_lookup_kernel_without_a_branch(dev):
    """knn = 0 or num_levels = 0 leaves the other branch as it was."""
    corr, xyz, coords = _candidates(dev, 1, 33, 512, seed=4)
    full = lk.fused_corr_lookup(corr, xyz, coords, 3, 0.25, 3, 32)
    vox = lk.fused_corr_lookup(corr, xyz, coords, 3, 0.25, 3, 0)
    knn = lk.fused_corr_lookup(corr, xyz, coords, 0, 0.25, 3, 32)
    assert torch.equal(vox[0], full[0]) and vox[3].shape == (1, 33, 0)
    assert knn[0].shape == (1, 33, 0)
    assert all(torch.equal(a, b) for a, b in zip(knn[1:], full[1:]))


def _grad(fn, leaves, make_args, cots):
    xs = [t.detach().clone().requires_grad_() for t in leaves]
    outs = fn(*make_args(xs))
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    return [x.grad for x in xs]


def test_functions_backward_match_plain_autograd(dev):
    corr, xyz, coords = _candidates(dev, 2, 100, 512, seed=3)
    gen = torch.Generator(device=dev).manual_seed(0)

    def cot(t):
        return torch.randn(t.shape, device=dev, generator=gen)

    lk_out = lk.corr_lookup_plain(corr, xyz, coords, 3, 0.25, 3, 32)
    cots = [cot(t) for t in lk_out[:3]]
    for got, want in zip(*(_grad(f, [corr], lambda xs: (xs[0], xyz, coords,
                                                        3, 0.25, 3, 32), cots)
                           for f in (lk.fused_corr_lookup,
                                     lk.corr_lookup_plain))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    rel = (xyz - coords[:, :, None]).contiguous()
    cots = [cot(voxel_bin_means(corr, rel, 3, 0.25, 3))]
    for got, want in zip(*(_grad(f, [corr], lambda xs: (xs[0], rel, 3, 0.25, 3),
                                 cots)
                           for f in (vx.voxel_bin_means_pallas,
                                     voxel_bin_means))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    h = 64
    raw = [0.15 * torch.randn(s, device=dev, generator=gen) for s in
           [(h, h), (h,), (3, h), (h,), (2 * h, h - 3), (h - 3,)]
           + [(3 * h, h), (h,)] * 3]
    acts = [torch.randn(2, 37, c, device=dev, generator=gen)
            for c in (h, h, h, gr.FLOW_PAD)]

    def args(xs):
        return (*xs[:4], gr.pack_gru_weights(xs[4:10], xs[10:], h, h))

    cots = [cot(acts[0])]
    for got, want in zip(*(_grad(f, acts + raw, args, cots)
                           for f in (gr.fused_gru_update, gr.gru_math))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused_gru", [False, True])
def test_train_step_with_kernels_matches_plain(dev, fused_gru):
    tiny = dict(truncate_k=64, corr_knn=16, graph_k=8)
    ds = SyntheticDataset(size=2, nb_points=256, noise=0.01, seed=1,
                          n_objects=3)
    batch = to_device(collate([ds[0], ds[1]]), dev)
    weights = seeded_state_dict(ModelConfig(**tiny), 0)
    out = {}
    for name, kw in (("kernels", {"fused_gru": fused_gru}),
                     ("plain", {"use_pallas": False})):
        model = PVRaft(ModelConfig(**tiny, **kw)).to(dev)
        model.load_state_dict(weights)
        loss, _ = sequence_loss_of(model, batch, 0.8, 1)
        loss.backward()
        out[name] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()})
    (lk_loss, g_k), (pl_loss, g_p) = out["kernels"], out["plain"]
    assert abs(lk_loss - pl_loss) <= 1e-5 * abs(pl_loss)
    for n, gp in g_p.items():
        gk = g_k[n]
        assert gk is not None and torch.isfinite(gk).all(), n
        if gp.norm() == 0:     # conv_flow.weight: the flow is 0 at step 1
            assert gk.norm() == 0, n
            continue
        cos = float((gk * gp).sum() / (gk.norm() * gp.norm()))
        rel = float((gk - gp).norm() / gp.norm())
        assert cos >= 0.9999 and rel <= 1e-3, (n, cos, rel)


@pytest.mark.parametrize("kw", [{"resolution": 2},
                                {"corr_knn": 48, "truncate_k": 64}])
def test_config_the_kernels_do_not_take_raises_unless_plain(dev, kw):
    """A config the tuned lookup kernel does not take runs the general
    kernel on the card under ``use_pallas=None`` and ``True`` (the
    profiler sees it launched, the plain path never), and its plain
    version under ``False``; the flows agree at 1e-4 after 1 iteration."""
    from pvraft_tpu_torch.ops import cuda as kernels

    tiny = dict(truncate_k=64, corr_knn=16, graph_k=8)
    tiny.update(kw)
    ds = SyntheticDataset(size=2, nb_points=128, noise=0.01, seed=2)
    batch = to_device(collate([ds[0], ds[1]]), dev)
    weights = seeded_state_dict(ModelConfig(**tiny), 0)
    flows = {}
    for use_pallas in (None, True, False):
        model = PVRaft(ModelConfig(**tiny, use_pallas=use_pallas)).to(dev)
        model.load_state_dict(weights)
        with torch.no_grad():
            (flows[use_pallas], _), counts = kernels.measured_launches(
                lambda: model(batch["pc1"], batch["pc2"], 1))
        want = 0 if use_pallas is False else 1
        assert counts["corr_lookup_general"] == want, counts
        assert counts["fused_corr_lookup"] == 0, counts
    for use_pallas in (None, True):
        torch.testing.assert_close(flows[use_pallas], flows[False],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("fused_gru", [False, True])
def test_engine_replays_equal_the_eager_forward(dev, fused_gru):
    """The captured serve programs against ``engine.model`` run eagerly on
    the same padded inputs: bitwise; the profiler sees each replay launch
    the kernels its capture recorded, and no wrapper launches eagerly."""
    from pvraft_tpu_torch.ops import cuda as kernels

    tiny = ModelConfig(truncate_k=16, corr_knn=8, graph_k=4,
                       fused_gru=fused_gru)
    cfg = ServeConfig(model=tiny, buckets=(32, 64), batch_sizes=(1, 2),
                      num_iters=2, dtype="float32")
    engine = InferenceEngine(seeded_state_dict(tiny, 0), cfg)
    report = engine.compile_report()
    assert [r["name"] for r in report] == [
        "predict_b32_bs1", "predict_b32_bs2", "predict_b64_bs1",
        "predict_b64_bs2"]
    want = {"fused_corr_lookup": 2}
    if fused_gru:
        want["fused_gru_update"] = 2
    assert all(r["graph"] and r["launches"] == want for r in report)
    rng = np.random.default_rng(3)
    for n in (64, 40, 33, 20):
        pc1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        m = n + 2 if n < 64 else n
        pc2 = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
        bucket = engine.validate_request(pc1, pc2)
        kernels.zero_launch_counts()
        got, counts = kernels.measured_launches(
            lambda: engine.predict(pc1, pc2))
        assert counts == {**dict.fromkeys(kernels.KERNEL_SYMBOLS, 0), **want}
        assert set(kernels.launch_counts().values()) == {0}
        x1, x2, v1, v2 = (torch.from_numpy(a).to(dev) for a in
                          engine.padded_batch([(pc1, pc2)], bucket))
        with torch.no_grad():
            flows, _ = engine.model(x1, x2, cfg.num_iters, v1, v2)
        np.testing.assert_array_equal(got, flows[-1][0, :n].cpu().numpy())


@pytest.mark.parametrize("fused_gru", [False, True])
def test_hot_swap_keeps_the_captured_graphs(dev, fused_gru):
    """``swap_params`` copies new weights into the tensors the captured
    graphs read: the replays then equal a fresh engine's on the new
    weights bitwise, with the same graphs and the same report (capture
    seconds, pool bytes, launches)."""
    tiny = ModelConfig(truncate_k=16, corr_knn=8, graph_k=4,
                       fused_gru=fused_gru)
    cfg = ServeConfig(model=tiny, buckets=(32, 64), batch_sizes=(1, 2),
                      num_iters=2)
    engine = InferenceEngine(seeded_state_dict(tiny, 0), cfg)
    assert len(engine.replicas) == torch.cuda.device_count()
    graphs = [p.graph for p in engine.replicas[0].programs.values()]
    report = engine.compile_report()
    new = seeded_state_dict(tiny, 1)
    rng = np.random.default_rng(4)
    reqs = [(rng.uniform(-1, 1, (n, 3)).astype(np.float32),
             rng.uniform(-1, 1, (n, 3)).astype(np.float32))
            for n in (20, 64, 41)]
    before = [engine.predict(*r) for r in reqs]
    swap = engine.swap_params(new)
    assert swap["drained_in_time"] and swap["replicas"] == len(
        engine.replicas)
    fresh = InferenceEngine(new, cfg)
    for r, old in zip(reqs, before):
        got = engine.predict(*r)
        np.testing.assert_array_equal(got, fresh.predict(*r))
        assert not np.array_equal(got, old)
    assert [p.graph for p in engine.replicas[0].programs.values()] == graphs
    assert engine.compile_report() == report


def test_replica_pool_across_cards(dev):
    """On a host with two or more cards: one replica per card (replica i
    on cuda:i, its parameters and graphs there) answering bitwise alike;
    the service spreads a burst over every replica; a swap reaches every
    card; a replica quarantined by a fault plan leaves the others serving
    (each failed batch retried once on another card) until the probe
    revives it."""
    import threading

    from pvraft_tpu_torch.serve import (FaultPlan, FaultRule,
                                        SupervisorConfig, build_service)
    from pvraft_tpu_torch.serve import faults

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    tiny = ModelConfig(truncate_k=16, corr_knn=8, graph_k=4)
    cfg = ServeConfig(model=tiny, buckets=(32, 64), batch_sizes=(1,),
                      num_iters=2)
    engine = InferenceEngine(seeded_state_dict(tiny, 0), cfg)
    assert [r.device for r in engine.replicas] == \
        [torch.device("cuda", i) for i in range(n)]
    assert all(p.device == r.device for r in engine.replicas
               for p in r.model.parameters())
    rng = np.random.default_rng(5)
    reqs = [(rng.uniform(-1, 1, (m, 3)).astype(np.float32),
             rng.uniform(-1, 1, (m, 3)).astype(np.float32))
            for m in (20, 64, 41, 30)]
    want = [engine.predict(*r) for r in reqs]
    for replica in engine.replicas[1:]:
        for r, w in zip(reqs, want):
            bucket = engine.validate_request(*r)
            np.testing.assert_array_equal(
                replica.predict_batch([r], bucket)[0], w)
    server = build_service(engine, supervisor_cfg=SupervisorConfig(
        probe_interval_s=0.1, quarantine_after=2))
    server.start()
    try:
        got = [None] * (4 * n)

        def client(i):
            got[i] = server.batcher.submit(*reqs[i % len(reqs)]).wait(60)

        # Each dispatch held 100 ms: a burst of 4n keeps every executor
        # busy, so every replica serves.
        with faults.injected(FaultPlan([FaultRule(
                "replica_latency_ms", nth=1, every=1, value=100.0)])):
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(got))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        for i, g in enumerate(got):
            np.testing.assert_array_equal(g, want[i % len(reqs)])
        stats = server.batcher.replica_stats()
        assert all(s["batches_total"] > 0 for s in stats), stats
        assert [s["device_id"] for s in stats] == list(range(n))

        new = seeded_state_dict(tiny, 1)
        report = engine.swap_params(new)
        assert report["replicas"] == n and report["drained_in_time"]
        fresh = InferenceEngine(new, ServeConfig(
            model=tiny, buckets=(32, 64), batch_sizes=(1,), num_iters=2,
            replicas=1))
        after = [fresh.predict(*r) for r in reqs]
        for replica in engine.replicas:
            for r, w in zip(reqs, after):
                np.testing.assert_array_equal(
                    replica.predict_batch([r], engine.validate_request(*r))[0],
                    w)

        sup = server.supervisor
        got = [None] * (4 * n)
        with faults.injected(FaultPlan([
                FaultRule("replica_latency_ms", nth=1, every=1, value=100.0),
                FaultRule("replica_predict_error", nth=1, every=1,
                          replica=1)])):
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(got))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            for i, g in enumerate(got):
                np.testing.assert_array_equal(g, after[i % len(reqs)])
            assert sup.state_of(1) in ("quarantined", "probing")
            assert server.batcher.counts["retries"] >= 2
            assert sup.pool_health()["state"] == "degraded"
        deadline = threading.Event()
        for _ in range(300):
            if sup.state_of(1) == "healthy":
                break
            deadline.wait(0.1)
        assert sup.state_of(1) == "healthy"
    finally:
        server.shutdown()


def test_graphed_train_step_equals_eager_on_the_card(dev, monkeypatch):
    """Three captured steps (forward, loss, backward, capturable Adam with
    a device lr) against the eager step under deterministic algorithms:
    losses and parameters bitwise; a new shape captures a second graph."""
    from pvraft_tpu_torch.engine.schedule import make_lr_schedule
    from pvraft_tpu_torch.engine.steps import (
        make_graphed_train_step,
        make_train_step,
    )

    tiny = ModelConfig(truncate_k=64, corr_knn=16, graph_k=8, fused_gru=True)
    weights = seeded_state_dict(tiny, 0)
    schedule = make_lr_schedule("cosine", 1e-3, 1, 4, 4)
    ds = SyntheticDataset(size=6, nb_points=256, noise=0.01, seed=1,
                          n_objects=3)
    steps, models = {}, {}
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        for name, make in (("graphed", make_graphed_train_step),
                           ("eager", make_train_step)):
            model = PVRaft(tiny).to(dev)
            model.load_state_dict(weights)
            opt = torch.optim.Adam(model.parameters(),
                                   lr=torch.tensor(1e-3, device=dev),
                                   capturable=True)
            extra = (dev,) if name == "graphed" else ()
            steps[name] = make(model, opt, schedule, 0.8, 2, *extra)
            models[name] = model
        for i in range(3):
            batch = to_device(collate([ds[2 * i], ds[2 * i + 1]]), dev)
            g, e = steps["graphed"](batch), steps["eager"](batch)
            assert torch.equal(g["loss"], e["loss"]), i
            assert torch.equal(g["epe"], e["epe"]), i
        for (n, p), q in zip(models["graphed"].named_parameters(),
                             models["eager"].parameters()):
            assert torch.equal(p, q), n
        steps["graphed"](to_device(collate([ds[0]]), dev))
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(steps["graphed"].graphs.report()) == 2
    assert steps["graphed"].graphs.retraces


def test_graphed_refine_step_equals_eager_on_the_card(dev, monkeypatch):
    """Stage 2: three captured refine steps (the backbone's iterations
    without autograd, the head's forward, backward and capturable Adam)
    against the eager refine step under deterministic algorithms: losses
    and parameters bitwise, the backbone unchanged."""
    from pvraft_tpu_torch.engine.schedule import make_lr_schedule
    from pvraft_tpu_torch.engine.steps import (
        make_graphed_refine_train_step,
        make_refine_train_step,
    )
    from pvraft_tpu_torch.models import PVRaftRefine
    from pvraft_tpu_torch.weights import trained_parameters

    tiny = ModelConfig(truncate_k=64, corr_knn=16, graph_k=8, fused_gru=True)
    weights = seeded_state_dict(tiny, 0, refine=True)
    schedule = make_lr_schedule("cosine", 1e-3, 1, 4, 4)
    ds = SyntheticDataset(size=6, nb_points=256, noise=0.01, seed=1,
                          n_objects=3)
    steps, models = {}, {}
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("graphed", "eager"):
            model = PVRaftRefine(tiny).to(dev)
            model.load_state_dict(weights)
            opt = torch.optim.Adam(
                [p for _, p in trained_parameters(model)],
                lr=torch.tensor(1e-3, device=dev), capturable=True)
            steps[name] = (
                make_graphed_refine_train_step(model, opt, schedule, 4, dev)
                if name == "graphed" else
                make_refine_train_step(model, opt, schedule, 4))
            models[name] = model
        for i in range(3):
            batch = to_device(collate([ds[2 * i], ds[2 * i + 1]]), dev)
            g, e = steps["graphed"](batch), steps["eager"](batch)
            assert torch.equal(g["loss"], e["loss"]), i
            assert torch.equal(g["epe"], e["epe"]), i
    finally:
        torch.use_deterministic_algorithms(False)
    for (n, p), q in zip(models["graphed"].named_parameters(),
                         models["eager"].parameters()):
        assert torch.equal(p, q), n
        if n.startswith("backbone."):
            assert torch.equal(p.cpu(), weights[n]), n
    assert [r["graph"] for r in steps["graphed"].graphs.report()] == [True]


def _flax_tree(state):
    """A port state_dict as a flax params tree (the inverse of
    ``params_from_jax``): Linear weights back to (in, out) kernels,
    GroupNorm weights to scales."""
    tree = {}
    for name, t in state.items():
        module, _, leaf = name.rpartition(".")
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        arr = t.numpy()
        if leaf == "weight":
            leaf, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def test_trainer_resumes_an_optax_state_on_the_card(dev, monkeypatch):
    """An optax Adam state (count 3) loaded into the capturable Adam: its
    step lands on the card before the capture, the graphed steps continue
    the count and equal the eager steps on the same Adam bitwise."""
    from pvraft_tpu_torch.config import Config, DataConfig, TrainConfig
    from pvraft_tpu_torch.engine.steps import optimizer_steps
    from pvraft_tpu_torch.engine.trainer import Trainer

    tiny = ModelConfig(truncate_k=64, corr_knn=16, graph_k=8)
    cfg = Config(model=tiny,
                 data=DataConfig(dataset="synthetic", max_points=256,
                                 synthetic_size=4),
                 train=TrainConfig(num_epochs=1, iters=2, eval_iters=2,
                                   lr_schedule="cosine"))
    state = seeded_state_dict(tiny, 1)
    rng = np.random.default_rng(0)
    moments = {k: 1e-3 * rng.normal(size=v.shape).astype(np.float32)
               for k, v in state.items()}
    opt_state = {"count": np.asarray(3, np.int32),
                 "mu": _flax_tree({k: torch.from_numpy(v)
                                   for k, v in moments.items()}),
                 "nu": _flax_tree({k: torch.from_numpy(v * v)
                                   for k, v in moments.items()})}
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for graphs in (True, False):
            trainer = Trainer(cfg, device=dev, weights=state,
                              opt_state=opt_state, graphs=graphs,
                              capturable=True)
            group = trainer.optimizer.param_groups[0]
            assert group["capturable"] and group["lr"].is_cuda
            assert all(s["step"].is_cuda and float(s["step"]) == 3.0
                       for s in trainer.optimizer.state.values())
            runs[graphs] = trainer.training(0)["losses"]
            assert optimizer_steps(trainer.optimizer) == 5
    finally:
        torch.use_deterministic_algorithms(False)
    assert runs[True] == runs[False] and len(runs[True]) == 2


# --- the general kernels -----------------------------------------------------

# (b, n, K, knn, resolution, levels): K past 512 and not a multiple of 4,
# knn past 32 and knn = K, even and odd resolutions, 1 to 4 levels.
GENERAL_LOOKUPS = [(1, 70, 1024, 64, 3, 3), (2, 33, 510, 48, 2, 3),
                   (1, 40, 512, 32, 5, 4), (2, 9, 37, 37, 3, 2),
                   (1, 20, 7, 0, 4, 1), (2, 50, 100, 5, 1, 2)]


@pytest.mark.parametrize("b,n,k,knn,res,levels", GENERAL_LOOKUPS)
def test_general_lookup_matches_plain(dev, b, n, k, knn, res, levels):
    args = (*_candidates(dev, b, n, k, seed=k), levels, 0.25, res, knn)
    assert lk.general_lookup_plan(k, knn, res, levels).warps >= 1
    before = (lk.corr_lookup_general.launches, lk.fused_corr_lookup.launches)
    got = lk.fused_corr_lookup(*args)
    again = lk.fused_corr_lookup(*args)
    assert (lk.corr_lookup_general.launches,
            lk.fused_corr_lookup.launches) == (before[0] + 2, before[1])
    want = lk.corr_lookup_plain(*args)
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    rel = (args[1] - args[2][:, :, None]).contiguous()
    vox = vx.voxel_bin_means_pallas(args[0], rel, levels, 0.25, res)
    torch.testing.assert_close(vox, voxel_bin_means(args[0], rel, levels,
                                                    0.25, res),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["ties", "boundaries"])
def test_general_lookup_edge_cases(dev, kind):
    """Exact distance ties at the kNN cut (the lowest index wins, as in
    the stable sort) and offsets on cell boundaries, at K = 600."""
    args = (*_edge(dev, kind, 2, 45, 600), 3, 0.25, 3, 48)
    got = lk.fused_corr_lookup(*args)
    want = lk.corr_lookup_plain(*args)
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def _general_case(args):
    """corr_lookup_general on ``args`` (corr, pts, coords, levels, scale,
    R, knn) against corr_lookup_plain (or voxel_bin_means with coords =
    None): the kNN indices equal, values within 1e-5 (NaN where the plain
    version has NaN), two launches bitwise equal. Returns the output."""
    corr, pts, coords, levels, scale, res, knn = args
    before = lk.corr_lookup_general.launches
    got = lk.corr_lookup_general(*args)
    again = lk.corr_lookup_general(*args)
    assert lk.corr_lookup_general.launches == before + 2
    if coords is None:
        want = (voxel_bin_means(corr, pts, levels, scale, res),)
    else:
        # The plain version takes at least one level; the kNN is the same.
        want = lk.corr_lookup_plain(corr, pts, coords, max(levels, 1),
                                    scale, res, knn)
        if not levels:
            assert got[0].shape == (*corr.shape[:2], 0)
            want = (got[0], *want[1:])
        assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5, equal_nan=True)
    for x, y in zip(got, again):
        assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
        assert torch.equal(x.isnan(), y.isnan())
    return got


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary: the kernel takes its scalar loads."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


def test_general_lookup_ties_take_the_lowest_index(dev):
    """Every candidate at one offset (all distances equal): the kNN is
    candidates 0..knn-1 in order; the four-fold ties of ``_edge`` straddle
    the cut at K = 1024, knn 64 and match the stable sort. 1,030 points, so
    that the count clamp (N) leaves a cell of every candidate its mean."""
    for k, knn in ((1024, 64), (600, 48), (37, 37), (1600, 100)):
        corr, xyz, coords = _candidates(dev, 1, 1030, k, seed=k)
        xyz = coords[:, :, None].expand(-1, -1, k, -1) + 0.125
        got = _general_case((corr, xyz.contiguous(), coords, 3, 0.25, 3, knn))
        assert torch.equal(got[3][0, 0].long().cpu(), torch.arange(knn))
    _general_case((*_edge(dev, "ties", 2, 45, 1024), 3, 0.25, 3, 64))


# (K, knn, resolution, levels, unaligned rows): knn = K, K = 1, K not a
# multiple of 4 (scalar loads), rows off 16-byte alignment, two chunks
# not full, keys in shared memory past 1,024 candidates, R 1, R 4, levels
# taken one a pass (R 5) and no levels at all.
ODD_GENERAL = [(1024, 1024, 3, 3, False), (1, 1, 3, 3, False),
               (1, 1, 2, 1, True), (37, 20, 3, 2, False),
               (1024, 64, 3, 3, True), (1026, 70, 3, 3, False),
               (1600, 64, 3, 3, False), (2053, 100, 2, 2, True),
               (100, 32, 1, 2, False), (300, 40, 4, 3, False),
               (520, 33, 5, 4, True), (700, 50, 3, 0, False)]


@pytest.mark.parametrize("k,knn,res,levels,unaligned", ODD_GENERAL)
def test_general_lookup_odd_shapes(dev, k, knn, res, levels, unaligned):
    corr, xyz, coords = _candidates(dev, 2, 23, k, seed=k + knn)
    if unaligned:
        corr, xyz = _unaligned(corr), _unaligned(xyz)
    _general_case((corr, xyz, coords, levels, 0.25, res, knn))
    _general_case((corr, xyz, coords, levels, 0.3, res, knn))


@pytest.mark.parametrize("res", [1, 3, 4])
def test_general_lookup_nan_and_inf_offsets(dev, res):
    """NaN and +-inf candidates are in no cell and sort after every finite
    distance, a NaN after +inf, the lowest index first among them."""
    corr, xyz, coords = _candidates(dev, 1, 31, 1024, seed=res)
    bad = torch.rand(xyz.shape[:3], device=dev, generator=torch.Generator(
        device=dev).manual_seed(res))
    xyz = xyz.clone()
    xyz[..., 0][bad < 0.02] = float("nan")
    xyz[..., 1][(bad >= 0.02) & (bad < 0.04)] = float("inf")
    xyz[..., 2][(bad >= 0.04) & (bad < 0.06)] = -float("inf")
    # Take every candidate so that the infinities and NaNs are selected.
    for knn in (64, 1024):
        got = _general_case((corr, xyz, coords, 3, 0.25, res, knn))
    d = (got[2] * got[2]).sum(-1)
    assert bool(d[..., -1].isnan().all())


@pytest.mark.parametrize("k,res,levels", [(1024, 3, 3), (510, 2, 3),
                                          (512, 5, 4), (1600, 3, 3),
                                          (37, 1, 2), (7, 4, 1)])
def test_general_voxel_only_pass(dev, k, res, levels):
    """The voxel Function's general pass (knn = 0, coords = None: the
    offsets read as given) against voxel_bin_means, at power-of-two edges
    (reciprocal multiply) and at 0.3 (division)."""
    corr, xyz, coords = _candidates(dev, 2, 40, k, seed=k)
    rel = (xyz - coords[:, :, None]).contiguous()
    for scale in (0.25, 0.3):
        _general_case((corr, rel, None, levels, scale, res, 0))
    got = vx.voxel_bin_means_pallas(corr, rel, levels, 0.25, res)
    torch.testing.assert_close(got, voxel_bin_means(corr, rel, levels, 0.25,
                                                    res), rtol=0, atol=1e-5)


def _gru_operands(dev, b, n, h, c, f, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)

    def a(*s, scale=0.15):
        return torch.from_numpy((scale * rng.normal(size=s)).astype(
            np.float32)).to(dev)

    me = (a(f, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3))
    gru = tuple(t for _ in range(3) for t in (a(h + c + h, h), a(h)))
    acts = (torch.tanh(a(b, n, h, scale=scale)),
            torch.relu(a(b, n, c, scale=scale)), a(b, n, f, scale=scale),
            gr.pad_flow(a(b, n, 3, scale=0.3 * scale)).contiguous())
    return acts, me, gru


# (B, N, hidden, context, correlation, activation scale, atol): the
# tensor-core layouts ("resident" at 32/32, 32/96, 33/50/37; "ring" at 96,
# 128, 96/32, 48/80, 48/80/40) at 129 points a batch, point counts off
# their 64- and 32-point blocks, activations x10 that saturate sigmoid and
# tanh (there fp32 gru_math itself is ~1e-5 from fp64, so atol 1e-4), and
# a width no tensor-core layout takes (hidden 200: mode "fma").
GENERAL_GRU = [(2, 129, 32, 32, 64, 1.0, 1e-5), (2, 129, 96, 96, 64, 1.0, 1e-5),
               (2, 129, 128, 128, 64, 1.0, 1e-5),
               (2, 129, 48, 80, 40, 1.0, 1e-5), (2, 129, 32, 96, 64, 1.0, 1e-5),
               (2, 129, 33, 50, 37, 1.0, 1e-5), (2, 129, 96, 32, 64, 1.0, 1e-5),
               (2, 129, 48, 80, 64, 1.0, 1e-5),
               (1, 8191, 32, 96, 64, 1.0, 1e-5),
               (2, 2056, 32, 96, 64, 1.0, 1e-5),
               (2, 2056, 96, 96, 64, 1.0, 1e-5),
               (1, 8192, 32, 96, 64, 10.0, 1e-4),
               (1, 8192, 128, 128, 64, 10.0, 1e-4),
               (2, 129, 200, 64, 64, 1.0, 1e-5)]


@pytest.mark.parametrize("b,n,h,c,f,scale,tol", GENERAL_GRU)
def test_general_gru_matches_plain(dev, b, n, h, c, f, scale, tol):
    acts, me, gru = _gru_operands(dev, b, n, h, c, f, scale=scale)
    args = (*acts, gr.pack_gru_weights(me, gru, h, c))
    assert (gr.general_gru_plan(h, c, f).mode == "fma") == (h > 128)
    before = (gr.gru_iter_general.launches, gr.fused_gru_update.launches)
    got = gr.fused_gru_update(*args)
    assert (gr.gru_iter_general.launches,
            gr.fused_gru_update.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(got, gr.gru_math(*args), rtol=0, atol=tol)
    assert torch.equal(got, gr.fused_gru_update(*args))


@pytest.mark.parametrize("which", [0, 2, 3])
def test_unaligned_operands_at_width_64_run_the_general_kernel(dev, which):
    """An operand (net, cor or flow8) whose rows start off a 16-byte
    boundary: the tuned kernel does not take it, the general one does (its
    scalar loads), and computes the same update."""
    acts, me, gru = _gru_operands(dev, 2, 2056, 64, 64, 64, seed=3)
    acts = list(acts)
    acts[which] = _unaligned(acts[which])
    args = (*acts, gr.pack_gru_weights(me, gru, 64, 64))
    before = (gr.gru_iter_general.launches, gr.fused_gru_update.launches)
    got = gr.fused_gru_update(*args)
    assert (gr.gru_iter_general.launches,
            gr.fused_gru_update.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(got, gr.gru_math(*args), rtol=0, atol=1e-5)
    assert torch.equal(got, gr.fused_gru_update(*args))


def test_general_kernels_backward_match_plain_autograd(dev):
    """The Functions' plain-PyTorch backward passes at the general
    kernels' shapes, against autograd through the plain versions: 1e-4."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def cot(t):
        return torch.randn(t.shape, device=dev, generator=gen)

    corr, xyz, coords = _candidates(dev, 1, 40, 1024, seed=9)
    geo = (3, 0.25, 2)
    cots = [cot(t) for t in lk.corr_lookup_plain(corr, xyz, coords, *geo,
                                                  48)[:3]]
    for got, want in zip(*(_grad(f, [corr], lambda xs: (xs[0], xyz, coords,
                                                        *geo, 48), cots)
                           for f in (lk.fused_corr_lookup,
                                     lk.corr_lookup_plain))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    rel = (xyz - coords[:, :, None]).contiguous()
    cots = [cot(voxel_bin_means(corr, rel, *geo))]
    for got, want in zip(*(_grad(f, [corr], lambda xs: (xs[0], rel, *geo),
                                 cots)
                           for f in (vx.voxel_bin_means_pallas,
                                     voxel_bin_means))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    h, c, f = 32, 32, 64
    acts, me, gru = _gru_operands(dev, 2, 37, h, c, f, seed=2)

    def args(xs):
        return (*xs[:4], gr.pack_gru_weights(xs[4:10], xs[10:], h, c))

    cots = [cot(acts[0])]
    for got, want in zip(*(_grad(fn, list(acts) + list(me) + list(gru),
                                 args, cots)
                           for fn in (gr.fused_gru_update, gr.gru_math))):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# The bf16 kernel (csrc/gru_iter_bf16.cu) against gru_math at bf16 on the
# operands the bf16 model hands it (cor bf16, the rest float32): the JAX
# package's op-level bf16 bar, rtol/atol 1e-2, with atol widened to twice
# the plain version's own spread across sum orders (gru_math on the card
# against gru_math on the host) where that is larger: a sum order rounds a
# few values to neighbouring bf16s (chip_smoke.py, BF16_OP_TOL).
@pytest.mark.parametrize("b,n,h,c,f", [(2, 37, 64, 64, 64),
                                       (1, 8192, 64, 64, 64),
                                       (4, 8192, 64, 64, 64),
                                       (4, 4096, 64, 64, 64),
                                       (2, 129, 32, 96, 64),
                                       (2, 65, 128, 128, 64),
                                       (2, 129, 33, 50, 37),
                                       (1, 45, 8, 7100, 16)])
def test_bf16_gru_kernel_matches_plain(dev, b, n, h, c, f):
    acts, me, gru = _gru_operands(dev, b, n, h, c, f, seed=3)
    bf16 = torch.bfloat16
    args = (acts[0], acts[1], acts[2].to(bf16), acts[3],
            gr.pack_gru_weights(me, gru, h, c), bf16)
    before = {w.__name__: w.launches for w in (
        gr.gru_iter_bf16, gr.fused_gru_update, gr.gru_iter_general)}
    got = gr.fused_gru_update(*args)
    assert {w.__name__: w.launches for w in (
        gr.gru_iter_bf16, gr.fused_gru_update, gr.gru_iter_general)} == {
        **before, "gru_iter_bf16": before["gru_iter_bf16"] + 1}
    want = gr.gru_math(*args)
    host = gr.gru_math(*(a.cpu() for a in args[:4]),
                       tuple(w.cpu() for w in args[4]), bf16)
    floor = float((want.cpu() - host).abs().max())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-2,
                               atol=max(1e-2, 2 * floor))
    assert torch.equal(got, gr.fused_gru_update(*args))


def test_bf16_gru_launches_its_kernel_or_raises(dev, monkeypatch):
    """A bf16 fused update on CUDA tensors runs the bf16 kernel and
    nothing else: a float32 ``cor`` raises (no operand is cast), and where
    the kernel cannot be built the call raises instead of falling back to
    ``gru_math`` or to a float32 kernel."""
    from pvraft_tpu_torch.ops import cuda as kernels

    acts, me, gru = _gru_operands(dev, 1, 64, 64, 64, 64, seed=4)
    w = gr.pack_gru_weights(me, gru, 64, 64)
    counts = (gr.gru_iter_bf16.launches, gr.fused_gru_update.launches,
              gr.gru_iter_general.launches)
    with pytest.raises(ValueError, match="bfloat16"):
        gr.fused_gru_update(*acts, w, torch.bfloat16)

    def refuse(name):
        raise RuntimeError(f"CUDA kernel build failed: {name}")

    monkeypatch.setattr(kernels, "library", refuse)
    with pytest.raises(RuntimeError, match="gru_iter_bf16"):
        gr.fused_gru_update(acts[0], acts[1], acts[2].to(torch.bfloat16),
                            acts[3], w, torch.bfloat16)
    assert (gr.gru_iter_bf16.launches, gr.fused_gru_update.launches,
            gr.gru_iter_general.launches) == counts


def _kept(metrics):
    """A step's metrics as lists of floats, read before the next replay."""
    return {k: v.reshape(-1).tolist() for k, v in metrics.items()}


def test_k_step_graph_equals_single_replays_on_the_card(dev, monkeypatch):
    """The packed state and the K-step graph (K = 3) on the card, under
    deterministic algorithms: six steps as two 3-step replays against six
    replays of the packed single step and six unpacked graphed steps:
    losses, EPEs and every parameter bitwise; with ``host_roundtrip``
    the packed step is bitwise too; the K-step capture recorded 3 x 2
    lookups."""
    from pvraft_tpu_torch.engine.schedule import make_lr_schedule
    from pvraft_tpu_torch.engine.steps import (
        PackedState,
        make_graphed_multistep_train_step,
        make_graphed_packed_train_step,
        make_graphed_train_step,
        stack_batches,
    )

    tiny = ModelConfig(truncate_k=64, corr_knn=16, graph_k=8, fused_gru=True)
    weights = seeded_state_dict(tiny, 0)
    schedule = make_lr_schedule("cosine", 1e-3, 1, 6, 12)
    ds = SyntheticDataset(size=12, nb_points=256, noise=0.01, seed=2,
                          n_objects=3)
    batches = [to_device(collate([ds[2 * i], ds[2 * i + 1]]), dev)
               for i in range(6)]
    runs = {}
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        for way in ("unpacked", "packed", "host_roundtrip", "k3"):
            model = PVRaft(tiny).to(dev)
            model.load_state_dict(weights)
            opt = torch.optim.Adam(model.parameters(),
                                   lr=torch.tensor(1e-3, device=dev),
                                   capturable=True)
            args = (model, opt, schedule, 0.8, 2)
            # A replay overwrites the program's outputs: keep copies.
            if way == "unpacked":
                step = make_graphed_train_step(*args, dev)
                out = [_kept(step(b)) for b in batches]
            elif way == "k3":
                packed = PackedState(model, opt)
                multi, _, _ = make_graphed_multistep_train_step(
                    *args, 3, dev, packed=packed)
                out = [_kept(multi(stack_batches(batches[i:i + 3])))
                       for i in (0, 3)]
                launches = multi.graphs.report()[0]["launches"]
            else:
                step, _, _ = make_graphed_packed_train_step(
                    *args, dev, host_roundtrip=way == "host_roundtrip")
                out = [_kept(step(b)) for b in batches]
            runs[way] = ([v for m in out for v in m["loss"]]
                         + [v for m in out for v in m["epe"]],
                         [p.detach().clone() for p in model.parameters()])
    finally:
        torch.use_deterministic_algorithms(False)
    for way in ("packed", "host_roundtrip", "k3"):
        assert runs[way][0] == runs["unpacked"][0], way
        assert all(torch.equal(a, b) for a, b in zip(
            runs[way][1], runs["unpacked"][1])), way
    assert launches == {"fused_corr_lookup": 6, "fused_gru_update": 6}


@pytest.mark.parametrize("policy", ["full", "dots", "save_corr"])
def test_remat_gradients_and_capture_on_the_card(dev, monkeypatch, policy):
    """Each remat policy's gradients bitwise equal to no remat's under
    deterministic algorithms (the lookup kernel that runs again in the
    backward selects the same candidates), and its graphed step captures
    and equals its eager step bitwise."""
    from pvraft_tpu_torch.engine.schedule import make_lr_schedule
    from pvraft_tpu_torch.engine.steps import (
        make_graphed_train_step,
        make_train_step,
    )

    base = {"truncate_k": 64, "corr_knn": 16, "graph_k": 8}
    weights = seeded_state_dict(ModelConfig(**base), 0)
    ds = SyntheticDataset(size=2, nb_points=256, noise=0.01, seed=3,
                          n_objects=3)
    batch = to_device(collate([ds[0], ds[1]]), dev)
    schedule = make_lr_schedule("cosine", 1e-3, 1, 4, 4)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        grads, steps = {}, {}
        for name in ("none", policy):
            model = PVRaft(ModelConfig(**base, remat_policy=name)).to(dev)
            model.load_state_dict(weights)
            model.zero_grad(set_to_none=True)
            sequence_loss_of(model, batch, 0.8, 2)[0].backward()
            grads[name] = [p.grad.clone() for p in model.parameters()]
        for name, make in (("graphed", make_graphed_train_step),
                           ("eager", make_train_step)):
            model = PVRaft(ModelConfig(**base, remat_policy=policy)).to(dev)
            model.load_state_dict(weights)
            opt = torch.optim.Adam(model.parameters(),
                                   lr=torch.tensor(1e-3, device=dev),
                                   capturable=True)
            extra = (dev,) if name == "graphed" else ()
            step = make(model, opt, schedule, 0.8, 2, *extra)
            steps[name] = ([float(step(batch)["loss"]) for _ in range(2)],
                           [p.detach().clone() for p in model.parameters()])
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a, b) for a, b in zip(grads[policy],
                                                 grads["none"]))
    assert steps["graphed"][0] == steps["eager"][0]
    assert all(torch.equal(a, b) for a, b in zip(steps["graphed"][1],
                                                 steps["eager"][1]))


def test_chunked_levers_on_the_card(dev):
    """``corr_chunk`` and ``graph_chunk`` on CUDA tensors: the same
    candidates as the dense paths, correlations within float32 rounding
    (cuBLAS may take another kernel for a chunk's product)."""
    from pvraft_tpu_torch.ops.corr import corr_init
    from pvraft_tpu_torch.ops.geometry import knn_indices

    g = torch.Generator(device="cpu").manual_seed(0)
    f1, f2 = (torch.randn(2, 512, 128, generator=g).to(dev)
              for _ in range(2))
    x2 = torch.rand(2, 1024, 3, generator=g).to(dev)
    f2 = torch.cat([f2, torch.randn(2, 512, 128, generator=g).to(dev)], 1)
    dense = corr_init(f1, f2, x2, 64)
    chunked = corr_init(f1, f2, x2, 64, chunk=256)
    torch.testing.assert_close(chunked.corr, dense.corr, rtol=0, atol=1e-5)
    assert torch.equal(chunked.xyz, dense.xyz)
    assert torch.equal(knn_indices(x2, x2, 16, chunk=256),
                       knn_indices(x2, x2, 16))
