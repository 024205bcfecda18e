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
``tests/test_torch_grad.py``.
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
    z = torch.zeros(1, 4, 600, device=dev)
    with pytest.raises(ValueError, match="K <= 512"):
        lk.fused_corr_lookup(z, torch.zeros(1, 4, 600, 3, device=dev),
                             torch.zeros(1, 4, 3, device=dev), 3, 0.25, 3, 8)


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
                      num_iters=1)
    weights = seeded_state_dict(tiny, 0)
    rng = np.random.default_rng(2)
    pc1 = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    pc2 = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    gpu = InferenceEngine(weights, cfg).predict(pc1, pc2)
    cpu = InferenceEngine(weights, cfg, device="cpu").predict(pc1, pc2)
    np.testing.assert_allclose(gpu, cpu, rtol=0, atol=1e-4)


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
    with pytest.raises(ValueError, match="K <= 512"):
        vx.voxel_bin_means_pallas(torch.zeros(1, 4, 600, device=dev),
                                  torch.zeros(1, 4, 600, 3, device=dev),
                                  3, 0.25, 3)


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
