"""The port's ops, layers and config against the JAX package's.

Same inputs, made with numpy from a seed, go through ``pvraft_tpu`` and
``pvraft_tpu_torch`` on the CPU. Ops and layers agree to 1e-5 (fp32
accumulation on both sides; the sums run in different orders). Selections
(kNN indices, truncated candidates) agree exactly on continuous random
clouds, where no distances tie.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from pvraft_tpu import config as jconfig
from pvraft_tpu.models import layers as jlayers
from pvraft_tpu.ops import corr as jcorr
from pvraft_tpu.ops import geometry as jgeo
from pvraft_tpu.ops import voxel as jvoxel
from pvraft_tpu_torch import config as tconfig
from pvraft_tpu_torch.models import layers as tlayers
from pvraft_tpu_torch.ops import corr as tcorr
from pvraft_tpu_torch.ops import geometry as tgeo
from pvraft_tpu_torch.ops import voxel as tvoxel
from pvraft_tpu_torch.weights import params_from_jax

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cloud(rng, b, n):
    return rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)


def _close(jax_out, torch_out, atol=ATOL):
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.detach().numpy(),
                               rtol=0, atol=atol)


# --- geometry ----------------------------------------------------------------


def test_pairwise_sqdist_and_knn_match_jax():
    rng = np.random.default_rng(0)
    a, b = _cloud(rng, 2, 40), _cloud(rng, 2, 56)
    _close(jgeo.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)),
           tgeo.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b)))
    ji = jgeo.knn_indices(jnp.asarray(a), jnp.asarray(b), 8)
    ti = tgeo.knn_indices(torch.from_numpy(a), torch.from_numpy(b), 8)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_build_graph_matches_jax_self_first():
    rng = np.random.default_rng(1)
    pc = _cloud(rng, 2, 48)
    jg = jgeo.build_graph(jnp.asarray(pc), 8)
    tg = tgeo.build_graph(torch.from_numpy(pc), 8)
    np.testing.assert_array_equal(np.asarray(jg.neighbors), tg.neighbors.numpy())
    _close(jg.rel_pos, tg.rel_pos)
    assert tg.k == 8
    # Each point is its own nearest neighbour.
    np.testing.assert_array_equal(tg.neighbors[..., 0].numpy(),
                                  np.broadcast_to(np.arange(48), (2, 48)))


def test_gather_neighbors_matches_jax():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 30, 5)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 12, 4))
    _close(jgeo.gather_neighbors(jnp.asarray(feats), jnp.asarray(idx)),
           tgeo.gather_neighbors(torch.from_numpy(feats), torch.from_numpy(idx)))


# --- correlation -------------------------------------------------------------


def test_corr_volume_matches_jax():
    rng = np.random.default_rng(3)
    f1 = rng.normal(size=(2, 24, 128)).astype(np.float32)
    f2 = rng.normal(size=(2, 40, 128)).astype(np.float32)
    _close(jcorr.corr_volume(jnp.asarray(f1), jnp.asarray(f2)),
           tcorr.corr_volume(torch.from_numpy(f1), torch.from_numpy(f2)))


@pytest.mark.parametrize("masked", [False, True])
def test_corr_init_matches_jax(masked):
    rng = np.random.default_rng(4)
    f1 = rng.normal(size=(2, 24, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 40, 32)).astype(np.float32)
    xyz2 = _cloud(rng, 2, 40)
    valid2 = None
    if masked:
        valid2 = np.ones((2, 40), bool)
        valid2[0, 30:] = False
        valid2[1, 35:] = False
    js = jcorr.corr_init(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(xyz2),
                         16, valid2=None if valid2 is None else jnp.asarray(valid2))
    ts = tcorr.corr_init(torch.from_numpy(f1), torch.from_numpy(f2),
                         torch.from_numpy(xyz2), 16,
                         valid2=None if valid2 is None else torch.from_numpy(valid2))
    _close(js.corr, ts.corr)
    _close(js.xyz, ts.xyz)
    if masked:
        # Every kept candidate is a real pc2 point.
        assert torch.isin(ts.xyz[0].reshape(-1, 3)[:, 0],
                          torch.from_numpy(xyz2[0, :30, 0])).all()


def test_corr_init_rejects_k_above_candidates():
    z = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="truncate_k"):
        tcorr.corr_init(z, z, torch.zeros(1, 4, 3), 5)


def _candidates(rng, b, n, k):
    """Truncated-cache stand-ins: continuous offsets around the coords that
    populate cells of all three voxel levels."""
    coords = _cloud(rng, b, n)
    xyz = coords[:, :, None, :] + rng.normal(0, 0.6, (b, n, k, 3)).astype(np.float32)
    corr = rng.normal(size=(b, n, k)).astype(np.float32)
    return corr, xyz.astype(np.float32), coords


def test_knn_lookup_matches_jax():
    rng = np.random.default_rng(5)
    corr, xyz, coords = _candidates(rng, 2, 20, 16)
    rel = xyz - coords[:, :, None, :]
    jk, jr = jcorr.knn_lookup(jcorr.CorrState(jnp.asarray(corr), jnp.asarray(xyz)),
                              jnp.asarray(rel), 8)
    tk, tr = tcorr.knn_lookup(tcorr.CorrState(torch.from_numpy(corr),
                                              torch.from_numpy(xyz)),
                              torch.from_numpy(rel), 8)
    _close(jk, tk)
    _close(jr, tr)


def test_knn_select_lowest_index_wins_ties():
    rel = torch.zeros(1, 1, 6, 3)
    rel[0, 0, :, 0] = torch.tensor([2.0, 1.0, 1.0, 3.0, 1.0, 0.5])
    assert tcorr.knn_select(rel, 4).tolist() == [[[5, 1, 2, 4]]]


def test_voxel_bin_means_matches_jax():
    rng = np.random.default_rng(6)
    corr, xyz, coords = _candidates(rng, 2, 24, 32)
    rel = xyz - coords[:, :, None, :]
    want = jvoxel.voxel_bin_means(jnp.asarray(corr), jnp.asarray(rel), 3, 0.25, 3)
    got = tvoxel.voxel_bin_means(torch.from_numpy(corr), torch.from_numpy(rel),
                                 3, 0.25, 3)
    assert got.shape == (2, 24, 81)
    _close(want, got)
    assert (got != 0).float().mean() > 0.1    # the cells are populated


def test_voxel_rounds_half_to_even():
    # rel / r = 1.5 rounds to 2 (outside the cube), 0.5 rounds to 0.
    corr = torch.tensor([[[1.0, 10.0]]])
    rel = torch.tensor([[[[0.375, 0.0, 0.0], [0.125, 0.0, 0.0]]]])
    out = tvoxel.voxel_bin_means(corr, rel, 1, 0.25, 3)
    assert out[0, 0, 13].item() == 10.0      # centre cell: only the 0.5 one
    assert out.sum().item() == 10.0


# --- layers ------------------------------------------------------------------


def test_prelu_matches_jax():
    x = np.random.default_rng(7).normal(size=(3, 5)).astype(np.float32)
    jm = jlayers.PReLU()
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    _close(jm.apply(params, jnp.asarray(x)), tlayers.PReLU()(torch.from_numpy(x)))


class _GN(fnn.Module):
    masked: bool

    @fnn.compact
    def __call__(self, x, mask):
        return jlayers.group_norm(x, "gn", mask=mask if self.masked else None)


@pytest.mark.parametrize("shape", [(2, 20, 64), (2, 20, 6, 32)])
@pytest.mark.parametrize("masked", [False, True])
def test_group_norm_matches_flax(shape, masked):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    mask = np.ones(shape[:2], bool)
    mask[0, 13:] = False
    mask[1, 17:] = False
    jmask = jnp.asarray(mask).reshape(shape[:2] + (1,) * (len(shape) - 2))
    gn = _GN(masked)
    c = shape[-1]
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    params = {"params": {"gn": {"scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)}}}
    want = gn.apply(params, jnp.asarray(x), jmask)
    got = tlayers.group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias),
                             mask=torch.from_numpy(mask) if masked else None)
    _close(want, got)


@pytest.mark.parametrize("in_ch,masked", [(3, False), (64, True)])
def test_setconv_matches_jax(in_ch, masked):
    rng = np.random.default_rng(9)
    pc = _cloud(rng, 2, 40)
    x = pc if in_ch == 3 else rng.normal(size=(2, 40, in_ch)).astype(np.float32)
    mask = np.ones((2, 40), bool)
    mask[1, 33:] = False
    jg = jgeo.build_graph(jnp.asarray(pc), 8)
    jm = jlayers.SetConv(64)
    jmask = jnp.asarray(mask) if masked else None
    params = jm.init(jax.random.key(1), jnp.asarray(x), jg, jmask)
    want = jm.apply(params, jnp.asarray(x), jg, jmask)
    tm = tlayers.SetConv(in_ch, 64)
    tm.load_state_dict(params_from_jax(params), strict=True)
    tg = tgeo.build_graph(torch.from_numpy(pc), 8)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), tg,
                 torch.from_numpy(mask) if masked else None)
    _close(want, got)


# --- config ------------------------------------------------------------------


def test_model_config_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.ModelConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.ModelConfig)}
    assert jf == tf


@pytest.mark.parametrize("kw", [{"seq_shard": True},
                                {"scatter_free_vjp": True}])
def test_model_config_rejects_later_slices(kw):
    """``scatter_free_vjp`` is not ported and raises; ``seq_shard``,
    ported with the sequence-parallel ring, is taken as JAX takes it."""
    jconfig.ModelConfig(**kw)            # the JAX package honors it
    if "seq_shard" in kw:
        assert dataclasses.asdict(tconfig.ModelConfig(**kw)) == \
            dataclasses.asdict(jconfig.ModelConfig(**kw))
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tconfig.ModelConfig(**kw)


@pytest.mark.parametrize("kw,reaches", [
    ({"corr_chunk": 256}, None),
    ({"graph_chunk": 256}, ("feature_extractor.graph_chunk", 256)),
    ({"approx_topk": True}, None),
    ({"approx_knn": True}, ("context_extractor.graph_approx", True)),
    ({"remat": True}, ("update_iter.remat", "full")),
    ({"remat_policy": "dots"}, ("update_iter.remat", "dots")),
])
def test_model_config_takes_the_levers(kw, reaches):
    """The memory levers the JAX package honors are taken, and reach the
    module that runs them (their results: ``tests/test_torch_levers.py``;
    ``corr_chunk`` and ``approx_topk`` go to ``corr_init`` at the call)."""
    jconfig.ModelConfig(**kw)
    cfg = tconfig.ModelConfig(**kw)
    for name, value in kw.items():
        assert getattr(cfg, name) == value
    if reaches is not None:
        from pvraft_tpu_torch.models import PVRaft

        path, want = reaches
        obj = PVRaft(cfg)
        for part in path.split("."):
            obj = getattr(obj, part)
        assert obj == want


@pytest.mark.parametrize("kw", [
    {"remat_policy": "bogus"}, {"corr_knn": 33, "truncate_k": 32},
    {"approx_topk": True, "seq_shard": True},
    {"corr_chunk": 64, "seq_shard": True},
    {"approx_knn": True, "graph_chunk": 64},
    {"approx_knn": True, "seq_shard": True},
])
def test_model_config_rejects_like_jax(kw):
    with pytest.raises(ValueError):
        jconfig.ModelConfig(**kw)
    with pytest.raises(ValueError):
        tconfig.ModelConfig(**kw)


def test_use_pallas_auto_resolves_per_tensor():
    cpu = torch.zeros(1)
    for kernel in ("corr_lookup", "voxel_corr", "gru_iter"):
        assert tconfig.resolve_use_pallas(tconfig.ModelConfig(), cpu,
                                          kernel) is False
        assert tconfig.resolve_use_pallas(
            tconfig.ModelConfig(use_pallas=True), cpu, kernel)
