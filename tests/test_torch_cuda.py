"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(the check is made inside the fixture, never at import). On a machine
with the card: ``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
Shapes are small and ragged (tails of warps and of point tiles); the
flagship shapes are ``chip_smoke.py``'s. Bars: identical kNN indices,
atol 1e-5, bitwise-equal repeated launches.
"""

import numpy as np
import pytest
import torch

from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.ops.cuda import corr_lookup as lk
from pvraft_tpu_torch.ops.cuda import gru_iter as gr
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


@pytest.mark.parametrize("n", [37, 2056])
def test_gru_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(1)

    def a(*s, scale=0.15):
        return torch.from_numpy((scale * rng.normal(size=s)).astype(np.float32)).to(dev)

    h = 64
    w = gr.pack_gru_weights((a(h, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3)),
                            (a(3 * h, h), a(h), a(3 * h, h), a(h), a(3 * h, h), a(h)),
                            h, h)
    args = (torch.tanh(a(2, n, h, scale=1.0)), torch.relu(a(2, n, h, scale=1.0)),
            a(2, n, h, scale=1.0), gr.pad_flow(a(2, n, 3)).contiguous(), w)
    before = gr.fused_gru_update.launches
    got = gr.fused_gru_update(*args)
    assert gr.fused_gru_update.launches == before + 1
    torch.testing.assert_close(got, gr.gru_math(*args), rtol=1e-5, atol=1e-5)
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
