"""The flagship-size parity leg: the port's PVRaft against the JAX
package's ``PVRaft.apply(use_pallas=False)`` at 8,192 points and
truncate_k 512 (the flagship ``ModelConfig``), on the CPU, on the same
weights and clouds, after 1 GRU iteration, to atol 5e-4 / rtol 1e-3: the
bar the JAX package met against the reference at the flagship shape
(``PARITY.md:144``).

The two encoders' features part by ~2e-4 (float32 sum orders of XLA and
PyTorch), and where a point's 512th and 513th correlations lie closer
than that, the two truncations keep different candidates (a selection
flip; ~1% of the points on these clouds). A flip moves that point's
flow, and the graph carries it to the points whose 32 neighbours hold
it. So the test names the flips (the two sides' float32 top-512 sets,
each from its own features), holds each to be a near-tie (gap below
1e-3) and rare (below 2% of the points), holds every point that no flip
reaches to the bar, and the points beyond it to below 2%. Marked slow:
~25 s and ~5 GB on the CPU.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.models import PVRaft as TRaft
from pvraft_tpu_torch.weights import params_from_jax

N, K = 8192, 512


@pytest.mark.slow
def test_flagship_flow_matches_jax_at_one_iteration():
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-1, 1, (1, N, 3)).astype(np.float32)
    x2 = (x1 + rng.normal(0, 0.05, (1, N, 3))).astype(np.float32)
    jm = JRaft(JConfig(use_pallas=False))
    params = jax.jit(jm.init, static_argnums=3)(
        jax.random.key(0), jnp.asarray(x1), jnp.asarray(x2), 1)
    (want, _), inter = jax.jit(lambda p, a, b: jm.apply(
        p, a, b, 1, capture_intermediates=True))(
        params, jnp.asarray(x1), jnp.asarray(x2))
    jf1, jf2 = inter["intermediates"]["feature_extractor"]["__call__"]
    tm = TRaft(TConfig())
    tm.load_state_dict(params_from_jax(params), strict=True)
    fmaps = []
    tm.feature_extractor.register_forward_hook(
        lambda mod, args, out: fmaps.append(out[0]))
    with torch.inference_mode():
        got, graph = tm(torch.from_numpy(x1), torch.from_numpy(x2), 1)
    assert got.shape == (1, 1, N, 3)

    # Each side's truncation from its own features.
    tcorr = torch.bmm(fmaps[0], fmaps[1].transpose(1, 2))[0] / math.sqrt(128)
    tkeep = torch.topk(tcorr, K, dim=-1).indices.sort(-1).values.numpy()
    jcorr = jnp.einsum("bnd,bmd->bnm", jf1[0], jf2[0])[0] / math.sqrt(128)
    jkeep = np.sort(np.asarray(jax.lax.top_k(jcorr, K)[1]), -1)
    flips = np.where((tkeep != jkeep).any(-1))[0]
    ranked = torch.sort(tcorr, -1, descending=True).values.numpy()
    gap = ranked[:, K - 1] - ranked[:, K]
    assert len(flips) < 0.02 * N
    assert (gap[flips] < 1e-3).all()

    neighbors = graph.neighbors[0].numpy()
    flipped = np.zeros(N, bool)
    flipped[flips] = True
    reached = flipped | flipped[neighbors].any(-1)
    w, g = np.asarray(want)[0, 0], got.numpy()[0, 0]
    beyond = (np.abs(w - g) > 5e-4 + 1e-3 * np.abs(g)).any(-1)
    assert beyond.sum() < 0.02 * N
    np.testing.assert_allclose(w[~reached], g[~reached], rtol=1e-3,
                               atol=5e-4)
