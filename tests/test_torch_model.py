"""The port's stage-1 PVRaft against the JAX package's, on the same
weights and inputs, plus the parameter pin.

JAX params come from ``PVRaft.init`` and reach the port through
``params_from_jax`` (``strict=True``). Per-iteration flows agree to 2e-4
over 4 fp32 iterations, the JAX-vs-torch bar of ``PARITY.md``, with and
without the serve masks and with ``fused_gru`` both ways. The JAX side
runs its XLA path (``use_pallas=False``); its fused GRU runs in Pallas
interpret mode.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pvraft_tpu.config import ModelConfig as JConfig
from pvraft_tpu.models import PVRaft as JRaft
from pvraft_tpu_torch.config import ModelConfig as TConfig
from pvraft_tpu_torch.models import PVRaft as TRaft
from pvraft_tpu_torch.weights import params_from_jax, seeded_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
ITERS = 4
B, N = 2, 48


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    x2 = (x1 + rng.normal(0, 0.1, (B, N, 3))).astype(np.float32)
    v1 = np.ones((B, N), bool)
    v1[1, 40:] = False
    v2 = np.ones((B, N), bool)
    v2[0, 44:] = False
    params = jax.jit(JRaft(JConfig(use_pallas=False, **TINY)).init,
                     static_argnums=3)(jax.random.key(0), jnp.asarray(x1),
                                       jnp.asarray(x2), 1)
    return x1, x2, v1, v2, params


@pytest.mark.parametrize("fused_gru", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_pvraft_flows_match_jax(scene, fused_gru, masked):
    x1, x2, v1, v2, params = scene
    jm = JRaft(JConfig(use_pallas=False, fused_gru=fused_gru, **TINY))
    jargs = (jnp.asarray(x1), jnp.asarray(x2), ITERS)
    targs = (torch.from_numpy(x1), torch.from_numpy(x2), ITERS)
    if masked:
        jargs += (jnp.asarray(v1), jnp.asarray(v2))
        targs += (torch.from_numpy(v1), torch.from_numpy(v2))
    want, jgraph = jax.jit(jm.apply, static_argnums=3)(params, *jargs)
    tm = TRaft(TConfig(fused_gru=fused_gru, **TINY))
    tm.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        got, tgraph = tm(*targs)
    assert got.shape == (ITERS, B, N, 3)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(jgraph.neighbors),
                                  tgraph.neighbors.numpy())


def test_state_dict_pins_the_flagship_param_tree():
    with open(os.path.join(REPO, "artifacts", "params_tree.json")) as f:
        tree = json.load(f)
    want = {}
    for leaf in tree["leaves"]:
        path = leaf["path"].split("/")
        assert path[0] == "params"
        name = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
        shape = leaf["shape"][::-1] if path[-1] == "kernel" else leaf["shape"]
        want[".".join(path[1:-1] + [name])] = tuple(shape)
    for fused in (False, True):
        sd = TRaft(TConfig(fused_gru=fused)).state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == want
        assert len(sd) == 95
        assert sum(v.numel() for v in sd.values()) == \
            tree["total_parameters"] == 192034


def test_params_from_jax_rejects_a_foreign_leaf():
    with pytest.raises(KeyError, match="unexpected"):
        params_from_jax({"params": {"x": {"momentum": np.zeros(2)}}})


def test_seeded_state_dict_is_deterministic_and_loads():
    cfg = TConfig(**TINY)
    a, b = seeded_state_dict(cfg, 7), seeded_state_dict(cfg, 7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["update_iter.corr_lookup.out_conv1.weight"],
                           seeded_state_dict(cfg, 8)[
                               "update_iter.corr_lookup.out_conv1.weight"])
    assert torch.count_nonzero(a["update_iter.corr_lookup.out_conv1.bias"]) == 0
    TRaft(cfg).load_state_dict(a, strict=True)
