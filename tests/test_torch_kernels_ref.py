"""The port's kernel modules on the CPU: each kernel's plain version
against the JAX kernel it replaces, the CPU dispatch of the wrappers, and
the package's import boundary.

On the CPU the wrappers take the plain version, so these tests reach the
plain arithmetic and everything around the kernels (shapes, padding,
packing); the CUDA kernels themselves are held against the plain versions
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).

The JAX kernels run here as the JAX package's own tests run them: Pallas
in interpret mode (automatic on the CPU), plus their XLA twins.
Tolerances: the lookup 1e-5 (the kNN selections are identical, the voxel
sums run in another order); the GRU rtol/atol 1e-5, the bar of
``tests/test_fused_gru.py``.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pvraft_tpu.ops.corr import CorrState as JCorrState
from pvraft_tpu.ops.corr import knn_lookup as jknn_lookup
from pvraft_tpu.ops.pallas import corr_lookup as jlookup
from pvraft_tpu.ops.pallas import gru_iter as jgru
from pvraft_tpu.ops.voxel import voxel_bin_means as jvoxel_bin_means
from pvraft_tpu_torch.ops import cuda as tcuda
from pvraft_tpu_torch.ops.cuda import corr_lookup as tlookup
from pvraft_tpu_torch.ops.cuda import gru_iter as tgru

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _lookup_inputs(seed, b=1, n=32, k=16):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    xyz = (coords[:, :, None, :]
           + rng.normal(0, 0.6, (b, n, k, 3))).astype(np.float32)
    corr = rng.normal(size=(b, n, k)).astype(np.float32)
    return corr, xyz, coords


# --- kernel 1: the fused correlation lookup ---------------------------------


def test_plain_lookup_matches_interpreted_pallas_and_xla():
    corr, xyz, coords = _lookup_inputs(0)
    knn = 8
    jv, jk, jr = jlookup.fused_corr_lookup(
        jnp.asarray(corr), jnp.asarray(xyz), jnp.asarray(coords),
        3, 0.25, 3, knn)
    tv, tk, tr, ti = tlookup.corr_lookup_plain(
        torch.from_numpy(corr), torch.from_numpy(xyz),
        torch.from_numpy(coords), 3, 0.25, 3, knn)
    for want, got in ((jv, tv), (jk, tk), (jr, tr)):
        np.testing.assert_allclose(np.asarray(want), got.numpy(),
                                   rtol=0, atol=1e-5)
    # The XLA path of the JAX package: voxel_bin_means + knn_lookup.
    rel = xyz - coords[:, :, None, :]
    xv = jvoxel_bin_means(jnp.asarray(corr), jnp.asarray(rel), 3, 0.25, 3)
    xk, xr = jknn_lookup(JCorrState(jnp.asarray(corr), jnp.asarray(xyz)),
                         jnp.asarray(rel), knn)
    for want, got in ((xv, tv), (xk, tk), (xr, tr)):
        np.testing.assert_allclose(np.asarray(want), got.numpy(),
                                   rtol=0, atol=1e-5)
    # The indices select exactly the returned candidates, nearest first.
    assert ti.dtype == torch.int32 and ti.shape == (1, 32, knn)
    np.testing.assert_array_equal(
        np.take_along_axis(corr, ti.numpy().astype(np.int64), -1), tk.numpy())
    d = (tr * tr).sum(-1)
    assert bool((d[..., 1:] >= d[..., :-1]).all())


def test_lookup_wrapper_takes_plain_path_on_cpu():
    corr, xyz, coords = _lookup_inputs(1, b=2, n=24, k=32)
    args = (torch.from_numpy(corr), torch.from_numpy(xyz),
            torch.from_numpy(coords), 3, 0.25, 3, 8)
    before = tlookup.fused_corr_lookup.launches
    got = tlookup.fused_corr_lookup(*args)
    want = tlookup.corr_lookup_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tlookup.fused_corr_lookup.launches == before


# --- kernel 2: the fused GRU update -----------------------------------------


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


def test_pack_and_pad_match_jax_exactly():
    me, gru, _, _, _, flow = _gru_inputs(2)
    jw = jgru.pack_gru_weights(tuple(map(jnp.asarray, me)),
                               tuple(map(jnp.asarray, gru)), 64, 64)
    tw = tgru.pack_gru_weights(tuple(map(torch.from_numpy, me)),
                               tuple(map(torch.from_numpy, gru)), 64, 64)
    assert len(jw) == len(tw) == 8
    for j, t in zip(jw, tw):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(np.asarray(jgru.pad_flow(jnp.asarray(flow))),
                                  tgru.pad_flow(torch.from_numpy(flow)).numpy())


def test_plain_gru_matches_jax_reference_and_interpreted_pallas():
    me, gru, net, inp, cor, flow = _gru_inputs(3)
    jw = jgru.pack_gru_weights(tuple(map(jnp.asarray, me)),
                               tuple(map(jnp.asarray, gru)), 64, 64)
    jargs = (jnp.asarray(net), jnp.asarray(inp), jnp.asarray(cor),
             jgru.pad_flow(jnp.asarray(flow)), jw)
    ref = jgru._gru_reference(*jargs, "float32")
    pallas = jgru.fused_gru_update(*jargs, "float32", 512)
    tw = tgru.pack_gru_weights(tuple(map(torch.from_numpy, me)),
                               tuple(map(torch.from_numpy, gru)), 64, 64)
    got = tgru.gru_math(torch.from_numpy(net), torch.from_numpy(inp),
                        torch.from_numpy(cor),
                        tgru.pad_flow(torch.from_numpy(flow)), tw)
    for want in (ref, pallas):
        np.testing.assert_allclose(np.asarray(want), got.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_gru_wrapper_takes_plain_path_on_cpu():
    me, gru, net, inp, cor, flow = _gru_inputs(4, n=20)
    tw = tgru.pack_gru_weights(tuple(map(torch.from_numpy, me)),
                               tuple(map(torch.from_numpy, gru)), 64, 64)
    args = (torch.from_numpy(net), torch.from_numpy(inp), torch.from_numpy(cor),
            tgru.pad_flow(torch.from_numpy(flow)), tw)
    before = tgru.fused_gru_update.launches
    assert torch.equal(tgru.fused_gru_update(*args), tgru.gru_math(*args))
    assert tgru.fused_gru_update.launches == before


# --- build and import boundary ----------------------------------------------


def test_kernel_sources_and_lazy_build():
    assert set(tcuda.sources()) == {"corr_lookup", "gru_iter", "voxel_corr"}
    for path in tcuda.sources().values():
        with open(path) as f:
            src = f.read()
        assert 'extern "C"' in src and "cudaGetLastError" in src
    # One binning source for both voxel kernels; the build hash covers it.
    for name in ("corr_lookup", "voxel_corr"):
        with open(tcuda.sources()[name]) as f:
            assert '#include "voxel_bins.cuh"' in f.read()
    assert "arch=compute_90a,code=sm_90a" in tcuda.NVCC_FLAGS
    # Importing every module of the port and running its CPU path builds
    # and loads nothing (a fresh interpreter: this one may hold a build).
    code = (
        "import importlib, pkgutil, torch\n"
        "import pvraft_tpu_torch as p\n"
        "from pvraft_tpu_torch.ops import cuda\n"
        "for m in pkgutil.walk_packages(p.__path__, 'pvraft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from pvraft_tpu_torch.ops.cuda.corr_lookup import fused_corr_lookup\n"
        "fused_corr_lookup(torch.zeros(1, 4, 4), torch.zeros(1, 4, 4, 3),\n"
        "                  torch.zeros(1, 4, 3), 3, 0.25, 3, 2)\n"
        "assert cuda.build_all.cache_info().currsize == 0\n"
        "assert cuda.library.cache_info().currsize == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pvraft_tpu"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "pvraft_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
