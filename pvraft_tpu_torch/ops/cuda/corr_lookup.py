"""Fused point-voxel correlation lookup: CUDA kernel, plain version, gradient.

Replaces the Pallas TPU kernel ``pvraft_tpu/ops/pallas/corr_lookup.py``
(``_fused_forward``, public ``fused_corr_lookup``). The kernel is
``csrc/corr_lookup.cu``; its header states the bound (bytes: one read of
the (B, N, K) candidates, 8 KB per point at K = 512) and the design: one
warp per query point, 16 candidates per lane in registers after 16-byte
loads; the voxel binning of ``csrc/voxel_bins.cuh`` (a reciprocal multiply
where every level's edge is a power of two, a conflict-free shared table
reduced in a fixed order, integer counts); the kNN by a radix select of
the knn-th distance, a compaction in candidate order and a warp bitonic
sort, which gives a stable sort's order.

:func:`fused_corr_lookup` is a ``torch.autograd.Function``. Its forward
launches the kernel for CUDA tensors and runs :func:`corr_lookup_plain`
for CPU tensors; its backward is the JAX ``_fused_bwd``
(``corr_lookup.py:182-198``) in plain PyTorch, gradient to ``corr`` only:
the voxel backward (:func:`~pvraft_tpu_torch.ops.voxel.voxel_bwd`) plus
the kNN branch's cotangent scattered onto the forward's own selected
indices. On tie-free inputs that equals JAX's ``lax.top_k``
re-selection, and on ties it keeps forward and backward on the same
candidates. Its ``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pvraft_tpu_torch.ops import cuda as _cuda
from pvraft_tpu_torch.ops.corr import knn_select, take_candidates
from pvraft_tpu_torch.ops.voxel import voxel_bin_means, voxel_bwd

MAX_KNN = 32           # one sorted (distance, index) pair per lane

Lookup = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def corr_lookup_plain(corr, xyz, coords, num_levels: int, base_scale: float,
                      resolution: int, knn: int) -> Lookup:
    """The lookup in plain PyTorch: ``rel`` materialized, the voxel means
    by :func:`voxel_bin_means`, the kNN by a stable sort (lowest index
    wins ties, the kernel's rule). Returns (vox (B, N, L*R^3), knn_corr
    (B, N, knn), knn_rel (B, N, knn, 3), knn_idx (B, N, knn) int32)."""
    rel = xyz - coords[:, :, None, :]
    vox = voxel_bin_means(corr, rel, num_levels, base_scale, resolution)
    idx = knn_select(rel, knn)
    knn_corr, knn_rel = take_candidates(corr, rel, idx)
    return vox, knn_corr, knn_rel, idx.to(torch.int32)


def _signature(fn) -> None:
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _launch(corr: torch.Tensor, xyz: torch.Tensor, coords: torch.Tensor,
            num_levels: int, base_scale: float, resolution: int,
            knn: int) -> Lookup:
    b, n, k = corr.shape
    what = "fused_corr_lookup"
    _cuda.require_cuda(what, corr, xyz, coords)
    if xyz.shape != (b, n, k, 3) or coords.shape != (b, n, 3):
        raise ValueError(f"{what}: shapes {tuple(corr.shape)}, "
                         f"{tuple(xyz.shape)}, {tuple(coords.shape)}")
    if k > _cuda.MAX_CANDIDATES or knn > min(MAX_KNN, k) or resolution != 3:
        raise ValueError(
            f"{what}: the kernel takes K <= {_cuda.MAX_CANDIDATES}, knn <= "
            f"min({MAX_KNN}, K) and resolution 3; got K={k}, knn={knn}, "
            f"resolution={resolution}")
    r3 = resolution**3
    vox = torch.empty(b, n, num_levels * r3, device=corr.device)
    kcorr = torch.empty(b, n, knn, device=corr.device)
    krel = torch.empty(b, n, knn, 3, device=corr.device)
    kidx = torch.empty(b, n, knn, dtype=torch.int32, device=corr.device)
    fn = _cuda.library("corr_lookup").pvraft_corr_lookup
    _signature(fn)
    with torch.cuda.device(corr.device):
        code = fn(corr.data_ptr(), xyz.data_ptr(), coords.data_ptr(),
                  vox.data_ptr(), kcorr.data_ptr(), krel.data_ptr(),
                  kidx.data_ptr(), b * n, n, k, num_levels, base_scale, knn,
                  int(_cuda.vector_loads(k, corr, xyz)),
                  int(_cuda.reciprocal_is_exact(base_scale, num_levels)),
                  _cuda.stream_ptr(corr.device))
    _cuda.check(code, what)
    fused_corr_lookup.launches += 1
    return vox, kcorr, krel, kidx


class _FusedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, corr, xyz, coords, num_levels, base_scale, resolution,
                knn):
        run = _launch if corr.is_cuda else corr_lookup_plain
        out = run(corr, xyz, coords, num_levels, base_scale, resolution, knn)
        ctx.save_for_backward(corr, xyz, coords, out[3])
        ctx.geometry = (num_levels, base_scale, resolution)
        ctx.mark_non_differentiable(out[3])
        return out

    @staticmethod
    def backward(ctx, g_vox, g_kcorr, _g_krel, _g_kidx):
        corr, xyz, coords, kidx = ctx.saved_tensors
        rel = xyz - coords[:, :, None, :]
        dcorr = voxel_bwd(corr, rel, g_vox, *ctx.geometry)
        dcorr = dcorr.scatter_add(-1, kidx.long(), g_kcorr)
        return dcorr, None, None, None, None, None, None


def fused_corr_lookup(corr: torch.Tensor, xyz: torch.Tensor,
                      coords: torch.Tensor, num_levels: int,
                      base_scale: float, resolution: int, knn: int) -> Lookup:
    """Both lookup branches from the cached candidates.

    corr: (B, N, K) f32, xyz: (B, N, K, 3) f32 candidate positions,
    coords: (B, N, 3) f32 current estimates. Returns (vox, knn_corr,
    knn_rel, knn_idx) as :func:`corr_lookup_plain` does. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise. Gradients
    reach ``corr`` only.
    """
    return _FusedLookup.apply(corr, xyz, coords, num_levels, base_scale,
                              resolution, knn)


fused_corr_lookup.launches = 0
