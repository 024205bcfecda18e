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
sort, which gives a stable sort's order. That kernel is built on its
limits (K <= 512, knn <= 32, resolution 3); every other shape the Pallas
kernel takes runs the general kernel ``csrc/corr_lookup_general.cu``
(:func:`corr_lookup_general`; one warp per point, a shared table of R^3 +
1 rows, a bitonic sort of every candidate's distance in shared memory),
which the voxel Function (``voxel_corr.py``) launches too, with knn = 0.

:func:`fused_corr_lookup` is a ``torch.autograd.Function``. Its forward
launches the tuned kernel where it takes the shapes, else the general
one, for CUDA tensors, and runs :func:`corr_lookup_plain` for CPU
tensors; its backward is the JAX ``_fused_bwd``
(``corr_lookup.py:182-198``) in plain PyTorch, gradient to ``corr`` only:
the voxel backward (:func:`~pvraft_tpu_torch.ops.voxel.voxel_bwd`) plus
the kNN branch's cotangent scattered onto the forward's own selected
indices. On tie-free inputs that equals JAX's ``lax.top_k``
re-selection, and on ties it keeps forward and backward on the same
candidates. Its ``launches`` attribute counts eager launches of the
tuned kernel, ``corr_lookup_general.launches`` those of the general one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pvraft_tpu_torch.ops import cuda as _cuda
from pvraft_tpu_torch.ops.corr import knn_select, take_candidates
from pvraft_tpu_torch.ops.voxel import voxel_bin_means, voxel_bwd

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
    """The tuned kernel where it takes the shapes, else the general one."""
    b, n, k = corr.shape
    what = "fused_corr_lookup"
    _cuda.require_cuda(what, corr, xyz, coords)
    if xyz.shape != (b, n, k, 3) or coords.shape != (b, n, 3):
        raise ValueError(f"{what}: shapes {tuple(corr.shape)}, "
                         f"{tuple(xyz.shape)}, {tuple(coords.shape)}")
    if _cuda.lookup_variant(k, knn, resolution) == "general":
        return corr_lookup_general(corr, xyz, coords, num_levels, base_scale,
                                   resolution, knn)
    _cuda.check_capturable(what, corr.device)
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
    _cuda.record_launch(fused_corr_lookup, corr.device)
    return vox, kcorr, krel, kidx


def general_lookup_plan(k: int, knn: int, resolution: int
                        ) -> Tuple[int, int, int]:
    """The general kernel's launch shape for K candidates, a kNN of
    ``knn`` and ``resolution``: (query points per block, the sort length:
    the power of two >= K when knn > 0, else 0, dynamic shared memory
    bytes). One point's warp needs 4 * (2 * (R^3 + 1) * 33 + 2 * sort
    length) bytes: the sum and count tables and the staged distances.
    Up to 4 points share a block within 48 KB; a warp above 48 KB runs
    alone, with an opt-in, up to the SMEM_MAX a block can have. Raises
    beyond that, naming the limit."""
    if k < 1 or not 0 <= knn <= k or resolution < 1:
        raise ValueError(f"corr_lookup_general: needs K >= 1, 0 <= knn <= "
                         f"K and resolution >= 1; got K={k}, knn={knn}, "
                         f"resolution={resolution}")
    sort_len = 1 << (k - 1).bit_length() if knn > 0 else 0
    per_warp = 4 * (2 * (resolution**3 + 1) * 33 + 2 * sort_len)
    if per_warp > _cuda.SMEM_MAX:
        raise ValueError(
            f"corr_lookup_general: K={k} (kNN sort of {sort_len}) at "
            f"resolution {resolution} needs {per_warp} bytes of shared "
            f"memory per query point, above the {_cuda.SMEM_MAX} a block "
            f"can have on the H100")
    warps = max(1, min(4, _cuda.SMEM_DEFAULT // per_warp))
    return warps, sort_len, warps * per_warp


def _general_signature(fn) -> None:
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def corr_lookup_general(corr: torch.Tensor, pts: torch.Tensor,
                        coords: Optional[torch.Tensor], num_levels: int,
                        base_scale: float, resolution: int,
                        knn: int) -> Lookup:
    """The general lookup kernel (``csrc/corr_lookup_general.cu``) at any
    K >= 1, 0 <= knn <= K, resolution >= 1 and number of levels. ``pts``
    is the candidates' xyz (B, N, K, 3) with ``coords`` (B, N, 3), or
    their offsets ``rel`` with ``coords=None`` (the voxel-only pass,
    knn = 0). Returns (vox, knn_corr, knn_rel, knn_idx) as
    :func:`corr_lookup_plain` does. Launches the kernel or raises (CPU
    tensors take the plain version in the Functions that call this)."""
    b, n, k = corr.shape
    what = "corr_lookup_general"
    operands = (corr, pts) if coords is None else (corr, pts, coords)
    _cuda.require_cuda(what, *operands)
    if pts.shape != (b, n, k, 3) or (coords is not None
                                     and coords.shape != (b, n, 3)):
        raise ValueError(f"{what}: shapes "
                         f"{[tuple(t.shape) for t in operands]}")
    if coords is None and knn:
        raise ValueError(f"{what}: a kNN needs coords")
    warps, sort_len, smem = general_lookup_plan(k, knn, resolution)
    _cuda.check_capturable(what, corr.device)
    dev = corr.device
    vox = torch.empty(b, n, num_levels * resolution**3, device=dev)
    kcorr = torch.empty(b, n, knn, device=dev)
    krel = torch.empty(b, n, knn, 3, device=dev)
    kidx = torch.empty(b, n, knn, dtype=torch.int32, device=dev)
    fn = _cuda.library("corr_lookup_general").pvraft_corr_lookup_general
    _general_signature(fn)
    with torch.cuda.device(dev):
        code = fn(corr.data_ptr(), pts.data_ptr(),
                  None if coords is None else coords.data_ptr(),
                  vox.data_ptr(), kcorr.data_ptr(), krel.data_ptr(),
                  kidx.data_ptr(), b * n, n, k, num_levels, base_scale,
                  resolution, knn, sort_len, warps, smem,
                  _cuda.stream_ptr(dev))
    _cuda.check(code, what)
    _cuda.record_launch(corr_lookup_general, dev)
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
    the plain version; CUDA tensors launch the tuned kernel where it takes
    the shapes, else the general one, or raise. Gradients reach ``corr``
    only.
    """
    return _FusedLookup.apply(corr, xyz, coords, num_levels, base_scale,
                              resolution, knn)


fused_corr_lookup.launches = 0
corr_lookup_general.launches = 0
