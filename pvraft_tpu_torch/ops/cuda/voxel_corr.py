"""Voxel-branch correlation pooling: CUDA kernel, plain version, gradient.

Replaces the Pallas TPU kernel ``pvraft_tpu/ops/pallas/voxel_corr.py``
(``_voxel_forward_pallas``, public ``voxel_bin_means_pallas``). The kernel
is ``csrc/voxel_corr.cu``; its header states the bound (bytes: one read
of the (B, N, K) correlation and (B, N, K, 3) offsets) and the design
(one warp per query point, 16-byte loads, the binning of
``csrc/voxel_bins.cuh`` shared with the lookup kernel: a reciprocal
multiply where every level's edge is a power of two, a conflict-free
shared table reduced in a fixed order, integer counts).

:func:`voxel_bin_means_pallas` is a ``torch.autograd.Function``: its
forward launches the tuned kernel where it takes the shapes, else the
general one, for CUDA tensors, and runs
:func:`~pvraft_tpu_torch.ops.voxel.voxel_bin_means` for CPU tensors; its
backward is :func:`~pvraft_tpu_torch.ops.voxel.voxel_bwd` (the JAX
``_voxel_bwd``), gradient to ``corr`` only. Its ``launches`` attribute
counts eager kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from pvraft_tpu_torch.ops import cuda as _cuda
from pvraft_tpu_torch.ops.cuda.corr_lookup import corr_lookup_general
from pvraft_tpu_torch.ops.voxel import voxel_bin_means, voxel_bwd


def _signature(fn) -> None:
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _launch(corr: torch.Tensor, rel: torch.Tensor, num_levels: int,
            base_scale: float, resolution: int) -> torch.Tensor:
    b, n, k = corr.shape
    what = "voxel_bin_means_pallas"
    _cuda.require_cuda(what, corr, rel)
    if rel.shape != (b, n, k, 3):
        raise ValueError(f"{what}: shapes {tuple(corr.shape)}, "
                         f"{tuple(rel.shape)}")
    if _cuda.lookup_variant(k, 0, resolution) == "general":
        return corr_lookup_general(corr, rel, None, num_levels, base_scale,
                                   resolution, 0)[0]
    _cuda.check_capturable(what, corr.device)
    out = torch.empty(b, n, num_levels * resolution**3, device=corr.device)
    fn = _cuda.library("voxel_corr").pvraft_voxel_corr
    _signature(fn)
    with torch.cuda.device(corr.device):
        code = fn(corr.data_ptr(), rel.data_ptr(), out.data_ptr(), b * n, n,
                  k, num_levels, base_scale,
                  int(_cuda.vector_loads(k, corr, rel)),
                  int(_cuda.reciprocal_is_exact(base_scale, num_levels)),
                  _cuda.stream_ptr(corr.device))
    _cuda.check(code, what)
    _cuda.record_launch(voxel_bin_means_pallas, corr.device)
    return out


class _VoxelBinMeans(torch.autograd.Function):
    @staticmethod
    def forward(ctx, corr, rel, num_levels, base_scale, resolution):
        ctx.save_for_backward(corr, rel)
        ctx.geometry = (num_levels, base_scale, resolution)
        if not corr.is_cuda:
            return voxel_bin_means(corr, rel, num_levels, base_scale,
                                   resolution)
        return _launch(corr, rel, num_levels, base_scale, resolution)

    @staticmethod
    def backward(ctx, g):
        corr, rel = ctx.saved_tensors
        return voxel_bwd(corr, rel, g, *ctx.geometry), None, None, None, None


def voxel_bin_means_pallas(corr: torch.Tensor, rel: torch.Tensor,
                           num_levels: int, base_scale: float,
                           resolution: int = 3) -> torch.Tensor:
    """Per-cell mean correlation of every pyramid level.

    corr: (B, N, K) f32, rel: (B, N, K, 3) f32 candidate offsets from the
    current estimate. Returns (B, N, num_levels * resolution**3). CPU tensors take
    the plain version; CUDA tensors launch the tuned kernel where it takes
    the shapes, else the general one, or raise. Gradients reach ``corr``
    only.
    """
    return _VoxelBinMeans.apply(corr, rel, num_levels, base_scale, resolution)


voxel_bin_means_pallas.launches = 0
