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
(:func:`corr_lookup_general`; one warp per point, each candidate read
once in chunks of 512, every level of a pass binned from the same
registers into per-level tables of R^3 rows, the kNN by the same radix
select and a sort of the knn selected only; :func:`general_lookup_plan`
sets the levels per pass and the points per block), which the voxel
Function (``voxel_corr.py``) launches too, with knn = 0.

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
from typing import NamedTuple, Optional, Tuple

import torch

from pvraft_tpu_torch.ops import cuda as _cuda
from pvraft_tpu_torch.ops import kernel_bounds
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


CHUNK = 512            # candidates per chunk: 16 per lane of the warp
SMEM_SM = 233472       # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024  # of it, reserved by the runtime for each block
REG_WARPS = 16         # warps per SM at the kernel's 128-register cap


class GeneralPlan(NamedTuple):
    """The general kernel's launch: ``warps`` query points per block,
    ``levels_per_pass`` voxel levels binned per pass over the candidates,
    ``smem`` dynamic shared memory bytes per block and the ``resident``
    warps per SM that the shared memory and the register cap allow."""

    warps: int
    levels_per_pass: int
    smem: int
    resident: int


def general_layout_words(k: int, knn: int, resolution: int, num_levels: int,
                         levels_per_pass: int) -> int:
    """One query point's shared words (``layout()`` of
    ``csrc/corr_lookup_general.cu``): the pass's sum tables and a dump row,
    the count table (R^3 + 1 rows of 32 each), or the kNN list (keys and
    indices over the power of two >= knn) where that is larger, rounded up
    to 32 words; then, past two chunks of 512 candidates with a kNN, every
    candidate's distance key."""
    chunks = -(-k // CHUNK)
    r3 = resolution**3
    sort_len = 1 << (knn - 1).bit_length() if knn > 0 else 0
    tables = ((levels_per_pass * r3 + 1 + r3 + 1) * 32
              if num_levels > 0 else 0)
    front = -(-max(tables, 2 * sort_len) // 32) * 32
    return front + (chunks * CHUNK if knn > 0 and chunks > 2 else 0)


def _resident(words: int) -> Tuple[int, int]:
    """(resident warps per SM, warps per block) for a point's ``words``:
    the block size (1 to 4 points) that keeps the most warps resident, the
    larger on a tie; (0, 0) if one point does not fit a block."""
    best = (0, 0)
    for w in range(1, 5):
        block = 4 * w * words
        if block > _cuda.SMEM_MAX:
            break
        blocks = min(32, SMEM_SM // (block + BLOCK_RESERVED))
        best = max(best, (min(REG_WARPS, w * blocks), w))
    return best


def general_lookup_plan(k: int, knn: int, resolution: int,
                        num_levels: int) -> GeneralPlan:
    """The general kernel's launch for K candidates, a kNN of ``knn``,
    ``resolution`` and ``num_levels``. The levels per pass: as many as
    keep the resident warps at the most that one level per pass allows
    (capped at REG_WARPS) and the packed counts allow (fields of
    bit_length(16 * chunks) bits in 32), spread evenly over the passes:
    every level in one pass at R 3 (one read of each candidate), one a
    pass at R 5, whose 125-row table is 16 KB. Raises, naming the limit,
    where one point needs more shared memory than a block can have."""
    if k < 1 or not 0 <= knn <= k or resolution < 1 or num_levels < 0:
        raise ValueError(f"corr_lookup_general: needs K >= 1, 0 <= knn <= "
                         f"K, resolution >= 1 and levels >= 0; got K={k}, "
                         f"knn={knn}, resolution={resolution}, "
                         f"levels={num_levels}")
    bits = (16 * -(-k // CHUNK)).bit_length()
    most = min(num_levels, 32 // bits)

    def plan(per_pass):
        words = general_layout_words(k, knn, resolution, num_levels,
                                     per_pass)
        return words, _resident(words)

    per_pass = min(num_levels, 1)
    words, (resident, warps) = plan(per_pass)
    if not warps:
        raise ValueError(
            f"corr_lookup_general: K={k}, knn={knn} at resolution "
            f"{resolution} needs {4 * words} bytes of shared memory per "
            f"query point, above the {_cuda.SMEM_MAX} a block can have on "
            f"the H100")
    for p in range(2, most + 1):
        passes = -(-num_levels // p)
        balanced = -(-num_levels // passes)
        w_p, (r_p, b_p) = plan(balanced)
        if b_p and r_p >= resident:
            per_pass, words, warps = balanced, w_p, b_p
    return GeneralPlan(warps, per_pass, 4 * warps * words,
                       _resident(words)[0])


def general_resident_warps(k: int, knn: int, resolution: int,
                           num_levels: int) -> int:
    """The warps per SM that the general kernel's launch at these shapes
    keeps resident on the current card, as the CUDA occupancy calculator
    gives it (registers and shared memory): the measured counterpart of
    ``general_lookup_plan(...).resident``. Needs a CUDA device."""
    plan = general_lookup_plan(k, knn, resolution, num_levels)
    fn = _cuda.library("corr_lookup_general").pvraft_corr_lookup_general_resident
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    warps = fn(k, knn, plan.warps, plan.smem)
    if warps < 0:
        raise RuntimeError("corr_lookup_general: occupancy query failed")
    return warps


def _general_signature(fn) -> None:
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    plan = general_lookup_plan(k, knn, resolution, num_levels)
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
                  resolution, knn, plan.levels_per_pass, plan.warps,
                  plan.smem, int(_cuda.vector_loads(k, corr, pts)),
                  int(_cuda.reciprocal_is_exact(base_scale, num_levels)),
                  _cuda.stream_ptr(dev))
    _cuda.check(code, what)
    _cuda.record_launch(corr_lookup_general, dev)
    return vox, kcorr, krel, kidx


class _FusedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, corr, xyz, coords, num_levels, base_scale, resolution,
                knn):
        run = _launch if corr.is_cuda else corr_lookup_plain
        with kernel_bounds.kernel_scope(
                kernel_bounds.lookup_cost, *corr.shape, num_levels,
                resolution, knn) as scope:
            out = run(corr, xyz, coords, num_levels, base_scale, resolution,
                      knn)
            scope.done(out)
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
