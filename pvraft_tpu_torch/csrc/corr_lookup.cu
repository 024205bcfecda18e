// Fused point-voxel correlation lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pvraft_tpu/ops/pallas/corr_lookup.py
// (_fused_forward / _fused_kernel, public fused_corr_lookup). For every
// query point it reads the K truncated candidates (corr, xyz) once and
// writes both lookup branches:
//   * voxel: per level l (edge r = base_scale * 2^l) each candidate's cell
//     d = rint((xyz - coords) / r), valid iff every |d| <= 1; the output is
//     the per-cell mean  sum(valid * corr) / clamp(count, 1, N);
//   * kNN: the knn candidates nearest to coords (dist = x*x + y*y + z*z),
//     nearest first, the lowest candidate index winning ties; their corr,
//     their offsets xyz - coords, and their indices.
//
// Bound on the H100: bytes. Each launch must read corr (4K B per point)
// and xyz (12K B per point) once: 8 KB per point at K = 512, 75.1 MB at
// 1 x 8192 with the outputs, 0.0224 ms at 3.35 TB/s. The arithmetic stays
// below the fp32 ridge; the design keeps it short (no divisions, one pass
// per level over a conflict-free table, no serial argmin rounds) so that
// enough warps stay resident to keep the loads in flight.
//
// Design (one warp per query point, 4 warps per block, 5 blocks and so 20
// warps per SM at 96 registers without spills, 16 candidates per lane in
// registers after one read):
//   * loads: 16-byte vector loads, lane l holding candidates 128g + 4l + e
//     (voxel_bins.cuh::load_candidates); a K that is not a multiple of 4
//     takes scalar loads of the same slots;
//   * voxel branch: voxel_bins.cuh::voxel_means, shared with
//     voxel_corr.cu: no division where r is a power of two, rint and
//     the range test by one add of 1.5 * 2^23, a conflict-free cell-major
//     table of lane partial sums with a dump row for invalid candidates
//     (no branch per candidate), integer counts of 3 levels packed in one
//     word, and a fixed-order row reduction;
//   * kNN branch, a threshold selection: (1) the knn-th smallest
//     distance T by a radix select on the
//     float bits (a non-negative float orders like its bits), one bit per
//     step, starting below the bits that the smallest distance shares with
//     the largest lane minimum; each step a branch-free per-lane count over
//     16 registers and one __reduce_add_sync, stopping early at a prefix t
//     with exactly knn distances below it; (2) every candidate with
//     dist < T, and the lowest-index candidates with dist == T until there
//     are knn (ranked by warp prefix sums in candidate order), compacted
//     into a 32-entry shared list; (3) a warp bitonic sort of the (dist,
//     index) pairs, one per lane, index breaking ties: 15 compare-exchange
//     stages over __shfl_xor_sync. That is exactly the stable sort's order;
//   * rounding and the distance use explicit _rn intrinsics, so nvcc
//     cannot contract them into FMAs the plain PyTorch version would not
//     do; the voxel test is exact as argued in voxel_bins.cuh.
// Two launches are bitwise equal: no float atomics, fixed summation order.
// The loads go straight into registers, not through a TMA / cp.async
// double buffer in persistent warps, whose 16 KB of staging per warp would
// cut the 20 resident warps that hide the load latency; the loads alone
// run at the bytes bound (PERF.md section 6).

#include <cuda_runtime.h>

#include "voxel_bins.cuh"

namespace {

using pvraft::kCells;
using pvraft::kFull;
using pvraft::kMaxPerLane;
using pvraft::kVec;
using pvraft::kWarp;
constexpr int kWarpsPerBlock = 4;
// 5 blocks (20 warps) per SM: 96 registers, no spills; 6 spill.
constexpr int kMinBlocks = 5;
// A missing candidate's key: the largest non-negative float bits (a
// canonical NaN ties with it and wins by its lower index).
constexpr unsigned kMissing = 0x7fffffffu;

// Exclusive prefix sum of v over the lanes of the warp; total in *all.
__device__ __forceinline__ int lane_prefix(int v, int lane, int* all) {
  int incl = v;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  *all = __shfl_sync(kFull, incl, kWarp - 1);
  return incl - v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp, kMinBlocks)
corr_lookup_kernel(const float* __restrict__ corr,
                   const float* __restrict__ xyz,
                   const float* __restrict__ coords,
                   float* __restrict__ vox, float* __restrict__ kcorr,
                   float* __restrict__ krel, int* __restrict__ kidx,
                   int rows, int n, int k, int num_levels, float base_scale,
                   int knn, int vec, int reciprocal) {
  __shared__ float s_tab[kWarpsPerBlock][pvraft::kTableWords];
  __shared__ unsigned s_key[kWarpsPerBlock][kWarp];
  __shared__ int s_idx[kWarpsPerBlock][kWarp];
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + w;
  if (row >= rows) return;  // a whole warp leaves; no block barrier is used

  const float* c_row = corr + row * k;
  const float* x_row = xyz + row * k * 3;
  const float cx = coords[row * 3 + 0];
  const float cy = coords[row * 3 + 1];
  const float cz = coords[row * 3 + 2];

  float cv[kMaxPerLane], rx[kMaxPerLane], ry[kMaxPerLane], rz[kMaxPerLane];
  pvraft::load_candidates<true>(c_row, x_row, k, vec != 0, cx, cy, cz, lane,
                                cv, rx, ry, rz);

  // ---- voxel branch ------------------------------------------------------
  if (num_levels > 0) {
    pvraft::clear_tables(s_tab[w], lane);
    pvraft::voxel_means(cv, rx, ry, rz, num_levels, base_scale,
                        reciprocal != 0, n, s_tab[w], lane,
                        vox + row * num_levels * kCells);
  }
  if (knn <= 0) return;

  // ---- kNN branch --------------------------------------------------------
  unsigned key[kMaxPerLane];
#pragma unroll
  for (int s = 0; s < kMaxPerLane; ++s) {
    const float d = __fadd_rn(
        __fadd_rn(__fmul_rn(rx[s], rx[s]), __fmul_rn(ry[s], ry[s])),
        __fmul_rn(rz[s], rz[s]));
    key[s] = pvraft::candidate(s, lane) < k ? __float_as_uint(d) : kMissing;
  }

  // (1) Radix select. Invariant: below = #{key < lo} < knn, and at least
  // knn keys lie below lo + 2^(b+1). Every key and every t is < 2^31, so
  // (key - t) >> 31 is key < t without a branch. The search starts below
  // the bits shared by the smallest key and the largest lane minimum: at
  // least 32 keys (one per lane) lie at or below that maximum.
  unsigned lane_min = key[0];
#pragma unroll
  for (int s = 1; s < kMaxPerLane; ++s) lane_min = min(lane_min, key[s]);
  const unsigned kmin = __reduce_min_sync(kFull, lane_min);
  const unsigned kmax = __reduce_max_sync(kFull, lane_min);
  int top = 30;  // every real key is < 2^31
  if (kmax < kMissing) top = min(top, 31 - __clz(kmin ^ kmax));
  unsigned lo = top < 0 ? kmin : kmin & ~((2u << top) - 1u);
  int below = 0;
  bool exact = false;
  for (int b = top; b >= 0; --b) {
    const unsigned t = lo | (1u << b);
    unsigned c0 = 0, c1 = 0;
#pragma unroll
    for (int s = 0; s < kMaxPerLane; s += 2) {
      c0 += (key[s] - t) >> 31;
      c1 += (key[s + 1] - t) >> 31;
    }
    const int c = static_cast<int>(__reduce_add_sync(kFull, c0 + c1));
    if (c <= knn) {
      lo = t;
      below = c;
      if (c == knn) {  // exactly knn keys below t: that is the set
        exact = true;
        break;
      }
    }
  }

  // (2) The set: key < lo, then (unless exact) the lowest-index keys equal
  // to lo (= T, the knn-th smallest) until there are knn.
  unsigned sel = 0;
#pragma unroll
  for (int s = 0; s < kMaxPerLane; ++s) sel |= (key[s] < lo ? 1u : 0u) << s;
  const int need = exact ? 0 : knn - below;
  if (need > 0) {
    // Candidate order is group g, then lane, then e (candidate()).
    int base = 0;
#pragma unroll
    for (int g = 0; g < pvraft::kGroups; ++g) {
      unsigned tie = 0;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        tie |= (key[g * kVec + e] == lo ? 1u : 0u) << e;
      int total;
      const int before = base + lane_prefix(__popc(tie), lane, &total);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int rank = before + __popc(tie & ((1u << e) - 1u));
        if ((tie >> e & 1u) && rank < need) sel |= 1u << (g * kVec + e);
      }
      base += total;
    }
  }
  int total;
  int pos = lane_prefix(__popc(sel), lane, &total);
#pragma unroll
  for (int s = 0; s < kMaxPerLane; ++s) {
    if (sel >> s & 1u) {
      s_key[w][pos] = key[s];
      s_idx[w][pos] = pvraft::candidate(s, lane);
      ++pos;
    }
  }
  __syncwarp();
  unsigned kk = lane < knn ? s_key[w][lane] : kMissing;
  int ii = lane < knn ? s_idx[w][lane] : 0x7fffffff;

  // (3) Bitonic sort of the 32 (key, index) pairs, ascending.
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const unsigned ok = __shfl_xor_sync(kFull, kk, stride);
      const int oi = __shfl_xor_sync(kFull, ii, stride);
      const bool other_less = ok < kk || (ok == kk && oi < ii);
      const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
      if (keep_min ? other_less : !other_less) {
        kk = ok;
        ii = oi;
      }
    }
  }
  if (lane < knn) {
    const long long o = row * knn + lane;
    kidx[o] = ii;
    kcorr[o] = __ldg(c_row + ii);
    krel[3 * o + 0] = __fsub_rn(__ldg(x_row + 3 * ii + 0), cx);
    krel[3 * o + 1] = __fsub_rn(__ldg(x_row + 3 * ii + 1), cy);
    krel[3 * o + 2] = __fsub_rn(__ldg(x_row + 3 * ii + 2), cz);
  }
}

}  // namespace

// rows = B * N query points; n = N (the count clamp); k = candidates per
// point (<= 512); knn <= min(32, k). vec: k % 4 == 0 and corr, xyz 16-byte
// aligned. reciprocal: every level's r is a power of two with a normal
// reciprocal (multiply instead of divide). Returns cudaGetLastError().
extern "C" int pvraft_corr_lookup(const float* corr, const float* xyz,
                                  const float* coords, float* vox,
                                  float* kcorr, float* krel, int* kidx,
                                  int rows, int n, int k, int num_levels,
                                  float base_scale, int knn, int vec,
                                  int reciprocal, void* stream) {
  if (rows > 0) {
    const int grid = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    corr_lookup_kernel<<<grid, kWarpsPerBlock * kWarp, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        corr, xyz, coords, vox, kcorr, krel, kidx, rows, n, k, num_levels,
        base_scale, knn, vec, reciprocal);
  }
  return static_cast<int>(cudaGetLastError());
}
