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
// and xyz (12K B per point) once; the arithmetic is ~30 ops per byte read
// below the fp32 ridge. The design keeps every candidate in registers
// after one read: one warp per query point, lane l holding candidates
// l, l+32, ... (coalesced loads), and nothing but the outputs is written.
//
// Design against the TPU habit:
//   * the voxel branch is voxel_means (voxel_bins.cuh, shared with
//     voxel_corr.cu): each candidate's cell index computed directly and
//     added into a lane-private column of a per-warp shared-memory table
//     (27 cells x 33 padded lanes), the 27 cell sums then reduced over
//     lanes in lane order. No float atomics and a fixed summation order,
//     so repeated launches are bitwise equal (the determinism claim of
//     pvraft_tpu/ops/pallas/voxel_corr.py:21-22);
//   * the kNN branch is knn rounds of a warp-shuffle argmin on
//     (dist, index) pairs: no sort, no shared memory;
//   * rounding is rintf (half to even, like jnp.round / torch.round),
//     offsets are divided by r (not multiplied by 1/r), and the distance
//     and offsets use explicit _rn intrinsics so nvcc cannot contract
//     them into FMAs that the plain PyTorch version would not do.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "voxel_bins.cuh"

namespace {

using pvraft::kCells;
using pvraft::kMaxPerLane;
using pvraft::kPad;
using pvraft::kWarp;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
corr_lookup_kernel(const float* __restrict__ corr,
                   const float* __restrict__ xyz,
                   const float* __restrict__ coords,
                   float* __restrict__ vox, float* __restrict__ kcorr,
                   float* __restrict__ krel, int* __restrict__ kidx,
                   int rows, int n, int k, int num_levels, float base_scale,
                   int knn) {
  __shared__ float s_sum[kWarpsPerBlock][kCells * kPad];
  __shared__ float s_cnt[kWarpsPerBlock][kCells * kPad];
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
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    const int j = c * kWarp + lane;
    if (j < k) {
      cv[c] = __ldg(c_row + j);
      rx[c] = __fsub_rn(__ldg(x_row + 3 * j + 0), cx);
      ry[c] = __fsub_rn(__ldg(x_row + 3 * j + 1), cy);
      rz[c] = __fsub_rn(__ldg(x_row + 3 * j + 2), cz);
    } else {  // missing candidate: never valid, never nearest
      cv[c] = 0.f;
      rx[c] = ry[c] = rz[c] = CUDART_INF_F;
    }
  }

  // ---- voxel branch ------------------------------------------------------
  pvraft::voxel_means(cv, rx, ry, rz, num_levels, base_scale, (float)n,
                      s_sum[w], s_cnt[w], lane,
                      vox + row * num_levels * kCells);

  // ---- kNN branch --------------------------------------------------------
  float d[kMaxPerLane];
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    d[c] = __fadd_rn(__fadd_rn(__fmul_rn(rx[c], rx[c]), __fmul_rn(ry[c], ry[c])),
                     __fmul_rn(rz[c], rz[c]));
  }
  int my_sel = 0;
  for (int t = 0; t < knn; ++t) {
    float bv = d[0];
    int bc = 0;
#pragma unroll
    for (int c = 1; c < kMaxPerLane; ++c) {
      if (d[c] < bv) {  // strict: the lower index (lower c) keeps a tie
        bv = d[c];
        bc = c;
      }
    }
    int bi = bc * kWarp + lane;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == t) my_sel = bi;
    if ((bi & (kWarp - 1)) == lane) {
      const int cs = bi / kWarp;
#pragma unroll
      for (int c = 0; c < kMaxPerLane; ++c) {
        if (c == cs) d[c] = CUDART_INF_F;
      }
    }
  }
  if (lane < knn) {
    const long long o = row * knn + lane;
    kidx[o] = my_sel;
    kcorr[o] = __ldg(c_row + my_sel);
    krel[3 * o + 0] = __fsub_rn(__ldg(x_row + 3 * my_sel + 0), cx);
    krel[3 * o + 1] = __fsub_rn(__ldg(x_row + 3 * my_sel + 1), cy);
    krel[3 * o + 2] = __fsub_rn(__ldg(x_row + 3 * my_sel + 2), cz);
  }
}

}  // namespace

// rows = B * N query points; n = N (the count clamp); k = candidates per
// point (<= 512); knn <= 32. Returns cudaGetLastError() after the launch.
extern "C" int pvraft_corr_lookup(const float* corr, const float* xyz,
                                  const float* coords, float* vox,
                                  float* kcorr, float* krel, int* kidx,
                                  int rows, int n, int k, int num_levels,
                                  float base_scale, int knn, void* stream) {
  if (rows > 0) {
    const int grid = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    corr_lookup_kernel<<<grid, kWarpsPerBlock * kWarp, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        corr, xyz, coords, vox, kcorr, krel, kidx, rows, n, k, num_levels,
        base_scale, knn);
  }
  return static_cast<int>(cudaGetLastError());
}
