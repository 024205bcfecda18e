// Voxel-branch correlation pooling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pvraft_tpu/ops/pallas/voxel_corr.py
// (_voxel_forward_pallas / _voxel_kernel, public voxel_bin_means_pallas).
// For every query point it reads the K truncated candidates' correlation
// and offsets rel once and writes the num_levels x 27 per-cell means: per
// level l (edge r = base_scale * 2^l) each candidate's cell d = rint(rel/r),
// valid iff every |d| <= 1; out = sum(valid * corr) / clamp(count, 1, N).
//
// Bound on the H100: bytes. Each launch must read corr (4K B per point)
// and rel (12K B per point) once and write 4 * L * 27 B per point; the
// arithmetic (per candidate and level 3 divisions, 3 roundings, 3 range
// tests and two shared-memory adds) stays below the fp32 ridge.
//
// Design: the voxel half of corr_lookup.cu with rel read directly instead
// of xyz - coords. One warp per query point, lane l holding candidates
// l, l+32, ... in registers after one coalesced read; the binning is
// voxel_means (voxel_bins.cuh, the one source shared with the lookup): a
// per-warp 27 x 33 shared table of lane-private partial sums reduced in
// lane order, so no float atomics and two launches are bitwise equal (the
// determinism claim of pvraft_tpu/ops/pallas/voxel_corr.py:21-22).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "voxel_bins.cuh"

namespace {

using pvraft::kCells;
using pvraft::kMaxPerLane;
using pvraft::kPad;
using pvraft::kWarp;
constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
voxel_corr_kernel(const float* __restrict__ corr,
                  const float* __restrict__ rel, float* __restrict__ out,
                  int rows, int n, int k, int num_levels, float base_scale) {
  __shared__ float s_sum[kWarpsPerBlock][kCells * kPad];
  __shared__ float s_cnt[kWarpsPerBlock][kCells * kPad];
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + w;
  if (row >= rows) return;  // a whole warp leaves; no block barrier is used

  const float* c_row = corr + row * k;
  const float* r_row = rel + row * k * 3;
  float cv[kMaxPerLane], rx[kMaxPerLane], ry[kMaxPerLane], rz[kMaxPerLane];
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    const int j = c * kWarp + lane;
    if (j < k) {
      cv[c] = __ldg(c_row + j);
      rx[c] = __ldg(r_row + 3 * j + 0);
      ry[c] = __ldg(r_row + 3 * j + 1);
      rz[c] = __ldg(r_row + 3 * j + 2);
    } else {  // missing candidate: never valid
      cv[c] = 0.f;
      rx[c] = ry[c] = rz[c] = CUDART_INF_F;
    }
  }
  pvraft::voxel_means(cv, rx, ry, rz, num_levels, base_scale, (float)n,
                      s_sum[w], s_cnt[w], lane,
                      out + row * num_levels * kCells);
}

}  // namespace

// rows = B * N query points; n = N (the count clamp); k = candidates per
// point (<= 512); resolution 3. Returns cudaGetLastError() after the launch.
extern "C" int pvraft_voxel_corr(const float* corr, const float* rel,
                                 float* out, int rows, int n, int k,
                                 int num_levels, float base_scale,
                                 void* stream) {
  if (rows > 0) {
    const int grid = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    voxel_corr_kernel<<<grid, kWarpsPerBlock * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        corr, rel, out, rows, n, k, num_levels, base_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
