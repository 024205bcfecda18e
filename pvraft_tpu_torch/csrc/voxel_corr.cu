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
// arithmetic (per candidate and level 3 multiplies or divisions, the
// range test and two shared-memory adds) stays below the fp32 ridge.
//
// Design: the voxel half of corr_lookup.cu with rel read directly instead
// of xyz - coords. One warp per query point, lane l holding candidates
// 128g + 4l + e in registers after one read of 16-byte vector loads (a K
// that is not a multiple of 4 takes scalar loads of the same slots); the
// binning is voxel_means (voxel_bins.cuh, the one source shared with the
// lookup): no division where every level's r is a power of two, rint and
// the range test by one add, a conflict-free per-warp 27 x 32 table of
// lane-private partial sums (plus a dump row, so no branch per candidate)
// with packed integer counts, reduced in a fixed order, so no float
// atomics and two launches are bitwise equal (the determinism claim of
// pvraft_tpu/ops/pallas/voxel_corr.py:21-22). 5 blocks of 4 warps per SM
// at 96 registers without spills.

#include <cuda_runtime.h>

#include "voxel_bins.cuh"

namespace {

using pvraft::kCells;
using pvraft::kMaxPerLane;
using pvraft::kWarp;
constexpr int kWarpsPerBlock = 4;
// 5 blocks (20 warps) per SM: 96 registers, no spills; 6 spill.
constexpr int kMinBlocks = 5;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp, kMinBlocks)
voxel_corr_kernel(const float* __restrict__ corr,
                  const float* __restrict__ rel, float* __restrict__ out,
                  int rows, int n, int k, int num_levels, float base_scale,
                  int vec, int reciprocal) {
  __shared__ float s_tab[kWarpsPerBlock][pvraft::kTableWords];
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + w;
  if (row >= rows) return;  // a whole warp leaves; no block barrier is used

  float cv[kMaxPerLane], rx[kMaxPerLane], ry[kMaxPerLane], rz[kMaxPerLane];
  pvraft::load_candidates<false>(corr + row * k, rel + row * k * 3, k,
                                 vec != 0, 0.f, 0.f, 0.f, lane, cv, rx, ry,
                                 rz);
  pvraft::clear_tables(s_tab[w], lane);
  pvraft::voxel_means(cv, rx, ry, rz, num_levels, base_scale,
                      reciprocal != 0, n, s_tab[w], lane,
                      out + row * num_levels * kCells);
}

}  // namespace

// rows = B * N query points; n = N (the count clamp); k = candidates per
// point (<= 512); resolution 3. vec: k % 4 == 0 and corr, rel 16-byte
// aligned. reciprocal: every level's r is a power of two with a normal
// reciprocal. Returns cudaGetLastError() after the launch.
extern "C" int pvraft_voxel_corr(const float* corr, const float* rel,
                                 float* out, int rows, int n, int k,
                                 int num_levels, float base_scale, int vec,
                                 int reciprocal, void* stream) {
  if (rows > 0) {
    const int grid = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    voxel_corr_kernel<<<grid, kWarpsPerBlock * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        corr, rel, out, rows, n, k, num_levels, base_scale, vec, reciprocal);
  }
  return static_cast<int>(cudaGetLastError());
}
