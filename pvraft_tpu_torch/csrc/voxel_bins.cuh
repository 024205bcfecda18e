// Voxel-branch binning of one query point, shared by corr_lookup.cu and
// voxel_corr.cu: the one source of the binning semantics on the card, as
// voxel_level_means (pvraft_tpu/ops/pallas/voxel_corr.py:61-89) is for the
// two Pallas kernels.
//
// One warp owns one query point; lane l holds candidates l, l+32, ... in
// registers (corr value and offset rel = candidate - coords). Per level l
// (edge r = base_scale * 2^l) each candidate's cell is d = rint(rel / r)
// per axis (half to even, like jnp.round / torch.round), valid iff every
// |d| <= 1, cell = (dx+1)*9 + (dy+1)*3 + (dz+1). Each cell's output is
// sum(valid * corr) / clamp(count, 1, n).
//
// Determinism: every lane adds into its own column of a per-warp
// 27 x 33 shared table (padded rows: the lane-order reduction reads
// conflict-free), then lane c < 27 sums row c in lane order. No float
// atomics, so two launches are bitwise equal. __fdiv_rn keeps rel / r a
// true IEEE division, as the plain PyTorch version divides by a device
// tensor (pvraft_tpu_torch/ops/voxel.py).

#pragma once

#include <cuda_runtime.h>

namespace pvraft {

constexpr int kWarp = 32;
constexpr int kCells = 27;            // resolution 3
constexpr int kPad = kWarp + 1;       // padded row: conflict-free reduction
constexpr int kMaxPerLane = 16;       // K <= 512 candidates per point

// Writes the num_levels * 27 means of one point to out_row. cv/rx/ry/rz:
// this lane's kMaxPerLane candidates (a missing candidate carries an
// infinite offset, so it is never valid). ss/sc: this warp's two
// kCells * kPad shared tables. count_cap: n, the clamp of the counts.
__device__ __forceinline__ void voxel_means(
    const float (&cv)[kMaxPerLane], const float (&rx)[kMaxPerLane],
    const float (&ry)[kMaxPerLane], const float (&rz)[kMaxPerLane],
    int num_levels, float base_scale, float count_cap, float* ss, float* sc,
    int lane, float* __restrict__ out_row) {
  for (int lvl = 0; lvl < num_levels; ++lvl) {
    const float r = base_scale * (float)(1 << lvl);
    for (int b = 0; b < kCells; ++b) {
      ss[b * kPad + lane] = 0.f;
      sc[b * kPad + lane] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kMaxPerLane; ++c) {
      const float dx = rintf(__fdiv_rn(rx[c], r));
      const float dy = rintf(__fdiv_rn(ry[c], r));
      const float dz = rintf(__fdiv_rn(rz[c], r));
      if (fabsf(dx) <= 1.f && fabsf(dy) <= 1.f && fabsf(dz) <= 1.f) {
        const int cell = (int)(dx + 1.f) * 9 + (int)(dy + 1.f) * 3 +
                         (int)(dz + 1.f);
        ss[cell * kPad + lane] += cv[c];
        sc[cell * kPad + lane] += 1.f;
      }
    }
    __syncwarp();
    if (lane < kCells) {
      float s = 0.f, cnt = 0.f;
      for (int j = 0; j < kWarp; ++j) {
        s += ss[lane * kPad + j];
        cnt += sc[lane * kPad + j];
      }
      out_row[lvl * kCells + lane] =
          __fdiv_rn(s, fminf(fmaxf(cnt, 1.f), count_cap));
    }
    __syncwarp();
  }
}

}  // namespace pvraft
