// Candidate loads and voxel-branch binning of one query point, shared by
// corr_lookup.cu and voxel_corr.cu: the one source of the binning
// semantics on the card, as voxel_level_means
// (pvraft_tpu/ops/pallas/voxel_corr.py:61-89) is for the two Pallas kernels.
//
// One warp owns one query point. Lane l holds 16 candidates in registers,
// in 4 groups of 4 neighbours: slot s = 4g + e is candidate
// 128g + 4l + e (candidate()). A group is one 16-byte load of corr and
// three of xyz, so every load of the warp is a 16-byte vector load that
// covers 512 contiguous bytes (load_candidates()). A K that is not a
// multiple of 4, or a row that is not 16-byte aligned, takes the scalar
// loads of the same slots instead: the same values, another load path.
//
// Per level l (edge r = base_scale * 2^l) each candidate's cell is
// d = rint(rel / r) per axis (half to even, like jnp.round / torch.round),
// valid iff every |d| <= 1, cell = (dx+1)*9 + (dy+1)*3 + (dz+1); each
// cell's output is sum(valid * corr) / clamp(count, 1, n). What the
// binning does about its cost:
//   * no division where r is a power of two. The host decides that
//     (ops/cuda/__init__.py::reciprocal_is_exact) and then rel * (1/r)
//     is the correctly rounded value of the same real number as rel / r,
//     so it is bitwise equal to the division the plain PyTorch version
//     makes (pvraft_tpu_torch/ops/voxel.py). Any other r keeps __fdiv_rn;
//   * rint and the range test without a rounding instruction: for |q| <
//     2^22, y = q + 1.5 * 2^23 rounds q to an integer in a binade whose
//     unit is 1, so bits(y) - bits(1.5 * 2^23) = rint(q) exactly; any
//     larger |q|, an infinity or a NaN lands far outside {-1, 0, 1}. For a
//     power-of-two r, y is one fma(rel, 1/r, 1.5 * 2^23) per axis;
//   * the per-lane partial sums sit in a per-warp 27 x 32 shared table,
//     cell-major: lane l adds into column l only, so the scatter is free
//     of bank conflicts whatever the cells. An invalid candidate adds into
//     a 28th dump row that is never read, so no candidate branches. The
//     counts of up to 3 levels share one 27 x 32 integer table, 10 bits
//     per level (a cell holds at most K <= 512 candidates), added by a
//     shared-memory integer atomic that the lane does not wait for. Lane
//     c < 27 then reduces row c, reading column c ^ j at step j: the 27
//     lanes read 27 banks, and every row is summed in one fixed order. The
//     reducer zeroes what it read, so the table is clean for the next level.
// No float atomics and a fixed summation order: two launches are bitwise
// equal (the determinism claim of pvraft_tpu/ops/pallas/voxel_corr.py:21-22).

#pragma once

#include <cuda_runtime.h>

namespace pvraft {

constexpr int kWarp = 32;
constexpr int kCells = 27;             // resolution 3
constexpr int kVec = 4;                // candidates per 16-byte group
constexpr int kGroups = 4;             // groups per lane
constexpr int kMaxPerLane = kVec * kGroups;  // 16: K <= 512 per point
constexpr int kRows = kCells + 1;      // the 27 cells and a dump row
constexpr int kTableWords = 2 * kRows * kWarp;  // sums, then counts
constexpr int kLevelsPerPass = 3;      // 10-bit counts packed per word
constexpr int kCountBits = 10;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRound = 12582912.f;   // 1.5 * 2^23
constexpr int kRoundBits = 0x4b400000; // its bits

// The candidate index of slot s of lane `lane`.
__device__ __forceinline__ int candidate(int s, int lane) {
  return (s / kVec) * (kWarp * kVec) + lane * kVec + (s % kVec);
}

// Loads this lane's candidates of one point: cv = corr, (rx, ry, rz) =
// the three coordinates minus (cx, cy, cz) when kSubtract (xyz - coords),
// else as read (rel). A missing candidate (index >= k) gets corr 0 and an
// infinite offset, so it is never in a cell. vec: k % 4 == 0 and both
// rows 16-byte aligned.
template <bool kSubtract>
__device__ __forceinline__ void load_candidates(
    const float* __restrict__ c_row, const float* __restrict__ x_row, int k,
    bool vec, float cx, float cy, float cz, int lane,
    float (&cv)[kMaxPerLane], float (&rx)[kMaxPerLane],
    float (&ry)[kMaxPerLane], float (&rz)[kMaxPerLane]) {
  if (vec) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j0 = candidate(g * kVec, lane);
      const int s = g * kVec;
      if (j0 < k) {
        const float4 c = __ldg(reinterpret_cast<const float4*>(c_row + j0));
        const float4* xp = reinterpret_cast<const float4*>(x_row + 3 * j0);
        const float4 a = __ldg(xp), b = __ldg(xp + 1), d = __ldg(xp + 2);
        cv[s] = c.x; cv[s + 1] = c.y; cv[s + 2] = c.z; cv[s + 3] = c.w;
        rx[s] = a.x; ry[s] = a.y; rz[s] = a.z;
        rx[s + 1] = a.w; ry[s + 1] = b.x; rz[s + 1] = b.y;
        rx[s + 2] = b.z; ry[s + 2] = b.w; rz[s + 2] = d.x;
        rx[s + 3] = d.y; ry[s + 3] = d.z; rz[s + 3] = d.w;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          cv[s + e] = 0.f;
          rx[s + e] = ry[s + e] = rz[s + e] = __int_as_float(0x7f800000);
        }
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < kMaxPerLane; ++s) {
      const int j = candidate(s, lane);
      if (j < k) {
        cv[s] = __ldg(c_row + j);
        rx[s] = __ldg(x_row + 3 * j + 0);
        ry[s] = __ldg(x_row + 3 * j + 1);
        rz[s] = __ldg(x_row + 3 * j + 2);
      } else {
        cv[s] = 0.f;
        rx[s] = ry[s] = rz[s] = __int_as_float(0x7f800000);
      }
    }
  }
  if (kSubtract) {
#pragma unroll
    for (int s = 0; s < kMaxPerLane; ++s) {
      rx[s] = __fsub_rn(rx[s], cx);
      ry[s] = __fsub_rn(ry[s], cy);
      rz[s] = __fsub_rn(rz[s], cz);
    }
  }
}

// rint(q) + 1 for one axis, as an unsigned value that is <= 2 iff
// |rint(q)| <= 1; y = q + 1.5 * 2^23 rounded once.
__device__ __forceinline__ unsigned shifted_cell(float y) {
  return static_cast<unsigned>(__float_as_int(y) - (kRoundBits - 1));
}

// Adds this lane's candidates of one level into column `lane` of the sum
// table and `inc` into the count table, an invalid candidate into the dump
// row (never read): no branch per candidate.
template <bool kReciprocal>
__device__ __forceinline__ void scatter_level(
    const float (&cv)[kMaxPerLane], const float (&rx)[kMaxPerLane],
    const float (&ry)[kMaxPerLane], const float (&rz)[kMaxPerLane], float r,
    int inc, float* table, int lane) {
  int* counts = reinterpret_cast<int*>(table + kRows * kWarp);
  const float inv = __frcp_rn(r);  // exact where kReciprocal
#pragma unroll
  for (int s = 0; s < kMaxPerLane; ++s) {
    float yx, yy, yz;
    if (kReciprocal) {
      yx = __fmaf_rn(rx[s], inv, kRound);
      yy = __fmaf_rn(ry[s], inv, kRound);
      yz = __fmaf_rn(rz[s], inv, kRound);
    } else {
      yx = __fadd_rn(__fdiv_rn(rx[s], r), kRound);
      yy = __fadd_rn(__fdiv_rn(ry[s], r), kRound);
      yz = __fadd_rn(__fdiv_rn(rz[s], r), kRound);
    }
    const unsigned ux = shifted_cell(yx), uy = shifted_cell(yy),
                   uz = shifted_cell(yz);
    const int cell = max(ux, max(uy, uz)) <= 2u
                         ? static_cast<int>(ux * 9u + uy * 3u + uz)
                         : kCells;
    const int at = cell * kWarp + lane;
    table[at] += cv[s];
    atomicAdd(counts + at, inc);  // integer, this lane's own entry: no wait
  }
}

// Lane c < 27: the sum of row c of a 27 x 32 table in the fixed order
// of columns c ^ 0, c ^ 1, ..., c ^ 31, zeroing what it read. At step j
// the lanes read banks c ^ j, all different. Other lanes: 0.
template <typename T>
__device__ __forceinline__ T reduce_row(T* table, int lane) {
  T acc = 0;
  if (lane < kCells) {
    const int diag = lane * (kWarp + 1);  // row c, column c
#pragma unroll
    for (int j = 0; j < kWarp; ++j) {
      const int at = diag ^ j;            // row c, column c ^ j
      acc += table[at];
      table[at] = 0;
    }
  }
  return acc;
}

// Writes the num_levels * 27 means of one point to out_row. cv/rx/ry/rz:
// this lane's candidates (load_candidates). table: this warp's
// kTableWords shared words, the 28 x 32 sum table then the 28 x 32 count
// table, the 27 cell rows zero on entry and on exit. reciprocal: every
// level's r is a power of two whose reciprocal is a normal float.
// count_cap: n, the clamp of the counts.
__device__ __forceinline__ void voxel_means(
    const float (&cv)[kMaxPerLane], const float (&rx)[kMaxPerLane],
    const float (&ry)[kMaxPerLane], const float (&rz)[kMaxPerLane],
    int num_levels, float base_scale, bool reciprocal, int count_cap,
    float* table, int lane, float* __restrict__ out_row) {
  int* counts = reinterpret_cast<int*>(table + kRows * kWarp);
  for (int l0 = 0; l0 < num_levels; l0 += kLevelsPerPass) {
    const int nl = min(kLevelsPerPass, num_levels - l0);
    float sums[kLevelsPerPass];
#pragma unroll
    for (int i = 0; i < kLevelsPerPass; ++i) {
      sums[i] = 0.f;
      if (i < nl) {
        const float r = base_scale * static_cast<float>(1 << (l0 + i));
        const int inc = 1 << (kCountBits * i);
        if (reciprocal) {
          scatter_level<true>(cv, rx, ry, rz, r, inc, table, lane);
        } else {
          scatter_level<false>(cv, rx, ry, rz, r, inc, table, lane);
        }
        __syncwarp();
        sums[i] = reduce_row(table, lane);
        __syncwarp();
      }
    }
    const int packed = reduce_row(counts, lane);
    if (lane < kCells) {
#pragma unroll
      for (int i = 0; i < kLevelsPerPass; ++i) {
        if (i < nl) {
          const int c = (packed >> (kCountBits * i)) & ((1 << kCountBits) - 1);
          out_row[(l0 + i) * kCells + lane] = __fdiv_rn(
              sums[i], static_cast<float>(min(max(c, 1), count_cap)));
        }
      }
    }
    __syncwarp();
  }
}

// Zeroes column `lane` of the 27 cell rows of this warp's two tables.
__device__ __forceinline__ void clear_tables(float* table, int lane) {
  int* counts = reinterpret_cast<int*>(table + kRows * kWarp);
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    table[c * kWarp + lane] = 0.f;
    counts[c * kWarp + lane] = 0;
  }
}

}  // namespace pvraft
