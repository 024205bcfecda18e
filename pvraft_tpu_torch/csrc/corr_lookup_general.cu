// General-shape point-voxel correlation lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels pvraft_tpu/ops/pallas/corr_lookup.py
// (_fused_forward / _fused_kernel) and pvraft_tpu/ops/pallas/voxel_corr.py
// (_voxel_forward_pallas) at the shapes the tuned kernels (corr_lookup.cu,
// voxel_corr.cu: K <= 512, knn <= 32, resolution 3) do not take: any
// K >= 1, any 0 <= knn <= K, any resolution >= 1 and any number of levels.
// For every query point it writes
//   * voxel: per level l (edge r = base_scale * 2^l), half = resolution / 2,
//     each candidate's d = rint(rel / r) per axis (half to even), valid iff
//     every |d| <= half and the flat index (dx+h)*R^2 + (dy+h)*R + (dz+h)
//     is below R^3 (at an even resolution that drops the candidates whose
//     index passes the last cell, and lets the others alias, as the Pallas
//     kernels' per-cell sums over range(R^3) do); the output is the per-cell
//     mean sum(valid * corr) / clamp(count, 1, N)
//     (voxel_level_means, pvraft_tpu/ops/pallas/voxel_corr.py:61-89);
//   * kNN (knn > 0): the knn candidates nearest to coords (dist = x*x + y*y
//     + z*z), nearest first, the lowest candidate index winning ties and a
//     NaN distance after +inf (a stable sort's order); their corr, their
//     offsets and their indices (the indices the Function's backward
//     scatters onto).
// rel is xyz - coords (by __fsub_rn) when coords is given (the lookup), or
// read as given (the voxel-only pass, knn = 0, coords = nullptr: the
// kernel subtracts 0, which leaves every float as it is).
//
// Bound on the H100: bytes, one read of corr (4K B per point) and of the
// offsets (12K B per point) and one write of the outputs: 147.4 MB, 0.0440
// ms at 1 x 8192, K 1024, knn 64, R 3 (3.35 TB/s).
//
// Design: one warp per query point, up to 4 points per block, each warp
// with its own slice of dynamic shared memory (layout() below).
//   * One read of each candidate. The K candidates are walked in chunks of
//     512: 16 per lane in registers, by voxel_bins.cuh::load_candidates on
//     c_row + 512 c and x_row + 3 * 512 c (16-byte loads; a K that is not a
//     multiple of 4, or a row off 16-byte alignment, takes the scalar loads
//     of the same slots). A chunk is binned into every level of the pass
//     and its distance keys are made from the same registers. Where all
//     levels fit in one pass (levels_per_pass = levels) no candidate is read
//     twice; a K <= 512 keeps its one chunk in registers across passes.
//   * The binning of voxel_bins.cuh, generalised to any R: where every
//     level's edge is a power of two (ops/cuda/__init__.py::
//     reciprocal_is_exact) the cell is one fma(rel, 1/r, 1.5 * 2^23) per
//     axis, bitwise the division the plain version makes, else
//     __fdiv_rn(rel, r) + 1.5 * 2^23; the integer bits minus those of
//     1.5 * 2^23 - half are rint(rel / r) + half, so one unsigned compare
//     against 2 * half is the range test (a NaN, an infinity or |q| >= 2^22
//     lands far outside). Per-lane columns of a cell-major table (lane l
//     adds into column l only: no bank conflict, no float atomic), one sum
//     table per level of the pass, one dump row for every invalid
//     candidate (never read, so no candidate branches). Integer counts of
//     the pass's levels share one table: each lane column holds at most
//     16 * chunks per level, so fields of bit_length(16 * chunks) bits
//     (6 at K 1024, where a cell's total can reach 1024) never carry; the
//     reducer extracts each field before it sums. Lane c reduces row c
//     (and c + 32, ...) by 16-byte reads of 4 columns, quad (c + m) % 8 at
//     step m (each quarter-warp covers the 32 banks), one fixed order per
//     row, zeroing what it read.
//   * A threshold kNN in place of a sort, as corr_lookup.cu does at
//     knn <= 32: every candidate's distance bits (a non-negative float
//     orders like its bits; a NaN becomes 0x7fffffff, above +inf, like a
//     missing slot, which always has a larger index) stay in registers
//     (K <= 1024: 16 or 32 per lane) or, beyond, in a per-warp shared array
//     of 512 * chunks words. (1) A radix select of the knn-th smallest key
//     T, one bit per step, starting below the bits the smallest key shares
//     with an upper bound that at least knn keys do not exceed (the largest
//     of each lane's minima over ceil(knn / 32) groups of its keys), each
//     step a branch-free count and one __reduce_add_sync, stopping early at
//     a prefix with exactly knn keys below it. (2) Every key < T, then the
//     lowest-index keys == T until there are knn (ranked by warp prefix sums
//     in candidate order), compacted into a knn-entry list. (3) A bitonic
//     sort of that list by (key, index) over the power of two >= knn: in
//     registers, two entries a lane across __shfl_xor_sync, up to knn 64;
//     beyond, in shared memory over the tables' space. O(K * steps + knn
//     log^2 knn) in place of the full sort's O(K log^2 K); at knn = K it
//     sorts them all.
//   * The selected candidates' corr and offsets are read back from global
//     memory (L2), knn per point.
//   * Rounding and the distance use explicit _rn intrinsics, so nvcc cannot
//     contract them into FMAs the plain PyTorch version does not make.
// No float atomics and a fixed order of every sum: two launches are bitwise
// equal.
//
// Occupancy (ops/cuda/corr_lookup.py::general_lookup_plan picks the levels
// per pass and the points per block; __launch_bounds__ caps registers at
// 128, 16 warps per SM; ptxas gives the five instantiations 107 to 128
// registers and no spills; the resident warps below are also what the
// CUDA occupancy calculator reports, pvraft_corr_lookup_general_resident),
// at chip_smoke.py's GENERAL_LOOKUPS shapes, each with its voxel-only
// pass (knn = 0: the same tables, fewer registers):
//   * K 1024 / knn 64 / R 3, 3 levels in one pass: 14,080 B a warp (three
//     27-row sum tables, a dump row, the 28-row count table), 16 warps per
//     SM; keys in 32 registers a lane;
//   * K 510 / knn 48 / R 2, 3 levels in one pass: 4,352 B a warp, 16
//     warps (registers);
//   * K 512 / knn 32 / R 5, 4 levels: one 125-row table is 16 KB, so the
//     levels go one a pass (32,256 B a warp, 7 warps per SM, one point a
//     block) and the chunk stays in registers; all four in one pass would
//     take 80 KB a warp and 2 warps per SM.
// The registers and spills ptxas reports stand in the build log
// (_build/<hash>/libcorr_lookup_general.so.log) and PERF.md section 6.

#include <cuda_runtime.h>

#include <climits>

#include "voxel_bins.cuh"

namespace {

using pvraft::candidate;
using pvraft::kFull;
using pvraft::kMaxPerLane;
using pvraft::kRound;
using pvraft::kRoundBits;
using pvraft::kVec;
using pvraft::kWarp;

constexpr int kChunk = kWarp * kMaxPerLane;  // 512 candidates per chunk
constexpr int kMaxWarps = 4;                 // query points per block
constexpr int kMinBlocks = 4;                // 16 warps per SM: 128 registers
// A NaN distance's and a missing slot's key: above every other distance's
// bits (+inf is 0x7f800000), below 2^31 like every key.
constexpr unsigned kMissing = 0x7fffffffu;
constexpr unsigned kPadKey = 0xffffffffu;    // the sort list's padding
// Where the distance keys live (template argument).
constexpr int kNoKeys = 0;                   // knn = 0
constexpr int kRegKeys = 1;                  // registers: K <= 1024
constexpr int kSharedKeys = 2;               // shared memory: any K

struct Lookup {
  const float* corr;    // (rows, k)
  const float* pts;     // (rows, k, 3): xyz (with coords) or rel
  const float* coords;  // (rows, 3) or nullptr
  float* vox;           // (rows, levels * R^3)
  float* kcorr;         // (rows, knn)
  float* krel;          // (rows, knn, 3)
  int* kidx;            // (rows, knn)
  int rows, n, k, levels, res, knn, per_pass, warps, vec, reciprocal;
  float base_scale;
};

// One warp's slice of shared memory, in 4-byte words.
struct Layout {
  int chunks;      // ceil(K / 512)
  int r3;          // R^3 cells per level
  int sort_len;    // the power of two >= knn (0 without a kNN)
  int count_bits;  // bits of one level's field in a count word
  int counts;      // the count table: (R^3 + 1) rows of 32 after the sums
  int keys;        // the shared keys (kSharedKeys), after tables and list
  int words;       // the slice
};

__host__ __device__ inline int bit_length(unsigned v) {
  int b = 0;
  while (v) {
    ++b;
    v >>= 1;
  }
  return b;
}

// The sum tables ((per_pass * R^3 + 1) rows of 32: the pass's levels, then
// the dump row) and the count table ((R^3 + 1) rows), both zero between
// passes; the kNN list (sort_len keys, then sort_len indices) over the
// same words once the voxel passes are done; then the shared keys.
__host__ __device__ inline Layout layout(int k, int knn, int res, int levels,
                                         int per_pass) {
  Layout l;
  l.chunks = (k + kChunk - 1) / kChunk;
  l.r3 = res * res * res;
  l.sort_len = 0;
  if (knn > 0) {
    l.sort_len = 1;
    while (l.sort_len < knn) l.sort_len <<= 1;
  }
  l.count_bits = bit_length(static_cast<unsigned>(kMaxPerLane * l.chunks));
  l.counts = (per_pass * l.r3 + 1) * kWarp;
  const int tables = levels > 0 ? l.counts + (l.r3 + 1) * kWarp : 0;
  int front = tables > 2 * l.sort_len ? tables : 2 * l.sort_len;
  front = (front + kWarp - 1) / kWarp * kWarp;
  l.keys = front;
  l.words = front + (knn > 0 && l.chunks > 2 ? l.chunks * kChunk : 0);
  return l;
}

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

// Adds this lane's 16 candidates of one level (edge r) into column `lane`
// of the level's sum table (row = cell) and `inc` into the count table,
// an invalid candidate into the dump rows.
template <bool kReciprocal>
__device__ __forceinline__ void bin_level(
    const float (&cv)[kMaxPerLane], const float (&rx)[kMaxPerLane],
    const float (&ry)[kMaxPerLane], const float (&rz)[kMaxPerLane], float r,
    int res, int r3, int sum_row0, int sum_dump, float* sums, int* counts,
    int inc, int lane) {
  const int half = res / 2;
  const unsigned span = 2u * static_cast<unsigned>(half);
  const unsigned shift = static_cast<unsigned>(kRoundBits - half);
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
    // rint(rel / r) + half per axis; <= 2 * half iff |rint| <= half.
    const unsigned ux = __float_as_uint(yx) - shift;
    const unsigned uy = __float_as_uint(yy) - shift;
    const unsigned uz = __float_as_uint(yz) - shift;
    const unsigned cell = (ux * res + uy) * res + uz;
    const bool ok = max(ux, max(uy, uz)) <= span && cell < r3;
    sums[(ok ? sum_row0 + static_cast<int>(cell) : sum_dump) * kWarp + lane] +=
        cv[s];
    // An integer atomic on this lane's own entry: the lane does not wait.
    atomicAdd(counts + (ok ? static_cast<int>(cell) : r3) * kWarp + lane, inc);
  }
}

// The squared distance's key of each of this lane's 16 candidates of a
// chunk holding `left` candidates.
__device__ __forceinline__ void chunk_keys(
    const float (&rx)[kMaxPerLane], const float (&ry)[kMaxPerLane],
    const float (&rz)[kMaxPerLane], int left, int lane,
    unsigned (&key)[kMaxPerLane]) {
#pragma unroll
  for (int s = 0; s < kMaxPerLane; ++s) {
    const float d = __fadd_rn(
        __fadd_rn(__fmul_rn(rx[s], rx[s]), __fmul_rn(ry[s], ry[s])),
        __fmul_rn(rz[s], rz[s]));
    key[s] = candidate(s, lane) < left && d == d ? __float_as_uint(d)
                                                 : kMissing;
  }
}

// Calls f(c, key) for every chunk c in order, key being this lane's 16
// keys of chunk c: from registers (kRegKeys: kChunks chunks) or loaded from
// the warp's shared keys (slot s of lane l of chunk c at c * 512 + 32 s + l).
template <int kKeys, int kChunks, typename F>
__device__ __forceinline__ void each_chunk(
    const unsigned (&reg)[kChunks > 0 ? kChunks : 1][kMaxPerLane],
    const unsigned* skeys, int chunks, int lane, F&& f) {
  if constexpr (kKeys == kRegKeys) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) f(c, reg[c]);
  } else {
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
      unsigned key[kMaxPerLane];
#pragma unroll
      for (int s = 0; s < kMaxPerLane; ++s)
        key[s] = skeys[c * kChunk + s * kWarp + lane];
      f(c, key);
    }
  }
}

// kKeys: kNoKeys, kRegKeys or kSharedKeys. kChunks: the number of 512-
// candidate chunks when it is fixed (1 or 2), else 0 (any, read per pass).
template <int kKeys, int kChunks>
__global__ void __launch_bounds__(kMaxWarps * kWarp, kMinBlocks)
corr_lookup_general_kernel(Lookup a) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const long long row = (long long)blockIdx.x * a.warps + w;
  if (row >= a.rows) return;  // a whole warp leaves; no block barrier is used

  const Layout lay = layout(a.k, a.knn, a.res, a.levels, a.per_pass);
  float* base = reinterpret_cast<float*>(smem4) + (size_t)w * lay.words;
  float* sums = base;
  int* counts = reinterpret_cast<int*>(base + lay.counts);
  unsigned* skeys = reinterpret_cast<unsigned*>(base + lay.keys);
  const int r3 = lay.r3;
  const int chunks = kChunks > 0 ? kChunks : lay.chunks;
  const float* c_row = a.corr + row * a.k;
  const float* x_row = a.pts + row * a.k * 3;
  const bool subtract = a.coords != nullptr;
  const float cx = subtract ? a.coords[row * 3 + 0] : 0.f;
  const float cy = subtract ? a.coords[row * 3 + 1] : 0.f;
  const float cz = subtract ? a.coords[row * 3 + 2] : 0.f;

  // The tables start at zero; the reducer leaves them so between passes.
  if (a.levels > 0) {
    const int n4 = (lay.counts + (r3 + 1) * kWarp) / 4;
    float4* t = reinterpret_cast<float4*>(base);
    for (int i = lane; i < n4; i += kWarp)
      t[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
  }

  unsigned key[kChunks > 0 ? kChunks : 1][kMaxPerLane];
  float cv[kMaxPerLane], rx[kMaxPerLane], ry[kMaxPerLane], rz[kMaxPerLane];
  auto load = [&](int c) {
    pvraft::load_candidates<true>(c_row + c * kChunk, x_row + 3 * c * kChunk,
                                  a.k - c * kChunk, a.vec != 0, cx, cy, cz,
                                  lane, cv, rx, ry, rz);
  };
  if constexpr (kChunks == 1) load(0);  // held across the passes

  // ---- voxel passes (and, in the first, the distance keys) ---------------
  const int count_mask = (1 << lay.count_bits) - 1;
  int l0 = 0;
  do {
    const int np = min(a.per_pass, a.levels - l0);  // 0 without levels
    auto chunk = [&](int c) {
      if constexpr (kChunks != 1) load(c);
      for (int i = 0; i < np; ++i) {
        const float r = a.base_scale * static_cast<float>(1 << (l0 + i));
        const int inc = 1 << (lay.count_bits * i);
        if (a.reciprocal) {
          bin_level<true>(cv, rx, ry, rz, r, a.res, r3, i * r3,
                          a.per_pass * r3, sums, counts, inc, lane);
        } else {
          bin_level<false>(cv, rx, ry, rz, r, a.res, r3, i * r3,
                           a.per_pass * r3, sums, counts, inc, lane);
        }
      }
      if constexpr (kKeys == kRegKeys) {
        if (l0 == 0) chunk_keys(rx, ry, rz, a.k - c * kChunk, lane, key[c]);
      } else if constexpr (kKeys == kSharedKeys) {
        if (l0 == 0) {
          unsigned kk[kMaxPerLane];
          chunk_keys(rx, ry, rz, a.k - c * kChunk, lane, kk);
#pragma unroll
          for (int s = 0; s < kMaxPerLane; ++s)
            skeys[c * kChunk + s * kWarp + lane] = kk[s];
        }
      }
    };
    if constexpr (kChunks > 0) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) chunk(c);
    } else {
#pragma unroll 1
      for (int c = 0; c < chunks; ++c) chunk(c);
    }
    __syncwarp();
    // Lane l reduces rows l, l + 32, ...: 16-byte quads of 4 columns, quad
    // (l + m) % 8 at step m, so each quarter-warp reads all 32 banks.
    for (int cell = lane; np > 0 && cell < r3; cell += kWarp) {
      int4* crow = reinterpret_cast<int4*>(counts + cell * kWarp);
      for (int i = 0; i < np; ++i) {
        float4* srow =
            reinterpret_cast<float4*>(sums + (i * r3 + cell) * kWarp);
        const int sh = lay.count_bits * i;
        float s = 0.f;
        int cnt = 0;
#pragma unroll
        for (int m = 0; m < kWarp / 4; ++m) {
          const int q = (lane + m) & (kWarp / 4 - 1);
          const float4 v = srow[q];
          srow[q] = make_float4(0.f, 0.f, 0.f, 0.f);
          s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, v.x), v.y), v.z), v.w);
          const int4 u = crow[q];
          cnt += ((u.x >> sh) & count_mask) + ((u.y >> sh) & count_mask) +
                 ((u.z >> sh) & count_mask) + ((u.w >> sh) & count_mask);
        }
        a.vox[(row * a.levels + l0 + i) * r3 + cell] =
            __fdiv_rn(s, static_cast<float>(min(max(cnt, 1), a.n)));
      }
#pragma unroll
      for (int m = 0; m < kWarp / 4; ++m)
        crow[(lane + m) & (kWarp / 4 - 1)] = make_int4(0, 0, 0, 0);
    }
    __syncwarp();
    l0 += a.per_pass;
  } while (l0 < a.levels);
  if constexpr (kKeys == kNoKeys) {
    return;
  } else {
    // ---- kNN -------------------------------------------------------------
    const int knn = a.knn;
    // (1) Radix select. Bounds: kmin, the smallest key, and ub, a key that
    // at least knn keys do not exceed: each lane closes ceil(knn / 32)
    // groups of g consecutive keys and keeps the largest group minimum.
    const int groups = (knn + kWarp - 1) / kWarp;
    const int g = kMaxPerLane * chunks / groups;
    unsigned lane_min = kMissing, gmin = kPadKey, lane_ub = 0;
    int left = g;
    each_chunk<kKeys, kChunks>(key, skeys, chunks, lane,
                               [&](int, const unsigned (&k)[kMaxPerLane]) {
#pragma unroll
      for (int s = 0; s < kMaxPerLane; ++s) {
        lane_min = min(lane_min, k[s]);
        gmin = min(gmin, k[s]);
        if (--left == 0) {
          lane_ub = max(lane_ub, gmin);
          gmin = kPadKey;
          left = g;
        }
      }
    });
    const unsigned kmin = __reduce_min_sync(kFull, lane_min);
    const unsigned ub = __reduce_max_sync(kFull, lane_ub);
    // Invariant: below = #{key < lo} < knn, and at least knn keys lie
    // below lo + 2^(b+1). Every key and every t is < 2^31, so (key - t) >> 31
    // is key < t without a branch.
    const int top = ub == kmin ? -1 : 31 - __clz(kmin ^ ub);
    unsigned lo = top < 0 ? kmin : kmin & ~((2u << top) - 1u);
    int below = 0;
    bool exact = false;
    for (int b = top; b >= 0; --b) {
      const unsigned t = lo | (1u << b);
      unsigned c0 = 0, c1 = 0;
      each_chunk<kKeys, kChunks>(key, skeys, chunks, lane,
                                 [&](int, const unsigned (&k)[kMaxPerLane]) {
#pragma unroll
        for (int s = 0; s < kMaxPerLane; s += 2) {
          c0 += (k[s] - t) >> 31;
          c1 += (k[s + 1] - t) >> 31;
        }
      });
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

    // (2) The set, in candidate order (chunk, group, lane, element): every
    // key < lo, then (unless exact) the lowest-index keys == lo (= T, the
    // knn-th smallest) until there are knn.
    unsigned* lkey = reinterpret_cast<unsigned*>(base);
    int* lidx = reinterpret_cast<int*>(base + lay.sort_len);
    const int need = exact ? 0 : knn - below;
    int tie_base = 0, pos_base = 0;
    each_chunk<kKeys, kChunks>(key, skeys, chunks, lane,
                               [&](int c, const unsigned (&k)[kMaxPerLane]) {
      unsigned sel = 0;
#pragma unroll
      for (int s = 0; s < kMaxPerLane; ++s) sel |= (k[s] < lo ? 1u : 0u) << s;
      if (tie_base < need) {  // warp-uniform
#pragma unroll
        for (int gi = 0; gi < pvraft::kGroups; ++gi) {
          unsigned tie = 0;
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            tie |= (k[gi * kVec + e] == lo ? 1u : 0u) << e;
          int total;
          const int before = tie_base + lane_prefix(__popc(tie), lane, &total);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const int rank = before + __popc(tie & ((1u << e) - 1u));
            if ((tie >> e & 1u) && rank < need) sel |= 1u << (gi * kVec + e);
          }
          tie_base += total;
        }
      }
      int total;
      int pos = pos_base + lane_prefix(__popc(sel), lane, &total);
#pragma unroll
      for (int s = 0; s < kMaxPerLane; ++s) {
        if (sel >> s & 1u) {
          lkey[pos] = k[s];
          lidx[pos] = c * kChunk + candidate(s, lane);
          ++pos;
        }
      }
      pos_base += total;
    });
    for (int p = knn + lane; p < lay.sort_len; p += kWarp) {
      lkey[p] = kPadKey;
      lidx[p] = INT_MAX;
    }
    __syncwarp();

    // (3) Bitonic sort of the list, ascending by (key, index), then the
    // selected candidates' outputs, nearest first.
    auto put = [&](int m, int j) {
      const long long o = row * knn + m;
      a.kidx[o] = j;
      a.kcorr[o] = __ldg(c_row + j);
      a.krel[3 * o + 0] = __fsub_rn(__ldg(x_row + 3 * j + 0), cx);
      a.krel[3 * o + 1] = __fsub_rn(__ldg(x_row + 3 * j + 1), cy);
      a.krel[3 * o + 2] = __fsub_rn(__ldg(x_row + 3 * j + 2), cz);
    };
    if (lay.sort_len <= 2 * kWarp) {
      // Up to 64 entries: two a lane in registers (entry lane + 32 e),
      // compare-exchanges within the lane at stride 32, else across lanes
      // by __shfl_xor_sync.
      unsigned kk[2];
      int ii[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = lane + kWarp * e;
        kk[e] = p < knn ? lkey[p] : kPadKey;
        ii[e] = p < knn ? lidx[p] : INT_MAX;
      }
#pragma unroll
      for (int size = 2; size <= 2 * kWarp; size <<= 1) {
#pragma unroll
        for (int stride = size / 2; stride > 0; stride >>= 1) {
          if (stride == kWarp) {
            if (kk[1] < kk[0] || (kk[1] == kk[0] && ii[1] < ii[0])) {
              const unsigned tk = kk[0];
              const int ti = ii[0];
              kk[0] = kk[1];
              ii[0] = ii[1];
              kk[1] = tk;
              ii[1] = ti;
            }
            continue;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = lane + kWarp * e;
            const unsigned ok = __shfl_xor_sync(kFull, kk[e], stride);
            const int oi = __shfl_xor_sync(kFull, ii[e], stride);
            const bool other_less = ok < kk[e] || (ok == kk[e] && oi < ii[e]);
            const bool keep_min = ((p & size) == 0) == ((p & stride) == 0);
            if (keep_min ? other_less : !other_less) {
              kk[e] = ok;
              ii[e] = oi;
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (lane + kWarp * e < knn) put(lane + kWarp * e, ii[e]);
      return;
    }
    // Longer lists in shared memory, the warp's lanes taking the pairs.
    const int pairs = lay.sort_len / 2;
    for (int size = 2; size <= lay.sort_len; size <<= 1) {
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        for (int t = lane; t < pairs; t += kWarp) {
          const int i = 2 * t - (t & (stride - 1));  // bit `stride` clear
          const int j = i + stride;
          const unsigned ki = lkey[i], kj = lkey[j];
          const int ii = lidx[i], ij = lidx[j];
          const bool j_less = kj < ki || (kj == ki && ij < ii);
          if (j_less == ((i & size) == 0)) {
            lkey[i] = kj;
            lkey[j] = ki;
            lidx[i] = ij;
            lidx[j] = ii;
          }
        }
        __syncwarp();
      }
    }
    for (int m = lane; m < knn; m += kWarp) put(m, lidx[m]);
  }
}

using Kernel = void (*)(Lookup);

// The instantiation for K and knn: the keys in registers up to two chunks
// (K <= 1024), else in shared memory; a single chunk held across passes.
Kernel kernel_for(int k, int knn) {
  const int chunks = (k + kChunk - 1) / kChunk;
  if (knn <= 0) {
    return chunks == 1 ? corr_lookup_general_kernel<kNoKeys, 1>
                       : corr_lookup_general_kernel<kNoKeys, 0>;
  }
  if (chunks == 1) return corr_lookup_general_kernel<kRegKeys, 1>;
  if (chunks == 2) return corr_lookup_general_kernel<kRegKeys, 2>;
  return corr_lookup_general_kernel<kSharedKeys, 0>;
}

// Whether the launch ints describe a layout the kernel can run.
bool valid(int k, int knn, int res, int levels, int per_pass, int warps,
           int smem) {
  if (k < 1 || knn < 0 || knn > k || res < 1 || levels < 0) return false;
  if (warps < 1 || warps > kMaxWarps) return false;
  const Layout l = layout(k, knn, res, levels, per_pass);
  if (levels > 0 && (per_pass < 1 || per_pass * l.count_bits > 32))
    return false;
  return static_cast<long long>(smem) >=
         4LL * warps * static_cast<long long>(l.words);
}

}  // namespace

// rows = B * N query points; n = N (the count clamp); k >= 1 candidates per
// point; coords = nullptr reads pts as the offsets themselves. knn = 0
// writes only vox (kcorr, krel, kidx may be nullptr). per_pass: levels
// binned per pass over the candidates (1 <= per_pass, per_pass *
// bit_length(16 * ceil(K / 512)) <= 32); warps: query points per block
// (1..4); smem: the block's dynamic shared memory, at least warps * 4 *
// layout().words bytes (opted in above 48 KB); vec: K % 4 == 0 and corr,
// pts 16-byte aligned; reciprocal: every level's edge is a power of two
// with a normal reciprocal. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for launch ints that do not fit the shapes.
extern "C" int pvraft_corr_lookup_general(
    const float* corr, const float* pts, const float* coords, float* vox,
    float* kcorr, float* krel, int* kidx, int rows, int n, int k,
    int num_levels, float base_scale, int resolution, int knn, int per_pass,
    int warps, int smem, int vec, int reciprocal, void* stream) {
  if (!valid(k, knn, resolution, num_levels, per_pass, warps, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = kernel_for(k, knn);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (rows > 0) {
    Lookup a{corr, pts, coords, vox, kcorr, krel, kidx, rows, n, k,
             num_levels, resolution, knn, per_pass, warps, vec, reciprocal,
             base_scale};
    const int grid = (rows + warps - 1) / warps;
    kernel<<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
        a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The warps of one SM that the launch of these shapes keeps resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x warps), or -1 on an
// error. For reports: it launches nothing.
extern "C" int pvraft_corr_lookup_general_resident(int k, int knn, int warps,
                                                   int smem) {
  const Kernel kernel = kernel_for(k, knn);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    warps * kWarp, smem) !=
      cudaSuccess)
    return -1;
  return blocks * warps;
}
