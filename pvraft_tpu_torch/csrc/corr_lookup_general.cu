// General-shape point-voxel correlation lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels pvraft_tpu/ops/pallas/corr_lookup.py
// (_fused_forward / _fused_kernel) and pvraft_tpu/ops/pallas/voxel_corr.py
// (_voxel_forward_pallas) at the shapes the tuned kernels (corr_lookup.cu,
// voxel_corr.cu, built on 16 candidates per lane, a 27-cell table with
// 10-bit packed counts and a 32-lane sort) do not take: any K >= 1, any
// 0 <= knn <= K, any resolution >= 1 and any number of levels. For every
// query point it writes
//   * voxel: per level l (edge r = base_scale * 2^l), half = resolution / 2,
//     each candidate's d = rint(rel / r) per axis (half to even), valid iff
//     every |d| <= half and the flat index (dx+h)*R^2 + (dy+h)*R + (dz+h)
//     is below R^3 (at an even resolution that drops the candidates whose
//     index passes the last cell, and lets the others alias, as the Pallas
//     kernels' per-cell sums over range(R^3) do); the output is the per-cell
//     mean sum(valid * corr) / clamp(count, 1, N)
//     (voxel_level_means, pvraft_tpu/ops/pallas/voxel_corr.py:61-89);
//   * kNN (knn > 0): the knn candidates nearest to coords (dist = x*x + y*y
//     + z*z), nearest first, the lowest candidate index winning ties; their
//     corr, their offsets and their indices (the indices the Function's
//     backward scatters onto).
// rel is xyz - coords (by __fsub_rn) when coords is given (the lookup), or
// read as given (kernel 3's voxel-only pass, knn = 0).
//
// Bound on the H100: bytes, one read of corr (4K B per point) and of the
// offsets (12K B per point) and one write of the outputs. The kernel does
// not approach it: it is the simple, right kernel for the shapes off the
// flagship, and it re-reads the candidates once per level (from L1/L2).
//
// Design: one warp per query point, `warps` points per block, everything
// in the warp's slice of dynamic shared memory:
//   * a (R^3 + 1) x 32 table of float partial sums and one of integer
//     counts, rows of 33 words (lane l of row c sits in bank (c + l) % 32).
//     Lane l walks candidates l, l + 32, ... and adds into its own column
//     only, an invalid candidate into the dump row R^3 that is never read.
//     Lanes then sum whole rows (row c = lane + 32 m) over the columns
//     0..31 in that fixed order. No float atomics, a fixed order: two
//     launches are bitwise equal;
//   * the kNN: every candidate's (distance bits, index) staged, padded to a
//     power of two with (0xffffffff, INT_MAX), and bitonic-sorted by the
//     warp in shared memory, ascending by distance then index: exactly the
//     stable sort's order (a non-negative float orders like its bits; a
//     NaN distance sorts after +inf, as torch.sort puts it last). The first
//     knn entries are the selection.
// The distance and the offsets use explicit _rn intrinsics, so nvcc cannot
// contract them into FMAs that the plain PyTorch version does not make; the
// cell uses the IEEE division and rintf, exactly the plain version's
// round(rel / r).
// The host (ops/cuda/corr_lookup.py::general_lookup_plan) sizes the shared
// memory, opts in above 48 KB, and refuses a shape whose one warp would
// need more than a block can have.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kRowWords = kWarp + 1;
constexpr unsigned kPadKey = 0xffffffffu;

struct Lookup {
  const float* corr;    // (rows, k)
  const float* pts;     // (rows, k, 3): xyz (with coords) or rel
  const float* coords;  // (rows, 3) or nullptr
  float* vox;           // (rows, levels * R^3)
  float* kcorr;         // (rows, knn)
  float* krel;          // (rows, knn, 3)
  int* kidx;            // (rows, knn)
  int rows, n, k, levels, res, knn, sort_len, warps;
  float base_scale;
};

// The candidate's offset from the query point.
__device__ __forceinline__ void offset(const float* __restrict__ p_row,
                                       int j, bool subtract, float cx,
                                       float cy, float cz, float* x, float* y,
                                       float* z) {
  *x = __ldg(p_row + 3 * j + 0);
  *y = __ldg(p_row + 3 * j + 1);
  *z = __ldg(p_row + 3 * j + 2);
  if (subtract) {
    *x = __fsub_rn(*x, cx);
    *y = __fsub_rn(*y, cy);
    *z = __fsub_rn(*z, cz);
  }
}

// The flat cell of one offset at edge r, or r3 (the dump row) if invalid.
__device__ __forceinline__ int cell_of(float x, float y, float z, float r,
                                       int res, int r3) {
  const float half = static_cast<float>(res / 2);
  const float dx = rintf(__fdiv_rn(x, r));
  const float dy = rintf(__fdiv_rn(y, r));
  const float dz = rintf(__fdiv_rn(z, r));
  // Written so that a NaN fails the test, as the plain version's
  // all(|d| <= half) does.
  if (!(fabsf(dx) <= half && fabsf(dy) <= half && fabsf(dz) <= half))
    return r3;
  const int h = res / 2;
  const int c = (static_cast<int>(dx) + h) * res * res +
                (static_cast<int>(dy) + h) * res + (static_cast<int>(dz) + h);
  return c < r3 ? c : r3;
}

__global__ void corr_lookup_general_kernel(Lookup a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const long long row = (long long)blockIdx.x * a.warps + w;
  if (row >= a.rows) return;  // a whole warp leaves; no block barrier is used

  const int r3 = a.res * a.res * a.res;
  const int table_words = (r3 + 1) * kRowWords;
  float* base = smem + (size_t)w * (2 * table_words + 2 * a.sort_len);
  float* sums = base;
  int* counts = reinterpret_cast<int*>(base + table_words);
  const float* c_row = a.corr + row * a.k;
  const float* p_row = a.pts + row * a.k * 3;
  const bool subtract = a.coords != nullptr;
  const float cx = subtract ? a.coords[row * 3 + 0] : 0.f;
  const float cy = subtract ? a.coords[row * 3 + 1] : 0.f;
  const float cz = subtract ? a.coords[row * 3 + 2] : 0.f;

  // ---- voxel branch ------------------------------------------------------
  float r = a.base_scale;
  for (int l = 0; l < a.levels; ++l, r *= 2.f) {  // r * 2 is exact
    for (int c = 0; c < r3; ++c) {
      sums[c * kRowWords + lane] = 0.f;
      counts[c * kRowWords + lane] = 0;
    }
    for (int j = lane; j < a.k; j += kWarp) {
      float x, y, z;
      offset(p_row, j, subtract, cx, cy, cz, &x, &y, &z);
      const int at = cell_of(x, y, z, r, a.res, r3) * kRowWords + lane;
      sums[at] += __ldg(c_row + j);
      counts[at] += 1;
    }
    __syncwarp();
    float* out = a.vox + (row * a.levels + l) * r3;
    for (int c = lane; c < r3; c += kWarp) {
      float s = 0.f;
      int cnt = 0;
      for (int col = 0; col < kWarp; ++col) {
        s = __fadd_rn(s, sums[c * kRowWords + col]);
        cnt += counts[c * kRowWords + col];
      }
      out[c] = __fdiv_rn(s, static_cast<float>(min(max(cnt, 1), a.n)));
    }
    __syncwarp();
  }
  if (a.knn <= 0) return;

  // ---- kNN branch --------------------------------------------------------
  unsigned* keys = reinterpret_cast<unsigned*>(base + 2 * table_words);
  int* idx = reinterpret_cast<int*>(keys + a.sort_len);
  for (int j = lane; j < a.sort_len; j += kWarp) {
    if (j < a.k) {
      float x, y, z;
      offset(p_row, j, subtract, cx, cy, cz, &x, &y, &z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                __fmul_rn(z, z));
      keys[j] = __float_as_uint(d);
      idx[j] = j;
    } else {
      keys[j] = kPadKey;
      idx[j] = INT_MAX;
    }
  }
  __syncwarp();
  const int pairs = a.sort_len / 2;
  for (int size = 2; size <= a.sort_len; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int t = lane; t < pairs; t += kWarp) {
        const int i = 2 * t - (t & (stride - 1));  // bit `stride` clear
        const int j = i + stride;
        const unsigned ki = keys[i], kj = keys[j];
        const int ii = idx[i], ij = idx[j];
        const bool j_less = kj < ki || (kj == ki && ij < ii);
        const bool ascending = (i & size) == 0;
        if (j_less == ascending) {
          keys[i] = kj;
          keys[j] = ki;
          idx[i] = ij;
          idx[j] = ii;
        }
      }
      __syncwarp();
    }
  }
  for (int m = lane; m < a.knn; m += kWarp) {
    const int j = idx[m];
    const long long o = row * a.knn + m;
    float x, y, z;
    offset(p_row, j, subtract, cx, cy, cz, &x, &y, &z);
    a.kidx[o] = j;
    a.kcorr[o] = __ldg(c_row + j);
    a.krel[3 * o + 0] = x;
    a.krel[3 * o + 1] = y;
    a.krel[3 * o + 2] = z;
  }
}

}  // namespace

// rows = B * N query points; n = N (the count clamp); k >= 1 candidates per
// point; coords = nullptr reads pts as the offsets themselves. knn = 0
// writes only vox (kcorr, krel, kidx may be nullptr). sort_len: the power
// of two >= k when knn > 0, else 0. warps: query points per block; smem:
// the block's dynamic shared memory, warps * 4 * (2 * (R^3 + 1) * 33 + 2 *
// sort_len) bytes, opted in above 48 KB. Returns cudaGetLastError().
extern "C" int pvraft_corr_lookup_general(
    const float* corr, const float* pts, const float* coords, float* vox,
    float* kcorr, float* krel, int* kidx, int rows, int n, int k,
    int num_levels, float base_scale, int resolution, int knn, int sort_len,
    int warps, int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        corr_lookup_general_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (rows > 0) {
    Lookup a{corr, pts, coords, vox, kcorr, krel, kidx, rows, n, k,
             num_levels, resolution, knn, sort_len, warps, base_scale};
    const int grid = (rows + warps - 1) / warps;
    corr_lookup_general_kernel<<<grid, warps * kWarp, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
