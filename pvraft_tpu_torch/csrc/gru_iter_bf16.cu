// bfloat16 fused MotionEncoder + ConvGRU update for Hopper (sm_90a), on
// the bf16 tensor cores.
//
// Replaces the Pallas TPU kernel pvraft_tpu/ops/pallas/gru_iter.py
// (_gru_forward / _gru_kernel, :129-167) at dtype_name "bfloat16": the math
// is _gru_math(..., "bfloat16") (:78-118), the JAX package's default
// serving dtype, at every hidden, context and correlation-feature width H,
// C, F. Operands in the dtypes the bf16 model hands them over: net (the
// float32 carry), inp, flow8 and the eight float32 weight arrays of
// pack_gru_weights, and cor (B*N, F) bfloat16. With rnd(x) the
// round-to-nearest-even bfloat16 of x, netd, inp, flow8, the weights and
// the biases rnd() of their float32 values, and every product accumulated
// in float32 and rounded on its own:
//   cor' = relu(rnd(rnd(cor . wc) + b0[0:H]))
//   flo  = relu(rnd(rnd(flow8 . wf) + b0[H:2H]))
//   hid  = relu(rnd(rnd(rnd(cor' . wh[:H]) + rnd(flo . wh[H:])) + b0[2H:]))
//   px   = rnd(rnd(rnd(rnd(inp . wi3) + rnd(hid . wh3)) + rnd(flow8 . wf3))
//              + b1)
//   z = rnd(sigmoid(rnd(px_z + rnd(netd . wn3_z))))   (r likewise)
//   q = rnd(tanh(rnd(px_q + rnd(rnd(r * netd) . wn3_q))))
//   out = rnd(1 - z) * net + rnd(z * q)                 (float32)
// which is jnp's order of operations and dtype promotions in _gru_math,
// token for token. The blend's product and sum are kept apart with
// __fmul_rn and __fadd_rn, so that no FMA contracts them, on the float32
// carry read from global memory. expf and tanhf are the accurate library
// functions (no fast math).
//
// Bound on the H100 at 1 x 8192 points and widths 64: bytes, 4 * (2H + C
// + 8) + 2F per point plus 211 KB of float32 weights, 7.81 MB: 2.3 us at
// 3.35 TB/s; the 0.839 GFLOP of products take 0.8 us on the bf16 tensor
// cores (989 TFLOP/s dense), 12.5 us on the fp32 CUDA cores.
//
// Design, and what each part addresses:
//  * Products on the tensor cores: mma.sync m16n8k16 with bf16 operands
//    and float32 accumulators, which is the rounding rule above (bf16
//    products are exact in float32). Each product of the chain has an
//    accumulator of its own, rounded on its own, as _gru_math rounds each
//    jnp.dot: no K dimensions are concatenated. Zero-padded K (to 16) and
//    columns (to 32) add +0 terms, which leave every sum exact. The
//    fragments of 4 k-steps are loaded before their products.
//  * 16 points (a tile) go through the whole chain together, in rows of
//    shared memory that hold their inputs (rounded to bf16 as they are
//    staged, the whole tile's loads in flight at once) and their bf16
//    intermediates (cor' then z, flo then px_q, hid, rnd(r * netd)), read
//    back as A fragments by ldmatrix. Output channels are worked in
//    blocks of 32 (four n8 tiles), z, r and q of one (point, channel) in
//    the same thread's accumulator fragments (the gate columns are laid
//    out per gate, padded to a multiple of 32). Each epilogue loads what
//    it reads before its stores. The chain of one tile is latency-bound
//    and the tiles are few (512 at 1 x 8192 on 132 SMs), so where the
//    weights are resident and H > 32 a tile runs on two warps (a team),
//    each taking every other block of channels of every stage, a named
//    barrier between stages.
//  * Weights, in one of three modes; a kernel that reads them again for
//    every few points grows in proportion to the points. Resident (widths
//    up to ~80; 113 KB at 64): every array, rounded to bf16 (K rows padded
//    to 16, each gate's columns to pad32(H), rows to an odd number of
//    16-byte units so that ldmatrix is free of bank conflicts), is staged
//    once per block by all its threads, two arrays' loads in flight
//    together, while the first tile's inputs load; a persistent grid of
//    at most one block per SM walks the tiles, so the weights cross L2
//    once per SM instead of once per 8 points. Streamed (96, 128, ...: 221
//    KB and more in bf16): for each stage and block of 32 channels the
//    block stages the weight columns that stage reads (a slab) between two
//    block barriers, its warps in lockstep, one tile each. Bare (widths
//    whose staged rows do not fit a block; no model uses them): inputs and
//    B fragments come from global memory, rounded in registers. B
//    fragments come from shared memory by ldmatrix.trans. The host plan
//    (ops/cuda/gru_iter.py::bf16_gru_plan) picks the warps and the grid;
//    the mode follows from the widths, and this entry point checks that
//    the shared memory it is given holds what the mode needs.
//  * Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6): 0.0349 ms
//    at 1 x 8192 against the old kernel's 0.0642, 15x the bytes bound:
//    the chain's latency and the weights' staging set the time, not the
//    bytes or the tensor cores.
//  * No atomics, one fixed order of products per output: two launches are
//    bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 16;        // points per warp tile: m16 of mma.sync
constexpr int kNt = 4;           // n8 tiles per channel block
constexpr int kBlock = 8 * kNt;  // channels per block
constexpr int kPre = 4;          // k-steps of fragments loaded ahead
constexpr int kPad = 8;          // bf16 row padding (16 bytes)
constexpr int kFlow = 8;         // FLOW_PAD
constexpr int kMats = 8;
constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

// Where the weights' B fragments and the inputs' A fragments come from:
// kResident, every weight array in shared memory for the block's life;
// kStreamed, the columns of one stage and channel block at a time (a
// slab), the inputs staged in the warps' rows as in kResident; kBare,
// both read from global memory.
enum Mode { kResident = 0, kStreamed = 1, kBare = 2 };

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int pad32(int x) { return (x + 31) & ~31; }

// The weight arrays in the order of Args::w: wc, wf, wh[:H], wh[H:], wi3,
// wh3, wf3, wn3. Matrix m has k input rows and ng gates of H columns each
// (a global row of ng * H floats).
struct Mat {
  int k, ng;
};

__host__ __device__ inline Mat mat(int m, int h, int c, int f) {
  switch (m) {
    case 0: return {f, 1};
    case 1: return {kFlow, 1};
    case 2: case 3: return {h, 1};
    case 4: return {c, 3};
    case 6: return {kFlow, 3};
    default: return {h, 3};  // 5: wh3, 7: wn3
  }
}

// Row length, in bf16, of matrix m resident in shared memory.
__host__ __device__ inline int mat_ld(int m, int h, int c, int f) {
  return mat(m, h, c, f).ng * pad32(h) + kPad;
}

__host__ __device__ inline int mat_elems(int m, int h, int c, int f) {
  return pad16(mat(m, h, c, f).k) * mat_ld(m, h, c, f);
}

__host__ __device__ inline int weight_elems(int h, int c, int f) {
  int n = 0;
  for (int m = 0; m < kMats; ++m) n += mat_elems(m, h, c, f);
  return n;
}

// kStreamed: the slab part of matrix m's gates g0 .. g0 + ng - 1 for one
// channel block: pad16(k) rows of ng kBlock columns and the padding. A
// slab holds the parts of one stage (cor' and flo: wc, wf; hid: wh[:H],
// wh[H:]; z, r and px_q: wi3, wh3, wf3 and wn3's z | r; q: wn3's q), one
// after the other.
__host__ __device__ inline int part_elems(int m, int ng, int colw, int h,
                                          int c, int f) {
  return pad16(mat(m, h, c, f).k) * (ng * colw + kPad);
}

// A tile's warps (a team): two above H = 32 where the weights are
// resident, each taking every other block of channels of every stage, so
// that a tile's chain runs on two warps; else one.
__host__ __device__ inline int team_of(int h, bool resident) {
  return resident && pad32(h) >= 2 * kBlock ? 2 : 1;
}

__host__ __device__ inline int slab_elems(int h, int c, int f) {
  const int w = kBlock;
  const int me = part_elems(0, 1, w, h, c, f) + part_elems(1, 1, w, h, c, f);
  const int hid =
      part_elems(2, 1, w, h, c, f) + part_elems(3, 1, w, h, c, f);
  const int zr = part_elems(4, 3, w, h, c, f) + part_elems(5, 3, w, h, c, f) +
                 part_elems(6, 3, w, h, c, f) + part_elems(7, 2, w, h, c, f);
  const int q = part_elems(7, 1, w, h, c, f);
  return max(max(me, hid), max(zr, q));
}

// A warp's 16 rows, in bf16 columns: the intermediates' four regions
// (cor' then z, flo then px_q, hid, rnd(r * netd)), and where the inputs
// are staged (kResident, kStreamed) netd, inp, flow8 and cor (cor over hid
// and r * netd, which it precedes, where it fits there).
struct Rows {
  int ld, cz, fq, hid, rn, net, inp, flow, cor;
};

__host__ __device__ inline Rows rows_layout(int h, int c, int f,
                                            bool staged) {
  const int hp = pad32(h);
  Rows r{4 * hp + kPad, 0, hp, 2 * hp, 3 * hp, -1, -1, -1, -1};
  if (staged) {
    r.net = 4 * hp;
    r.inp = 5 * hp;
    r.flow = r.inp + pad16(c);
    int end = r.flow + 16;
    if (pad16(f) <= 2 * hp) {
      r.cor = r.hid;
    } else {
      r.cor = end;
      end += pad16(f);
    }
    r.ld = end + kPad;
  }
  return r;
}

// Shared memory in bytes: the rounded biases (6 pad32(H) floats), the
// resident weights, and one warp's rows.
__host__ __device__ inline int bias_bytes(int h) { return 24 * pad32(h); }

__host__ __device__ inline int warp_bytes(int h, int c, int f, bool staged) {
  return 2 * kRows * rows_layout(h, c, f, staged).ld;
}

struct Args {
  const float *net, *inp;
  const __nv_bfloat16* cor;
  const float* flow;
  const float* w[kMats];
  const float* bias;
  float* out;
  int rows, h, c, f;
};

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two floats rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_of(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_of(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// d += a . b on the tensor cores (m16n8k16, bf16 inputs, fp32 sums).
// Fragments (g = lane / 4, t = lane % 4): a = A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]; b = B[2t..][g], B[2t+8..][g]; d = C[g][2t],
// C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: volatile, so it keeps its place after the __syncwarp that
// publishes what it reads.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// ---- A operands: 16 rows of the warp's tile, k .. k + 15 ----------------

// A region of the warp's rows in shared memory (ld bf16 per row).
struct SmemA {
  const __nv_bfloat16* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&a)[4], int k,
                                       int lane) const {
    ldsm_x4(a, p + (lane & 15) * ld + k + 8 * (lane >> 4));
  }
};

// kBare: a float32 (rows, width) global array from the tile's first row,
// rounded to bf16; zero past the tile's nv valid rows and past width.
struct GlobalA {
  const float* p;
  int width, nv;
  __device__ __forceinline__ float at(int r, int k) const {
    return r < nv && k < width ? __ldg(p + (long long)r * width + k) : 0.f;
  }
  __device__ __forceinline__ void load(uint32_t (&a)[4], int k,
                                       int lane) const {
    const int g = lane >> 2, c = k + 2 * (lane & 3);
    a[0] = pack(at(g, c), at(g, c + 1));
    a[1] = pack(at(g + 8, c), at(g + 8, c + 1));
    a[2] = pack(at(g, c + 8), at(g, c + 9));
    a[3] = pack(at(g + 8, c + 8), at(g + 8, c + 9));
  }
};

// kBare: the same for the bfloat16 correlation features, as they are.
struct CorA {
  const unsigned short* p;
  int width, nv;
  __device__ __forceinline__ uint32_t at(int r, int k) const {
    return r < nv && k < width ? __ldg(p + (long long)r * width + k) : 0u;
  }
  __device__ __forceinline__ uint32_t at2(int r, int k) const {
    return at(r, k) | (at(r, k + 1) << 16);
  }
  __device__ __forceinline__ void load(uint32_t (&a)[4], int k,
                                       int lane) const {
    const int g = lane >> 2, c = k + 2 * (lane & 3);
    a[0] = at2(g, c);
    a[1] = at2(g + 8, c);
    a[2] = at2(g, c + 8);
    a[3] = at2(g + 8, c + 8);
  }
};

// ---- B operands: rows k .. k + 15 of one gate's channels n .. n + 15 ----

// b[0], b[1]: the n8 tile of channels n .. n + 7; b[2], b[3]: n + 8 ..
// kResident: the bf16 copy in shared memory, p at the gate's first column.
struct SmemB {
  const __nv_bfloat16* p;
  int ld;
  __device__ __forceinline__ void load(uint32_t (&b)[4], int k, int n,
                                       int lane) const {
    const int i = lane >> 3, r = lane & 7;
    ldsm_x4_t(b, p + (k + r + 8 * (i & 1)) * ld + n + 8 * (i >> 1));
  }
};

// kBare: the float32 array in global memory, p at the gate's first
// column, rows of ld floats, k rows and h channels valid; rounded here.
struct GlobalB {
  const float* p;
  int ld, k, h;
  __device__ __forceinline__ float at(int r, int n) const {
    return r < k && n < h ? __ldg(p + (long long)r * ld + n) : 0.f;
  }
  __device__ __forceinline__ void load(uint32_t (&b)[4], int k0, int n,
                                       int lane) const {
    const int r = k0 + 2 * (lane & 3);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = n + 8 * u + (lane >> 2);
      b[2 * u] = pack(at(r, col), at(r + 1, col));
      b[2 * u + 1] = pack(at(r + 8, col), at(r + 9, col));
    }
  }
};

// acc = A[:, 0 : 16 ksteps] . B[0 : 16 ksteps, n .. n + 8 nt), nt n8
// tiles (even, <= kNt), in float32, k ascending; the fragments of kPre
// k-steps are loaded before their products, so that their loads are in
// flight together.
template <class A, class B>
__device__ __forceinline__ void product(float (&acc)[kNt][4], const A& a,
                                        int ksteps, const B& b, int n,
                                        int nt, int lane) {
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  for (int s0 = 0; s0 < ksteps; s0 += kPre) {
    uint32_t af[kPre][4], bf[kPre][kNt / 2][4];
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      if (s0 + i < ksteps) {
        a.load(af[i], 16 * (s0 + i), lane);
#pragma unroll
        for (int j = 0; j < kNt / 2; ++j) {
          if (2 * j < nt) b.load(bf[i][j], 16 * (s0 + i), n + 16 * j, lane);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      if (s0 + i < ksteps) {
#pragma unroll
        for (int j = 0; j < kNt / 2; ++j) {
          if (2 * j < nt) {
            mma(acc[2 * j], af[i], bf[i][j][0], bf[i][j][1]);
            mma(acc[2 * j + 1], af[i], bf[i][j][2], bf[i][j][3]);
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The rounded biases into sb: sb[j * hp + ch] = rnd(bias[j * H + ch]) for
// j < 6 (the packed bias's two rows: cor', flo, hid; z, r, q), zero past H.
__device__ void stage_bias(float* sb, const Args& a) {
  const int h = a.h, hp = pad32(h);
  for (int i = threadIdx.x; i < 6 * hp; i += blockDim.x) {
    const int j = i / hp, ch = i % hp;
    sb[i] = ch < h ? rnd(__ldg(a.bias + j * h + ch)) : 0.f;
  }
}

// One thread's share of staging gates g0 .. g0 + ng - 1, channels col0 ..
// col0 + colw, of matrix m's rows 0 .. pad16(k) into dst as bf16 (row r,
// gate g0 + i, channel col0 + cc at r * (ng colw + kPad) + i colw + cc),
// zeros past k rows and past H: the thread's column of four channels (one
// of ng colw / 4 <= blockDim.x) and every step-th row of it. Every weight
// array (kResident: col0 0, colw pad32(H)) or one stage's columns for a
// block of channels (kStreamed: col0 n, colw kBlock) is a part.
struct Stager {
  const float* s;
  __nv_bfloat16* d;
  int r, rows, k, step, ldg, ld, ch, h;
  bool vec, on;
  __device__ Stager(__nv_bfloat16* dst, const Args& a, int m, int g0,
                    int ng, int col0, int colw) {
    const Mat w = mat(m, a.h, a.c, a.f);
    const int per_row = ng * colw / 4;
    const int i = threadIdx.x, col = 4 * (i % per_row);
    h = a.h;
    k = w.k;
    rows = pad16(w.k);
    step = max(1, (int)blockDim.x / per_row);
    on = i < step * per_row;
    r = i / per_row;
    ch = col0 + col % colw;
    ldg = w.ng * h;
    ld = ng * colw + kPad;
    s = a.w[m] + (g0 + col / colw) * h + ch;
    d = dst + col;
    vec = (h & 3) == 0 && (reinterpret_cast<uintptr_t>(a.w[m]) & 15) == 0;
  }
  __device__ __forceinline__ bool pending() const { return on && r < rows; }
  // Rows r, r + step, ... (kU of them) into v.
  template <int kU>
  __device__ __forceinline__ void load(float4 (&v)[kU]) const {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * step;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!on || rr >= k || ch >= h) continue;
      const float* p = s + (long long)rr * ldg;
      if (vec) {
        v[u] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v[u].x = __ldg(p);
        v[u].y = ch + 1 < h ? __ldg(p + 1) : 0.f;
        v[u].z = ch + 2 < h ? __ldg(p + 2) : 0.f;
        v[u].w = ch + 3 < h ? __ldg(p + 3) : 0.f;
      }
    }
  }
  template <int kU>
  __device__ __forceinline__ void store(const float4 (&v)[kU]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int rr = r + u * step;
      if (on && rr < rows) {
        *reinterpret_cast<uint2*>(d + rr * ld) =
            make_uint2(pack(v[u].x, v[u].y), pack(v[u].z, v[u].w));
      }
    }
    r += kU * step;
  }
};

// Two parts at once, so that the loads of both (kU rows each a thread)
// are in flight together.
__device__ void stage_pair(Stager x, Stager y) {
  constexpr int kU = 8;
  while (x.pending() || y.pending()) {
    float4 vx[kU], vy[kU];
    x.load(vx);
    y.load(vy);
    x.store(vx);
    y.store(vy);
  }
}

// kResident: every weight array into shared memory, two at a time.
__device__ void stage_weights(__nv_bfloat16* ws, const Args& a,
                              const int (&offs)[kMats]) {
  const int hp = pad32(a.h);
#pragma unroll 1
  for (int m = 0; m < kMats; m += 2) {
    stage_pair(Stager(ws + offs[m], a, m, 0, mat(m, a.h, a.c, a.f).ng, 0, hp),
               Stager(ws + offs[m + 1], a, m + 1, 0,
                      mat(m + 1, a.h, a.c, a.f).ng, 0, hp));
  }
}

// Rows row0 .. row0 + 15 of the tile's inputs into the tile's rows,
// rounded to bf16 (cor as it is), each padded with zeros to its region's
// width, rows past nv zero: four consecutive columns an item, the items
// start, start + stride, ... of this lane, kU in flight.
__device__ __forceinline__ void stage_inputs(__nv_bfloat16* rows,
                                             const Rows& L, const Args& a,
                                             long long row0, int nv,
                                             int start, int stride) {
  constexpr int kU = 16;
  const int h = a.h, c = a.c, f = a.f;
  // Regions: netd (to hp), inp (to pad16(C)), flow8 (to 16), cor.
  const int quads[4] = {pad32(h) / 4, pad16(c) / 4, 4, pad16(f) / 4};
  const int width[4] = {h, c, kFlow, f};
  const int col0[4] = {L.net, L.inp, L.flow, L.cor};
  const int total = kRows * (quads[0] + quads[1] + quads[2] + quads[3]);
  for (int b = start; b < total; b += stride * kU) {
    uint2 v[kU];
    int at[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      int i = b + stride * u, x = 0;
      v[u] = make_uint2(0u, 0u);
      at[u] = -1;
      if (i >= total) continue;
      while (i >= kRows * quads[x]) i -= kRows * quads[x++];
      const int r = i / quads[x], q = 4 * (i % quads[x]), w = width[x];
      at[u] = r * L.ld + col0[x] + q;
      if (r >= nv) continue;
      const long long e = (row0 + r) * w + q;
      if (x == 3) {
        const unsigned short* p =
            reinterpret_cast<const unsigned short*>(a.cor) + e;
        uint32_t s[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = q + k < w ? __ldg(p + k) : 0u;
        v[u] = make_uint2(s[0] | s[1] << 16, s[2] | s[3] << 16);
      } else {
        const float* p = (x == 0 ? a.net : x == 1 ? a.inp : a.flow) + e;
        float s[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = q + k < w ? __ldg(p + k) : 0.f;
        v[u] = make_uint2(pack(s[0], s[1]), pack(s[2], s[3]));
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (at[u] >= 0) *reinterpret_cast<uint2*>(rows + at[u]) = v[u];
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = a.h, c = a.c, f = a.f, hp = pad32(h);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Rows L = rows_layout(h, c, f, kMode != kBare);
  const int team_size = team_of(h, kMode == kResident);
  const int team = warp / team_size, member = warp % team_size;
  const int teams = warps / team_size;
  float* sb = reinterpret_cast<float*>(smem_raw);
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + bias_bytes(h));
  __nv_bfloat16* all_rows =
      ws + (kMode == kResident   ? weight_elems(h, c, f)
            : kMode == kStreamed ? slab_elems(h, c, f)
                                 : 0);
  __nv_bfloat16* rows = all_rows + team * kRows * L.ld;

  // The resident weight arrays' offsets.
  int offs[kMats];
  offs[0] = 0;
#pragma unroll
  for (int m = 1; m < kMats; ++m) {
    offs[m] = offs[m - 1] + mat_elems(m - 1, h, c, f);
  }
  const long long tiles = ((long long)a.rows + kRows - 1) / kRows;
  // The first tile's inputs are staged before the weights, so that their
  // loads wait together.
  const long long tile0 = blockIdx.x + (long long)team * gridDim.x;
  if (kMode != kBare && tile0 < tiles) {
    stage_inputs(rows, L, a, tile0 * kRows,
                 (int)min((long long)kRows, a.rows - tile0 * kRows),
                 lane + 32 * member, 32 * team_size);
  }
  stage_bias(sb, a);
  if constexpr (kMode == kResident) stage_weights(ws, a, offs);
  __syncthreads();
  // kStreamed: each stage's parts in the slab, and their row lengths.
  const int colw = team_size * kBlock;
  const int ld1 = colw + kPad, ld2 = 2 * colw + kPad, ld3 = 3 * colw + kPad;
  const int o_wf = part_elems(0, 1, colw, h, c, f);
  const int o_wh2 = part_elems(2, 1, colw, h, c, f);
  const int o_wh3 = part_elems(4, 3, colw, h, c, f);
  const int o_wf3 = o_wh3 + part_elems(5, 3, colw, h, c, f);
  const int o_wn3 = o_wf3 + part_elems(6, 3, colw, h, c, f);
  // The B operand of matrix m, gate gate, in the round of channel blocks
  // from n0 (kStreamed: its part at slab offset off, row length ld, first
  // gate g0).
  const auto wop = [&](int m, int gate, int n0, int off, int ld, int g0) {
    const Mat w = mat(m, h, c, f);
    if constexpr (kMode == kResident) {
      return SmemB{ws + offs[m] + gate * hp, w.ng * hp + kPad};
    } else if constexpr (kMode == kStreamed) {
      return SmemB{ws + off + (gate - g0) * colw - n0, ld};
    } else {
      return GlobalB{a.w[m] + gate * h, w.ng * h, w.k, h};
    }
  };
  // kStreamed: stage s's parts for the channel block from n0 into the
  // slab, by the whole block, two parts at a time, between two block
  // barriers (every warp of the block comes here).
  const auto slab = [&](int stage, int n0) {
    if constexpr (kMode == kStreamed) {
      __syncthreads();
      if (stage == 0) {
        stage_pair(Stager(ws, a, 0, 0, 1, n0, colw),
                   Stager(ws + o_wf, a, 1, 0, 1, n0, colw));
      } else if (stage == 1) {
        stage_pair(Stager(ws, a, 2, 0, 1, n0, colw),
                   Stager(ws + o_wh2, a, 3, 0, 1, n0, colw));
      } else if (stage == 2) {
        stage_pair(Stager(ws, a, 4, 0, 3, n0, colw),
                   Stager(ws + o_wh3, a, 5, 0, 3, n0, colw));
        stage_pair(Stager(ws + o_wf3, a, 6, 0, 3, n0, colw),
                   Stager(ws + o_wn3, a, 7, 0, 2, n0, colw));
      } else {
        Stager x(ws, a, 7, 2, 1, n0, colw), none = x;
        none.on = false;
        stage_pair(x, none);
      }
      __syncthreads();
    }
  };
  // Channel of element e of n8 tile j in the block from channel n, and
  // the row (0 .. 15) of element e.
  const auto chan = [&](int n, int j, int e) {
    return n + 8 * j + 2 * t + (e & 1);
  };
  const auto row = [&](int e) { return g + 8 * (e >> 1); };
  // An element pair (e = 0, 1 or 2, 3) of tile j, packed, into a region.
  const auto put = [&](int region, int n, int j, int e, uint32_t v) {
    *reinterpret_cast<uint32_t*>(rows + row(e) * L.ld + region +
                                 chan(n, j, e)) = v;
  };
  const auto get = [&](int region, int n, int j, int e) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        rows + row(e) * L.ld + region + chan(n, j, e));
    return make_float2(lo_of(v), hi_of(v));
  };
  const auto reg = [&](int region) { return SmemA{rows + region, L.ld}; };
  const int ks_h = pad16(h) / 16, ks_c = pad16(c) / 16, ks_f = pad16(f) / 16;

  const long long stride = (long long)gridDim.x * teams;
  // Publishes a team's stores to its rows to the whole team.
  const auto team_sync = [&]() {
    if (team_size == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" :: "r"(1 + team),
                   "r"(32 * team_size) : "memory");
    }
  };
  // The block's warps take tiles first, first + gridDim.x, ...; in
  // kStreamed they go through the loop together (a warp past the last tile
  // runs on nv = 0 rows: no input is read, no output written), since every
  // slab is staged by the whole block.
  for (long long first = blockIdx.x; first < tiles; first += stride) {
    const long long tile = first + (long long)team * gridDim.x;
    if (kMode != kStreamed && tile >= tiles) break;
    const long long row0 = tile * kRows;
    const int nv = (int)max(0LL, min((long long)kRows, a.rows - row0));
    const GlobalA net{a.net + row0 * h, h, nv};
    const GlobalA inp{a.inp + row0 * c, c, nv};
    const GlobalA flow{a.flow + row0 * kFlow, kFlow, nv};
    const CorA cor{reinterpret_cast<const unsigned short*>(a.cor) + row0 * f,
                   f, nv};
    // acc = an input's A operand . matrix m's gate; x: 0 netd, 1 inp,
    // 2 flow8, 3 cor.
    const auto from_input = [&](float (&acc)[kNt][4], int x, const auto& b,
                                int n, int nt) {
      const int ks = x == 0 ? ks_h : x == 1 ? ks_c : x == 2 ? 1 : ks_f;
      if constexpr (kMode == kBare) {
        if (x == 0) product(acc, net, ks, b, n, nt, lane);
        if (x == 1) product(acc, inp, ks, b, n, nt, lane);
        if (x == 2) product(acc, flow, ks, b, n, nt, lane);
        if (x == 3) product(acc, cor, ks, b, n, nt, lane);
      } else {
        const int at = x == 0 ? L.net : x == 1 ? L.inp : x == 2 ? L.flow
                                                                : L.cor;
        product(acc, reg(at), ks, b, n, nt, lane);
      }
    };
    // netd at a fragment element.
    const auto netd = [&](int n, int j, int e) {
      if constexpr (kMode == kBare) {
        return rnd(net.at(row(e), chan(n, j, e)));
      } else {
        return __bfloat162float(
            rows[row(e) * L.ld + L.net + chan(n, j, e)]);
      }
    };
    float acc[kNt][4], acc2[kNt][4];
    // Each epilogue loads what it reads (biases, netd, z, px_q, the carry)
    // before its stores, so that no load waits on a store that might
    // alias it, and the elements' chains run side by side.

    if constexpr (kMode != kBare) {
      if (first != blockIdx.x) {
        stage_inputs(rows, L, a, row0, nv, lane + 32 * member,
                     32 * team_size);
      }
      team_sync();
    }
    // cor' and flo.
    for (int n0 = 0; n0 < hp; n0 += colw) {
      slab(0, n0);
      const int n = n0 + member * kBlock;
      if (n >= hp) continue;
      const int nt = min(kNt, (hp - n) / 8);
      float b1[kNt][2], b2[kNt][2];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          b1[j][u] = sb[chan(n, j, u)];
          b2[j][u] = sb[hp + chan(n, j, u)];
        }
      }
      from_input(acc, 3, wop(0, 0, n0, 0, ld1, 0), n, nt);
      from_input(acc2, 2, wop(1, 0, n0, o_wf, ld1, 0), n, nt);
      uint32_t v1[kNt][2], v2[kNt][2];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          v1[j][e / 2] = pack(fmaxf(rnd(rnd(acc[j][e]) + b1[j][0]), 0.f),
                              fmaxf(rnd(rnd(acc[j][e + 1]) + b1[j][1]), 0.f));
          v2[j][e / 2] = pack(fmaxf(rnd(rnd(acc2[j][e]) + b2[j][0]), 0.f),
                              fmaxf(rnd(rnd(acc2[j][e + 1]) + b2[j][1]), 0.f));
        }
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (j >= nt) break;
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          put(L.cz, n, j, e, v1[j][e / 2]);
          put(L.fq, n, j, e, v2[j][e / 2]);
        }
      }
    }
    team_sync();
    // hid (over cor, dead now, where cor was staged there).
    for (int n0 = 0; n0 < hp; n0 += colw) {
      slab(1, n0);
      const int n = n0 + member * kBlock;
      if (n >= hp) continue;
      const int nt = min(kNt, (hp - n) / 8);
      float b1[kNt][2];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) b1[j][u] = sb[2 * hp + chan(n, j, u)];
      }
      product(acc, reg(L.cz), ks_h, wop(2, 0, n0, 0, ld1, 0), n, nt, lane);
      product(acc2, reg(L.fq), ks_h, wop(3, 0, n0, o_wh2, ld1, 0), n, nt,
              lane);
      uint32_t v1[kNt][2];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          float v[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            v[u] = fmaxf(rnd(rnd(rnd(acc[j][e + u]) + rnd(acc2[j][e + u]))
                             + b1[j][u]), 0.f);
          }
          v1[j][e / 2] = pack(v[0], v[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (j >= nt) break;
#pragma unroll
        for (int e = 0; e < 4; e += 2) put(L.hid, n, j, e, v1[j][e / 2]);
      }
    }
    team_sync();
    // z, rnd(r * netd) and px_q.
    for (int n0 = 0; n0 < hp; n0 += colw) {
      slab(2, n0);
      const int n = n0 + member * kBlock;
      if (n >= hp) continue;
      const int nt = min(kNt, (hp - n) / 8);
#pragma unroll 1
      for (int gate = 0; gate < 3; ++gate) {
        float px[kNt][4], b1[kNt][2], nd[kNt][4];
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            b1[j][u] = sb[(3 + gate) * hp + chan(n, j, u)];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) nd[j][e] = gate == 1 ? netd(n, j, e) : 0.f;
        }
        from_input(acc, 1, wop(4, gate, n0, 0, ld3, 0), n, nt);
        product(acc2, reg(L.hid), ks_h, wop(5, gate, n0, o_wh3, ld3, 0), n,
                nt, lane);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            px[j][e] = rnd(rnd(acc[j][e]) + rnd(acc2[j][e]));
          }
        }
        from_input(acc, 2, wop(6, gate, n0, o_wf3, ld3, 0), n, nt);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            px[j][e] = rnd(rnd(px[j][e] + rnd(acc[j][e])) + b1[j][e & 1]);
          }
        }
        uint32_t v1[kNt][2];
        if (gate < 2) {
          from_input(acc, 0, wop(7, gate, n0, o_wn3, ld2, 0), n, nt);
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              float v[2];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                v[u] = rnd(sigmoid(rnd(px[j][e + u] + rnd(acc[j][e + u]))));
                if (gate == 1) v[u] = rnd(v[u] * nd[j][e + u]);
              }
              v1[j][e / 2] = pack(v[0], v[1]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kNt; ++j) {
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              v1[j][e / 2] = pack(px[j][e], px[j][e + 1]);
            }
          }
        }
        const int region = gate == 0 ? L.cz : gate == 1 ? L.rn : L.fq;
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          if (j >= nt) break;
#pragma unroll
          for (int e = 0; e < 4; e += 2) put(region, n, j, e, v1[j][e / 2]);
        }
      }
    }
    team_sync();
    // q and the float32 blend.
    for (int n0 = 0; n0 < hp; n0 += colw) {
      slab(3, n0);
      const int n = n0 + member * kBlock;
      if (n >= hp) continue;
      const int nt = min(kNt, (hp - n) / 8);
      float zs[kNt][4], pq[kNt][4], carry[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float2 z = get(L.cz, n, j, e), q = get(L.fq, n, j, e);
          zs[j][e] = z.x;
          zs[j][e + 1] = z.y;
          pq[j][e] = q.x;
          pq[j][e + 1] = q.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = chan(n, j, e), r = row(e);
          carry[j][e] = r < nv && ch < h ? __ldg(a.net + (row0 + r) * h + ch)
                                         : 0.f;
        }
      }
      product(acc, reg(L.rn), ks_h, wop(7, 2, n0, 0, ld1, 2), n, nt, lane);
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float q = rnd(tanhf(rnd(pq[j][e] + rnd(acc[j][e]))));
          acc[j][e] = __fadd_rn(__fmul_rn(rnd(1.f - zs[j][e]), carry[j][e]),
                                rnd(zs[j][e] * q));
        }
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (j >= nt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ch = chan(n, j, e), r = row(e);
          if (r < nv && ch < h) a.out[(row0 + r) * h + ch] = acc[j][e];
        }
      }
    }
    team_sync();
  }
}

}  // namespace

// rows = B * N points; hidden, context, corr_ch: the widths H, C, F;
// blocks: the grid; threads: 32 x the warps of a block (<= 256); smem:
// the block's dynamic shared memory in bytes, opted in above 48 KB. The
// mode follows from the widths, as ops/cuda/gru_iter.py::bf16_gru_plan
// picks it: kResident where the biases (bias_bytes), the weights (2 *
// weight_elems bytes) and four tiles' staged rows (warp_bytes) fit in a
// block, else kStreamed where the biases, a slab (2 * slab_elems bytes)
// and one tile's staged rows fit, else kBare. smem must hold the biases,
// the weights or the slab of the mode, and the rows of every tile the
// block runs at once (a tile per team of two warps where resident above
// H = 32, else per warp); less, or a resident block with an odd number of
// warps above H = 32, is refused (cudaErrorInvalidValue). cor is bfloat16, every other operand
// float32, all contiguous. Returns the opt-in's error, else
// cudaGetLastError() after the launch.
extern "C" int pvraft_gru_update_bf16(
    const float* net, const float* inp, const __nv_bfloat16* cor,
    const float* flow8, const float* wc, const float* wf, const float* wh,
    const float* wn3, const float* wi3, const float* wh3, const float* wf3,
    const float* bias, float* out, int rows, int hidden, int context,
    int corr_ch, int blocks, int threads, int smem, void* stream) {
  const int warps = threads / 32;
  if (hidden < 1 || context < 1 || corr_ch < 1 || blocks < 1 || warps < 1
      || threads % 32 != 0 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long biases = bias_bytes(hidden);
  const long long staged = warp_bytes(hidden, context, corr_ch, true);
  const long long bare = warp_bytes(hidden, context, corr_ch, false);
  const long long weights = 2LL * weight_elems(hidden, context, corr_ch);
  const long long slab = 2LL * slab_elems(hidden, context, corr_ch);
  const int team = team_of(hidden, true);  // where resident
  void (*kernel)(Args);
  long long need;
  if (biases + weights + 4 * staged <= kSmemMax) {
    // Teams of two warps above H = 32.
    if (warps % team != 0) return static_cast<int>(cudaErrorInvalidValue);
    kernel = &gru_bf16_kernel<kResident>;
    need = biases + weights + warps / team * staged;
  } else if (biases + slab + staged <= kSmemMax) {
    kernel = &gru_bf16_kernel<kStreamed>;
    need = biases + slab + warps * staged;
  } else {
    kernel = &gru_bf16_kernel<kBare>;
    need = biases + warps * bare;
  }
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{net, inp, cor, flow8,
               {wc, wf, wh, wh + (long long)hidden * hidden, wi3, wh3, wf3,
                wn3},
               bias, out, rows, hidden, context, corr_ch};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (rows > 0) {
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
