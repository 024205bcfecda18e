// General-width fused MotionEncoder + ConvGRU update for Hopper (sm_90a),
// on the tensor cores at fp32 accuracy (3xTF32).
//
// Replaces the Pallas TPU kernel pvraft_tpu/ops/pallas/gru_iter.py
// (_gru_forward / _gru_kernel; the math is _gru_math, :78-119) at the widths
// the tuned kernel (gru_iter.cu: hidden = context = correlation width 64,
// every operand 16-byte aligned) does not take: any hidden width H, context
// width C and correlation-feature width F, every operand float32:
//   cor = relu(cor_in . wc + b0[0:H]);  flo = relu(flow8 . wf + b0[H:2H])
//   hid = relu(cor . wh[:H] + flo . wh[H:] + b0[2H:3H])
//   px  = inp . wi3 + hid . wh3 + flow8 . wf3 + b1
//   z = sigmoid(px_z + net . wn3_z);  r = sigmoid(px_r + net . wn3_r)
//   q = tanh(px_q + (r * net) . wn3_q);  out = (1 - z) * net + z * q
//
// Bound on the H100: 2 (F H + 8 H + 2 H^2 + (C + H + 8 + H) 3H) FLOP a
// point, run as three TF32 tensor-core products per fp32 product (495
// TFLOP/s), against 4 (2H + C + F + 8) bytes a point and the weights once
// (3.35 TB/s). At hidden 32 / context 96 / F 64, 1 x 8192: 0.336 GFLOP ->
// 0.0020 ms of 3xTF32, 7.69 MB -> 0.0023 ms of bytes (the bound); the same
// work on the fp32 CUDA cores would take 0.0050 ms.
//
// Design (kernel 2's, gru_iter.cu, generalised to any widths), what each
// part addresses, and what it measured (device time, 1 x 8192, H100 80GB
// HBM3 at 700 W, python -m pvraft_tpu_torch.gru_ab --entry general; the
// FMA body this replaces took 0.0473 ms at 32 / 96 / 64, of which 0.0245
// its products and weight loads, 0.0118 its staging):
//  * Products on mma.sync m16n8k8 TF32 at fp32 accuracy: each operand is
//    split into hi = x rounded to TF32 (to nearest, ties away) and lo =
//    x - hi (exact); per 8-deep step a_lo.b_hi, a_hi.b_lo, a_hi.b_hi go
//    into zeroed partial sums that a rounded fp32 add takes onto the
//    accumulator every 32 input rows: 1e-6 to 3e-6 from gru_math.
//  * A block holds `rows` points (64, or 32 where a layout of 64 does not
//    fit). A warp owns 32 of them (two m16 tiles) and one n8 channel tile
//    of every stage (cor, flo, hid, and z, r, q of the same channels), so
//    that z, r, q and net of a (point, channel) meet in one thread's
//    accumulator fragments; 16 warps at most, so hidden <= 128. Widths pad
//    to n8 tiles and 8-deep steps with zeros, which add exact zeros. (Two
//    tiles a warp read 14-15% slower at widths 96; 16-point warps no
//    faster at 32.)
//  * Activations stay fp32 in shared memory, one row a point: net, flow8,
//    cor_in (then hid), cor (then r * net), flo (then the new state) and
//    inp, each padded to 8 floats, the row to 4 mod 8 so that fragment
//    reads are free of bank conflicts; a fragment is split as it is read
//    ((hi, lo) pair rows take twice the room, which the weights need, and
//    a register shuffle a fragment).
//  * Weights: "resident" where all eight arrays fit in shared memory
//    beside the tile (each gate's columns padded to the n8 tiles, rows to
//    8 or 24 mod 32 floats), in three groups that the stages wait for in
//    turn; else "ring": chunks of 8 to 64 input rows of one array (the
//    most that fit) stream from L2 through three slots, two chunks ahead,
//    one barrier a chunk. At 32 / 96 resident took 0.0187 ms, the ring
//    0.0298.
//  * Inputs and weights move by bulk (TMA) copies, a row each, on
//    mbarriers that count their bytes, where h, c, f are multiples of 4
//    (inputs) and h of 8 (weights) and the arrays aligned; else by every
//    thread's cp.async, 16 or 4 bytes. A clock64 timeline of one block at
//    32 / 96 read 10k of its 31k cycles issuing the 85 KB of weights as
//    16-byte cp.async, 3k as bulk copies (two builds, two calls).
//  * Epilogues on the accumulator fragments: bias, ReLU, expf sigmoid,
//    tanhf (no fast math), r * net and the blend; the new state leaves
//    through shared memory by 16-byte stores where H % 4 == 0, else scalar
//    ones. Rows past the last point are computed on zeros and never
//    written. A fixed order of sums and no atomics: two launches are
//    bitwise equal.
//  * Widths no tensor-core layout takes (hidden > 128, or rows too wide
//    for 32 points): mode "fma", the earlier body (one thread per output
//    channel and group of 8 points, fp32 FMAs, weights through __ldg).
// Times: 0.0175-0.0182 ms at 32 / 96 / 64 (bound 0.0023), 0.0151-0.0155 at
// widths 32, 0.0227-0.0236 at 48 / 80 and 33 / 50 / 37 (resident);
// 0.084-0.085 at 96 / 32, 0.105-0.106 at 96, 0.159-0.160 at 128 (ring;
// bounds 0.0092, 0.0110, 0.0191 of 3xTF32). What holds the ring widths:
// with the weight copies removed they read 0.084 and 0.122 at 96 and 128,
// so ~80% is the products' own issue: every channel-tile warp splits the
// same activation fragments again, which one-tile stages (cor, flo, hid,
// q) pay at ~45 cycles a product against the gates' ~20.
// The host plan (ops/cuda/gru_iter.py::general_gru_plan) picks the mode
// and the points per block from the widths; the entry point below checks
// its launch shape against the same formulas (the PLAN block).

#include <cuda_runtime.h>

#include <cstdint>

#ifndef PLAN_FN
#define PLAN_FN __host__ __device__ inline
#endif

// BEGIN PLAN: the launch-shape formulas of ops/cuda/gru_iter.py::
// general_gru_plan (plain C++, tested against it on the host).
namespace plan {

constexpr int kSmemMax = 232448;   // shared memory a block can have
constexpr int kFlow = 8;           // FLOW_PAD
constexpr int kMaxTiles = 16;      // n8 channel tiles a layout takes
constexpr int kSlots = 3;          // ring slots
constexpr int kBarrierBytes = 64;  // the tensor-core modes' mbarriers
enum { kFma = 0, kResident = 1, kRing = 2 };

PLAN_FN int pad8(int x) { return (x + 7) / 8 * 8; }
PLAN_FN int pad4(int x) { return (x + 3) / 4 * 4; }
// A weight row of n floats (a multiple of 8) padded to 8 or 24 mod 32:
// rows whose fragment reads (b = W[t][g], W[t+4][g]) are free of bank
// conflicts.
PLAN_FN int ld(int n) { return n % 16 == 0 ? n + 8 : n; }
PLAN_FN int tiles(int h) { return (h + 7) / 8; }
// Floats of one point's row: net, flow8, cor_in | hid, cor | r * net,
// flo | out, inp, each padded to 8, the row to 4 mod 8 (fragment reads,
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4], free of bank
// conflicts).
PLAN_FN int row_floats(int h, int c, int f) {
  const int hp = pad8(h), fp = pad8(f);
  return 3 * hp + kFlow + (fp > hp ? fp : hp) + pad8(c) + 4;
}
// Floats of the eight weight arrays, resident.
PLAN_FN long long weight_floats(int h, int c, int f) {
  const int hp = pad8(h);
  return (long long)(pad8(f) + kFlow + 2 * hp) * ld(hp) +
         (long long)(pad8(c) + 2 * hp + kFlow) * ld(3 * hp);
}
PLAN_FN long long fma_point_bytes(int h, int c, int f) {
  return 4LL * (7 * pad4(h) + pad4(c) + pad4(f) + kFlow);
}

// Shared memory bytes of mode `mode` at `rows` points a block, or -1
// where that layout does not exist; its threads and (ring) chunk rows.
PLAN_FN long long need(int mode, int rows, int h, int c, int f, int* threads,
                       int* chunk) {
  *threads = 0;
  *chunk = 0;
  if (h < 1 || c < 1 || f < 1 || rows < 1) return -1;
  if (mode == kFma) {
    if (rows % 8 != 0) return -1;
    const long long t = ((long long)(rows / 8) * h + 31) / 32 * 32;
    *threads = t < 256 ? (int)t : 256;
    return rows * fma_point_bytes(h, c, f);
  }
  if ((mode != kResident && mode != kRing) || (rows != 32 && rows != 64) ||
      tiles(h) > kMaxTiles) {
    return -1;
  }
  const int warps = rows / 32 * tiles(h);   // a warp: 32 rows, one n8 tile
  if (warps > 16) return -1;
  *threads = 32 * warps;
  const long long act = (long long)rows * row_floats(h, c, f);
  if (mode == kResident) {
    return 4 * (act + weight_floats(h, c, f)) + kBarrierBytes;
  }
  // Ring chunks: the most rows (a multiple of 8, 8 to 64) whose kSlots
  // slots fit beside the tile.
  const long long slot_row = (long long)kSlots * ld(3 * pad8(h));
  long long kc = ((kSmemMax - kBarrierBytes) / 4 - act) / slot_row / 8 * 8;
  kc = kc < 8 ? 8 : kc > 64 ? 64 : kc;
  *chunk = (int)kc;
  return 4 * (act + kc * slot_row) + kBarrierBytes;
}

}  // namespace plan
// END PLAN

namespace {

using plan::kFlow;
constexpr int kM = 2;   // m16 tiles a warp: 32 rows (plan::need counts so)

struct Args {
  const float *net, *inp, *cor, *flow;
  const float *wc, *wf, *wh, *wn3, *wi3, *wh3, *wf3, *bias;
  float* out;
  int rows, h, c, f, block_rows, chunk;
};

// ------------------------------------------------------------- helpers --

// x = hi + lo exactly: hi is x rounded to TF32 (10 mantissa bits, to
// nearest, ties away from zero: cvt.rna.tf32.f32 for finite x, in two
// integer instructions), lo = x - hi is exact in fp32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b on the tensor cores (m16n8k8, TF32 inputs, fp32 sums).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// mbarriers and bulk (TMA) copies: one instruction moves a whole row,
// completing on an mbarrier that counts its bytes.
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(saddr(bar)) : "memory");
}

// The barrier's one arrival, and the bytes its phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(saddr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of the given parity; a phase that never completes
// (bytes that never arrive) ends the launch with an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(saddr(bar)), "r"(parity) : "memory");
    if (spin > (1LL << 26)) __trap();
  }
}

// bytes (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// Shared memory written by this thread's loads and stores before it, in
// order before its later bulk copies (the async proxy).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------ weights --

// A weight piece, in the order the stages read them: `rows` input rows
// (zero-padded to pad8) of `ng` gates of h columns each, gate g0 first,
// of a row-major array of `ld` floats a row.
struct Piece {
  const float* src;
  int ld, rows, g0, ng;
};
constexpr int kPieces = 9;

__device__ __forceinline__ Piece piece(const Args& a, int i) {
  const int h = a.h, h3 = 3 * a.h;
  switch (i) {
    case 0: return {a.wc, h, a.f, 0, 1};                 // cor
    case 1: return {a.wf, h, kFlow, 0, 1};               // flo
    case 2: return {a.wh, h, h, 0, 1};                   // hid over cor
    case 3: return {a.wh + (long long)h * h, h, h, 0, 1};  // and over flo
    case 4: return {a.wi3, h3, a.c, 0, 3};               // gates over inp
    case 5: return {a.wh3, h3, h, 0, 3};                 // over hid
    case 6: return {a.wf3, h3, kFlow, 0, 3};             // over flow8
    case 7: return {a.wn3, h3, h, 0, 2};                 // z, r over net
    default: return {a.wn3, h3, h, 2, 1};                // q over r * net
  }
}

// Input rows [r0, r0 + n) of piece p (n a multiple of 8) into dst, rows
// of ldd floats, gate g at column g * hp: cp.async for the elements that
// exist (16 bytes where h % 4 == 0 and the array is aligned), zeros for
// the padding rows and columns. A thread keeps one 4-column group of the
// destination rows (ng * hp / 4 of them, at most 96, never more than the
// block's threads) and walks the rows: its divisions are made once.
__device__ __forceinline__ void copy_piece(float* dst, int ldd,
                                           const Piece& p, int r0, int n,
                                           int h, int hp, int tid,
                                           int nthreads) {
  const int hp4 = hp / 4, per_row = p.ng * hp4;
  const int step = nthreads / per_row;
  const int r1 = tid / per_row, c4 = tid - r1 * per_row;
  if (r1 >= step) return;
  const int g = c4 / hp4, q = 4 * (c4 - g * hp4);
  const bool col = q < h, vec = h % 4 == 0 && aligned16(p.src);
  float* d = dst + r1 * ldd + 4 * c4;
  const float* src = p.src + (long long)(r0 + r1) * p.ld + (p.g0 + g) * h + q;
#pragma unroll 4
  for (int r = r1; r < n; r += step) {
    if (col && r0 + r < p.rows) {
      if (vec) {
        cp_async16(d, src);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q + u < h) {
            cp_async4(d + u, src + u);
          } else {
            d[u] = 0.f;
          }
        }
      }
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    d += step * ldd;
    src += (long long)step * p.ld;
  }
}

// ----------------------------------------------------------- products --

// acc[i][J0 + j] += A[16 i .. + 16][0 : 8 S] . W[0 : 8 S][col[j] .. + 8]
// for i < kM, j < NJ, in 3xTF32: S steps of 8 rows, every one present (no
// guard between them, so that the loads of later steps issue early), into
// zeroed partial sums (two sets, alternating by step, where NJ <= 2) that
// rounded fp32 adds take onto acc at the end. A points at the warp's first
// row and the region's first column, rows of lda floats; W at the first
// row, rows of ldw floats; both split here. Fragment layouts of m16n8k8
// (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = W[t][g], W[t+4][g]; acc = C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1].
template <int S, int NACC, int J0, int NJ>
__device__ __forceinline__ void mma_steps(float (&acc)[kM][NACC][4],
                                          const float* a, int lda,
                                          const float* w, int ldw,
                                          const int (&col)[NJ], int lane) {
  constexpr int P = NJ <= 2 && S > 1 ? 2 : 1;
  const int g = lane >> 2, t = lane & 3;
  float part[P][kM][NJ][4];
#pragma unroll
  for (int u = 0; u < P; ++u)
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[u][i][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* q = w + (8 * s + t) * ldw + col[j] + g;
      split(q[0], bh[j][0], bl[j][0]);
      split(q[4 * ldw], bh[j][1], bl[j][1]);
    }
    uint32_t ah[kM][4], al[kM][4];
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const float* p = a + (16 * i + g) * lda + 8 * s + t;
      split(p[0], ah[i][0], al[i][0]);
      split(p[8 * lda], ah[i][1], al[i][1]);
      split(p[4], ah[i][2], al[i][2]);
      split(p[8 * lda + 4], ah[i][3], al[i][3]);
    }
    float (&ps)[kM][NJ][4] = part[s % P];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(ps[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(ps[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma(ps[i][j], ah[i], bh[j][0], bh[j][1]);
  }
#pragma unroll
  for (int u = 0; u < P; ++u)
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][J0 + j][e] += part[u][i][j][e];
}

// The same over ks steps: groups of four (32 rows a partial sum), then
// the rest.
template <int NACC, int J0, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[kM][NACC][4],
                                         const float* a, int lda,
                                         const float* w, int ldw,
                                         const int (&col)[NJ], int ks,
                                         int lane) {
  int s = 0;
  for (; s + 4 <= ks; s += 4) {
    mma_steps<4, NACC, J0, NJ>(acc, a + 8 * s, lda, w + 8 * s * ldw, ldw,
                               col, lane);
  }
  switch (ks - s) {
    case 3:
      mma_steps<3, NACC, J0, NJ>(acc, a + 8 * s, lda, w + 8 * s * ldw, ldw,
                                 col, lane);
      break;
    case 2:
      mma_steps<2, NACC, J0, NJ>(acc, a + 8 * s, lda, w + 8 * s * ldw, ldw,
                                 col, lane);
      break;
    case 1:
      mma_steps<1, NACC, J0, NJ>(acc, a + 8 * s, lda, w + 8 * s * ldw, ldw,
                                 col, lane);
      break;
    default:
      break;
  }
}

// Where the weights come from: resident (every piece at a fixed place,
// copied at the start in three cp.async groups) or a ring of kSlots slots
// of `chunk` rows that the pieces stream through in order, one barrier a
// chunk (which also publishes what the warps stored before it).
struct Weights {
  const Args* a;
  float* base;      // resident arrays, or the ring's first slot
  uint64_t* bars;   // resident: a barrier per group; ring: one per slot
  bool ring, bulk;  // bulk: rows move by bulk copies (h % 8 == 0, aligned)
  int hp, ld1, ld3, chunk, tid, nthreads;
  int next;         // ring: the next chunk to consume
  int fp, fr;       // ring: the next chunk to fetch (piece, first row)

  __device__ __forceinline__ float* slot(int c) const {
    return base + (c % plan::kSlots) * chunk * ld3;
  }
  // Ring, bulk copies: the bytes of the next chunk's rows that exist,
  // which its slot's barrier waits for (one thread, before a barrier that
  // orders it before the copies).
  __device__ __forceinline__ void expect(int c) const {
    if (fp < kPieces) {
      const Piece p = piece(*a, fp);
      const int n = min(chunk, plan::pad8(p.rows) - fr);
      mbar_expect(bars + c % plan::kSlots,
                  4u * max(0, min(n, p.rows - fr)) * p.ng * a->h);
    }
  }
  // Ring: copy the next chunk into its slot (an empty group at the end):
  // a bulk copy a row, one row a thread, on the slot's barrier, else every
  // thread's cp.async.
  __device__ __forceinline__ void fetch(int c) {
    if (fp < kPieces) {
      const Piece p = piece(*a, fp);
      const int n = min(chunk, plan::pad8(p.rows) - fr);
      if (!bulk) {
        copy_piece(slot(c), ld3, p, fr, n, a->h, hp, tid, nthreads);
      } else {
        fence_async();
        for (int r = tid; r < n; r += nthreads) {
          float* d = slot(c) + r * ld3;
          if (fr + r < p.rows) {
            bulk_copy(d, p.src + (long long)(fr + r) * p.ld + p.g0 * a->h,
                      4u * p.ng * a->h, bars + c % plan::kSlots);
          } else {
            for (int k = 0; k < p.ng * hp; ++k) d[k] = 0.f;
          }
        }
      }
    }
    fetch_state_next();
    cp_async_commit();
  }
  // Ring: wait for chunk `next` (and every copy before it), then refill
  // the slot of the chunk before it, which every warp has left.
  __device__ __forceinline__ const float* acquire() {
    const int c = next++;
    if (bulk) {
      mbar_wait(bars + c % plan::kSlots, (c / plan::kSlots) & 1);
      if (tid == 0) expect(c + plan::kSlots - 1);
    } else {
      cp_async_wait<plan::kSlots - 2>();
    }
    __syncthreads();
    fetch(c + plan::kSlots - 1);
    return slot(c);
  }
  // Resident: the array of piece i, in the order of the pieces: wc, wf,
  // wh over cor, wh over flo (rows of ld1), wi3, wh3, wf3, wn3 whole (rows
  // of ld3); piece 8 reads wn3's gate q.
  __device__ __forceinline__ float* resident(int i) const {
    const int k = i == 8 ? 7 : i;
    long long off = 0;
    if (k > 0) off += (long long)plan::pad8(a->f) * ld1;
    if (k > 1) off += kFlow * ld1;
    if (k > 2) off += hp * ld1;
    if (k > 3) off += hp * ld1;
    if (k > 4) off += (long long)plan::pad8(a->c) * ld3;
    if (k > 5) off += hp * ld3;
    if (k > 6) off += kFlow * ld3;
    return base + off + (i == 8 ? 2 * hp : 0);
  }
  __device__ __forceinline__ int ld_of(int i) const { return i < 4 ? ld1 : ld3; }
  // The fetch state past one chunk.
  __device__ __forceinline__ void fetch_state_next() {
    if (fp < kPieces) {
      fr += chunk;
      if (fr >= plan::pad8(piece(*a, fp).rows)) {
        ++fp;
        fr = 0;
      }
    }
  }
};

// acc[.][J0 + j] += A . piece i over its columns col[j], A pointing at the
// warp's first row and the A region's first column.
template <int NACC, int J0, int NJ>
__device__ __forceinline__ void product(float (&acc)[kM][NACC][4],
                                       Weights& wts, int i, const float* a,
                                       int lda, const int (&col)[NJ],
                                       int lane) {
  const int rp = plan::pad8(piece(*wts.a, i).rows);
  if (wts.ring) {
    for (int r = 0; r < rp; r += wts.chunk) {
      const float* w = wts.acquire();
      mma_rows<NACC, J0, NJ>(acc, a + r, lda, w, wts.ld3, col,
                             min(wts.chunk, rp - r) / 8, lane);
    }
  } else {
    mma_rows<NACC, J0, NJ>(acc, a, lda, wts.resident(i), wts.ld_of(i), col,
                           rp / 8, lane);
  }
}

// ---------------------------------------------------------- epilogues --

// Accumulator tile j of every m16 tile starts at bias[ch + its column],
// zero past h.
template <int NACC>
__device__ __forceinline__ void init_bias(float (&acc)[kM][NACC][4], int j,
                                          const float* __restrict__ bias,
                                          int ch, int h, int lane) {
  const int c0 = ch + 2 * (lane & 3);
  const float b0 = c0 < h ? __ldg(bias + c0) : 0.f;
  const float b1 = c0 + 1 < h ? __ldg(bias + c0 + 1) : 0.f;
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    acc[i][j][0] = b0;
    acc[i][j][1] = b1;
    acc[i][j][2] = b0;
    acc[i][j][3] = b1;
  }
}

// relu(acc) of the warp's channel tile into a region.
__device__ __forceinline__ void store_relu(const float (&acc)[kM][1][4],
                                           float* region, int lda, int ch,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(region + (16 * i + g + 8 * hh) * lda + ch +
                                 2 * t) =
          make_float2(fmaxf(acc[i][0][2 * hh], 0.f),
                      fmaxf(acc[i][0][2 * hh + 1], 0.f));
}

// ------------------------------------------------------------ staging --

// Rows [row0, row0 + rows) of a (., w) input into the columns [off, off +
// pad8(w)) of the tile's rows, by cp.async (16 bytes where w % 4 == 0 and
// the rows are aligned, else 4), zeros past w and past the last point.
// Thread items advance by a fixed stride: no division but the first.
__device__ __forceinline__ void stage(float* act, int lda, int off,
                                      const float* src, int w,
                                      long long row0, int rows, int valid,
                                      int tid, int nthreads) {
  const int per = plan::pad8(w) / 4;
  const bool vec = w % 4 == 0 && aligned16(src);
  const int dr = nthreads / per, dc = nthreads - dr * per;
  int r = tid / per, c = tid - r * per;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per) {
      c -= per;
      ++r;
      if (r >= rows) break;
    }
    const int q = 4 * c;
    float* d = act + r * lda + off + q;
    if (r < valid && q < w) {
      const float* s = src + (row0 + r) * w + q;
      if (vec) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q + u < w) {
            cp_async4(d + u, s + u);
          } else {
            d[u] = 0.f;
          }
        }
      }
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ------------------------------------------------ tensor-core kernel --

__device__ __forceinline__ void tc_body(const Args& a, int mode) {
  extern __shared__ __align__(16) float smem[];
  const int h = a.h, hp = plan::pad8(h), nt = plan::tiles(h);
  const int xp = max(plan::pad8(a.f), hp), cp8 = plan::pad8(a.c);
  const int lda = plan::row_floats(h, a.c, a.f);
  // Offsets (floats) of the regions in a point's row.
  const int o_net = 0, o_flow = hp, o_x = o_flow + kFlow;
  const int o_y = o_x + xp, o_z = o_y + hp, o_inp = o_z + hp;
  const int rows = a.block_rows;
  float* act = smem;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * rows;
  const int valid = (int)min((long long)rows, a.rows - row0);

  // Bulk copies move whole rows where the widths allow it: the inputs
  // where h, c and f are multiples of 4 and the arrays aligned, the
  // weights where h is a multiple of 8 (gates need no column padding) and
  // the arrays aligned. Else every thread's cp.async moves 16 or 4 bytes.
  const bool bulk_in = (h | a.c | a.f) % 4 == 0 && aligned16(a.net) &&
                       aligned16(a.inp) && aligned16(a.cor) &&
                       aligned16(a.flow);
  const bool bulk_w = h % 8 == 0 && aligned16(a.wc) && aligned16(a.wf) &&
                      aligned16(a.wh) && aligned16(a.wn3) &&
                      aligned16(a.wi3) && aligned16(a.wh3) &&
                      aligned16(a.wf3);
  const bool ring = mode == plan::kRing;
  const int ld1 = plan::ld(hp), ld3 = plan::ld(3 * hp);
  float* wbase = smem + rows * lda;
  // mbarriers: the inputs, then the resident groups or the ring's slots.
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      wbase + (ring ? plan::kSlots * a.chunk * ld3
                    : plan::weight_floats(h, a.c, a.f)));
  Weights wts{&a, wbase, bars + 1, ring, bulk_w, hp, ld1, ld3, a.chunk,
              tid, nthreads, 0, 0, 0};
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (bulk_in) mbar_expect(bars, 4u * valid * (h + a.c + a.f + kFlow));
    if (bulk_w && ring) {
      // The ring's first chunks: the fetch state walks them, then rewinds.
      for (int c = 0; c < plan::kSlots - 1; ++c) {
        wts.expect(c);
        wts.fetch_state_next();
      }
      wts.fp = wts.fr = 0;
    }
    if (bulk_w && !ring) {
      mbar_expect(bars + 1, 4u * (a.f + kFlow) * h);
      mbar_expect(bars + 2, 4u * 2 * h * h);
      mbar_expect(bars + 3, 4u * (a.c + 2 * h + kFlow) * 3 * h);
    }
  }
  __syncthreads();

  // The inputs first (one cp.async group, empty after bulk copies), then
  // the weights.
  if (bulk_in) {
    for (int e = tid; e < 4 * rows; e += nthreads) {
      const int r = e >> 2, k = e & 3;
      const float* src = k == 0 ? a.cor : k == 1 ? a.flow : k == 2 ? a.net
                                                                    : a.inp;
      const int w = k == 0 ? a.f : k == 1 ? kFlow : k == 2 ? h : a.c;
      float* d = act + r * lda +
                 (k == 0 ? o_x : k == 1 ? o_flow : k == 2 ? o_net : o_inp);
      int from = 0;
      if (r < valid) {
        bulk_copy(d, src + (row0 + r) * w, 4u * w, bars);
        from = w;
      }
      for (int q = from; q < plan::pad8(w); q += 4) {
        *reinterpret_cast<float4*>(d + q) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    stage(act, lda, o_x, a.cor, a.f, row0, rows, valid, tid, nthreads);
    stage(act, lda, o_flow, a.flow, kFlow, row0, rows, valid, tid, nthreads);
    stage(act, lda, o_net, a.net, h, row0, rows, valid, tid, nthreads);
    stage(act, lda, o_inp, a.inp, a.c, row0, rows, valid, tid, nthreads);
  }
  cp_async_commit();
  if (ring) {
    for (int c = 0; c < plan::kSlots - 1; ++c) wts.fetch(c);
  } else if (bulk_w) {
    // Every row of the eight arrays (wn3 whole: piece 8 reads its gate q)
    // by a bulk copy on its group's barrier: the MotionEncoder's first
    // arrays, wh, then the gates'; padding rows zero.
    int total = 0;
    for (int i = 0; i < 8; ++i) total += plan::pad8(piece(a, i).rows);
    for (int e = tid; e < total; e += nthreads) {
      int i = 0, r = e;
      while (r >= plan::pad8(piece(a, i).rows)) r -= plan::pad8(piece(a, i++).rows);
      Piece p = piece(a, i);
      if (i == 7) p.ng = 3;
      float* d = wts.resident(i) + r * wts.ld_of(i);
      if (r < p.rows) {
        bulk_copy(d, p.src + (long long)r * p.ld, 4u * p.ng * h,
                  bars + 1 + (i < 2 ? 0 : i < 4 ? 1 : 2));
      } else {
        for (int k = 0; k < p.ng * hp; ++k) d[k] = 0.f;
      }
    }
    for (int k = 0; k < 3; ++k) cp_async_commit();
  } else {
    // Three groups, waited for by the stages in turn: the MotionEncoder's
    // first arrays, wh, then the gates'.
    for (int i = 0; i < 8; ++i) {
      Piece p = piece(a, i);
      if (i == 7) p.ng = 3;      // wn3 whole: piece 8 reads its gate q
      copy_piece(wts.resident(i), wts.ld_of(i), p, 0,
                 plan::pad8(p.rows), h, hp, tid, nthreads);
      if (i == 1 || i == 3 || i == 7) cp_async_commit();
    }
  }

  // This warp: rows r0 .. + 32 and channel tile warp % nt, columns ch ..
  // + 8 of every stage; gcol: its columns of the gates z, r, q.
  const int r0 = 32 * (warp / nt), ch = 8 * (warp % nt);
  const int gcol[3] = {ch, hp + ch, 2 * hp + ch};
  const int col1[1] = {ch};
  const float* b0 = a.bias;           // MotionEncoder biases
  const float* b1 = a.bias + 3 * h;   // gate biases
  float* rowp = act + r0 * lda;       // this warp's first row

  if (bulk_in) mbar_wait(bars, 0);
  if (!ring) {
    cp_async_wait<2>();   // the inputs, wc and wf
    if (bulk_w) mbar_wait(bars + 1, 0);
    __syncthreads();
  }
  // MotionEncoder: cor, flo, then hid over concat(cor, flo).
  {
    float acc[kM][1][4];
    init_bias<1>(acc, 0, b0, ch, h, lane);
    product<1, 0, 1>(acc, wts, 0, rowp + o_x, lda, col1, lane);
    store_relu(acc, rowp + o_y, lda, ch, lane);
    init_bias<1>(acc, 0, b0 + h, ch, h, lane);
    product<1, 0, 1>(acc, wts, 1, rowp + o_flow, lda, col1, lane);
    store_relu(acc, rowp + o_z, lda, ch, lane);
  }
  if (!ring) {
    cp_async_wait<1>();
    if (bulk_w) mbar_wait(bars + 2, 0);
    __syncthreads();
  }
  {
    float acc[kM][1][4];
    init_bias<1>(acc, 0, b0 + 2 * h, ch, h, lane);
    product<1, 0, 1>(acc, wts, 2, rowp + o_y, lda, col1, lane);
    product<1, 0, 1>(acc, wts, 3, rowp + o_z, lda, col1, lane);
    store_relu(acc, rowp + o_x, lda, ch, lane);   // hid over cor_in
  }
  if (!ring) {
    cp_async_wait<0>();
    if (bulk_w) mbar_wait(bars + 3, 0);
    __syncthreads();
  }

  // ConvGRU. Accumulator tiles 0, 1 and 2 are z, r and q of the warp's
  // channels.
  const int g = lane >> 2, t = lane & 3;
  float acc[kM][3][4];
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
    init_bias<3>(acc, gate, b1 + gate * h, ch, h, lane);
  product<3, 0, 3>(acc, wts, 4, rowp + o_inp, lda, gcol, lane);
  product<3, 0, 3>(acc, wts, 5, rowp + o_x, lda, gcol, lane);
  product<3, 0, 3>(acc, wts, 6, rowp + o_flow, lda, gcol, lane);
  {
    const int zr[2] = {gcol[0], gcol[1]};
    product<3, 0, 2>(acc, wts, 7, rowp + o_net, lda, zr, lane);
  }
  // z stays in its accumulators; r * net goes to the cor region.
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* row = rowp + (16 * i + g + 8 * hh) * lda;
      const int c = ch + 2 * t;
      const float2 n = *reinterpret_cast<const float2*>(row + o_net + c);
      acc[i][0][2 * hh] = sigmoidf(acc[i][0][2 * hh]);
      acc[i][0][2 * hh + 1] = sigmoidf(acc[i][0][2 * hh + 1]);
      *reinterpret_cast<float2*>(row + o_y + c) =
          make_float2(sigmoidf(acc[i][1][2 * hh]) * n.x,
                      sigmoidf(acc[i][1][2 * hh + 1]) * n.y);
    }
  }
  if (!ring) __syncthreads();   // (the ring's next acquire publishes it)
  product<3, 2, 1>(acc, wts, 8, rowp + o_y, lda, col1, lane);
  // q and the blend; the new state goes to the flo region.
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* row = rowp + (16 * i + g + 8 * hh) * lda;
      const int c = ch + 2 * t;
      const float2 n = *reinterpret_cast<const float2*>(row + o_net + c);
      const float z0 = acc[i][0][2 * hh], z1 = acc[i][0][2 * hh + 1];
      *reinterpret_cast<float2*>(row + o_z + c) = make_float2(
          (1.f - z0) * n.x + z0 * tanhf(acc[i][2][2 * hh]),
          (1.f - z1) * n.y + z1 * tanhf(acc[i][2][2 * hh + 1]));
    }
  }
  __syncthreads();
  if (h % 4 == 0) {
    const int per = h / 4;
    for (int e = tid; e < valid * per; e += nthreads) {
      const int p = e / per, q = 4 * (e - p * per);
      *reinterpret_cast<float4*>(a.out + (row0 + p) * h + q) =
          *reinterpret_cast<const float4*>(act + p * lda + o_z + q);
    }
  } else {
    for (int e = tid; e < valid * h; e += nthreads) {
      const int p = e / h, q = e - p * h;
      a.out[(row0 + p) * h + q] = act[p * lda + o_z + q];
    }
  }
}

// ------------------------------------------------------------ fma mode --

constexpr int kPoints = 8;  // points per thread, one FMA chain each

__host__ __device__ constexpr int pad4c(int x) { return (x + 3) & ~3; }

// A point's row in shared memory: offsets of its segments, in floats.
struct Layout {
  int net, inp, cor, flow, corp, flo, hid, z, rn, pq, stride;
  __device__ Layout(int h, int c, int f) {
    const int h4 = pad4c(h);
    net = 0;
    inp = net + h4;
    cor = inp + pad4c(c);
    flow = cor + pad4c(f);
    corp = flow + kFlow;
    flo = corp + h4;
    hid = flo + h4;
    z = hid + h4;
    rn = z + h4;
    pq = rn + h4;
    stride = pq + h4;
  }
};

// acc[p] = sum_i x[p * xs + i] * w[i * ld + col], i = 0, 1, ..., for the
// kPoints rows of x; x, xs 4-float aligned.
__device__ __forceinline__ void dot(const float* x, int xs,
                                    const float* __restrict__ w, int len,
                                    int ld, int col, float (&acc)[kPoints]) {
#pragma unroll
  for (int p = 0; p < kPoints; ++p) acc[p] = 0.f;
  int i = 0;
  for (; i + 4 <= len; i += 4) {
    const float w0 = __ldg(w + (i + 0) * ld + col);
    const float w1 = __ldg(w + (i + 1) * ld + col);
    const float w2 = __ldg(w + (i + 2) * ld + col);
    const float w3 = __ldg(w + (i + 3) * ld + col);
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(x + p * xs + i);
      acc[p] = fmaf(v.x, w0, acc[p]);
      acc[p] = fmaf(v.y, w1, acc[p]);
      acc[p] = fmaf(v.z, w2, acc[p]);
      acc[p] = fmaf(v.w, w3, acc[p]);
    }
  }
  for (; i < len; ++i) {
    const float wi = __ldg(w + i * ld + col);
#pragma unroll
    for (int p = 0; p < kPoints; ++p) acc[p] = fmaf(x[p * xs + i], wi, acc[p]);
  }
}

// One thread per (group of kPoints points, output channel) of each stage,
// the group's inputs and intermediates in shared memory, a barrier between
// stages; every output one FMA chain over its inputs in a fixed order.
__device__ __forceinline__ void fma_body(const Args& a) {
  extern __shared__ __align__(16) float smem[];
  const int h = a.h, h3 = 3 * a.h;
  const Layout L(h, a.c, a.f);
  const int groups = a.block_rows / kPoints, points = a.block_rows;
  const long long first = (long long)blockIdx.x * points;
  const int np = static_cast<int>(min((long long)points, a.rows - first));

  // The inputs; rows past the last point are zeros (computed, not
  // written).
  const int in_len = L.corp;
  for (int t = threadIdx.x; t < points * in_len; t += blockDim.x) {
    const int p = t / in_len, i = t % in_len;
    const long long row = first + p;
    float v = 0.f;
    if (p < np) {
      if (i < h) {
        v = a.net[row * h + i];
      } else if (i >= L.inp && i < L.inp + a.c) {
        v = a.inp[row * a.c + (i - L.inp)];
      } else if (i >= L.cor && i < L.cor + a.f) {
        v = a.cor[row * a.f + (i - L.cor)];
      } else if (i >= L.flow) {
        v = a.flow[row * kFlow + (i - L.flow)];
      }
    }
    smem[p * L.stride + i] = v;
  }
  __syncthreads();

  const float* b0 = a.bias;       // MotionEncoder biases
  const float* b1 = a.bias + h3;  // gate biases
  const int work = groups * h;
  const int xs = L.stride;
  float d0[kPoints], d1[kPoints], d2[kPoints];
  // cor' = relu(cor . wc + b0), flo = relu(flow . wf + b0[h:]).
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    float* s = smem + (t / h) * kPoints * xs;
    const int o = t % h;
    dot(s + L.cor, xs, a.wc, a.f, h, o, d0);
    dot(s + L.flow, xs, a.wf, kFlow, h, o, d1);
    const float bc = __ldg(b0 + o), bf = __ldg(b0 + h + o);
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      s[p * xs + L.corp + o] = fmaxf(d0[p] + bc, 0.f);
      s[p * xs + L.flo + o] = fmaxf(d1[p] + bf, 0.f);
    }
  }
  __syncthreads();
  // hid = relu(cor' . wh[:h] + flo . wh[h:] + b0[2h:]).
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    float* s = smem + (t / h) * kPoints * xs;
    const int o = t % h;
    dot(s + L.corp, xs, a.wh, h, h, o, d0);
    dot(s + L.flo, xs, a.wh + h * h, h, h, o, d1);
    const float bh = __ldg(b0 + 2 * h + o);
#pragma unroll
    for (int p = 0; p < kPoints; ++p)
      s[p * xs + L.hid + o] = fmaxf(d0[p] + d1[p] + bh, 0.f);
  }
  __syncthreads();
  // z, r * net and px_q.
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    float* s = smem + (t / h) * kPoints * xs;
    const int o = t % h;
    float px[kPoints];
    for (int g = 0; g < 3; ++g) {
      const int col = g * h + o;
      dot(s + L.inp, xs, a.wi3, a.c, h3, col, d0);
      dot(s + L.hid, xs, a.wh3, h, h3, col, d1);
      dot(s + L.flow, xs, a.wf3, kFlow, h3, col, d2);
      const float bg = __ldg(b1 + col);
#pragma unroll
      for (int p = 0; p < kPoints; ++p) px[p] = d0[p] + d1[p] + d2[p] + bg;
      if (g == 2) break;
      dot(s + L.net, xs, a.wn3, h, h3, col, d0);
#pragma unroll
      for (int p = 0; p < kPoints; ++p) {
        const float gate = sigmoidf(px[p] + d0[p]);
        float* row = s + p * xs;
        if (g == 0) {
          row[L.z + o] = gate;
        } else {
          row[L.rn + o] = gate * row[L.net + o];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPoints; ++p) s[p * xs + L.pq + o] = px[p];
  }
  __syncthreads();
  // q and the float32 blend.
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    const int g = t / h, o = t % h;
    const float* s = smem + g * kPoints * xs;
    dot(s + L.rn, xs, a.wn3, h, h3, 2 * h + o, d0);
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      const int point = g * kPoints + p;
      if (point >= np) break;
      const float* row = s + p * xs;
      const float z = row[L.z + o];
      const float q = tanhf(row[L.pq + o] + d0[p]);
      a.out[(first + point) * h + o] = (1.f - z) * row[L.net + o] + z * q;
    }
  }
}

// FMA: mode "fma", else the tensor cores ("resident" or "ring", an
// argument). MAXT: the most threads a launch has (256 leaves ptxas 255
// registers a thread, 512 half as many).
template <bool FMA, int MAXT>
__global__ void __launch_bounds__(MAXT)
gru_general_kernel(Args a, int mode) {
  if constexpr (FMA) {
    fma_body(a);
  } else {
    tc_body(a, mode);
  }
}

}  // namespace

// rows = B * N points; hidden, context, corr_ch: the widths H, C, F; mode:
// 0 "fma", 1 "resident", 2 "ring"; block_rows: points per block; smem: the
// block's dynamic shared memory, at least what plan::need gives for that
// mode and block, at most 232,448 bytes (opted in above 48 KB). Returns
// cudaErrorInvalidValue for a launch shape the formulas refuse, else the
// opt-in's error, else cudaGetLastError() after the launch.
extern "C" int pvraft_gru_update_general(
    const float* net, const float* inp, const float* cor, const float* flow8,
    const float* wc, const float* wf, const float* wh, const float* wn3,
    const float* wi3, const float* wh3, const float* wf3, const float* bias,
    float* out, int rows, int hidden, int context, int corr_ch, int mode,
    int block_rows, int smem, void* stream) {
  int threads = 0, chunk = 0;
  const long long need = plan::need(mode, block_rows, hidden, context,
                                    corr_ch, &threads, &chunk);
  if (need < 0 || smem < need || smem > plan::kSmemMax || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(Args, int) = &gru_general_kernel<true, 256>;
  if (mode != plan::kFma) {
    kernel = threads <= 256 ? &gru_general_kernel<false, 256>
                            : &gru_general_kernel<false, 512>;
  }
  const Args a{net, inp, cor, flow8, wc, wf, wh, wn3, wi3, wh3, wf3, bias,
               out, rows, hidden, context, corr_ch, block_rows, chunk};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (rows > 0) {
    const int grid = (rows + block_rows - 1) / block_rows;
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a,
                                                                       mode);
  }
  return static_cast<int>(cudaGetLastError());
}
