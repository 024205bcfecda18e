// Fused MotionEncoder + ConvGRU update for Hopper (sm_90a), on the tensor
// cores at fp32 accuracy (3xTF32).
//
// Replaces the Pallas TPU kernel pvraft_tpu/ops/pallas/gru_iter.py
// (_gru_forward / _gru_kernel, public fused_gru_update; the math is
// _gru_math, :78). Per point, with the weights packed by pack_gru_weights:
//   cor = relu(cor_in @ wc + b0[0:H])         flo = relu(flow8 @ wf + b0[H:2H])
//   hid = relu(cor @ wh[:H] + flo @ wh[H:] + b0[2H:3H])
//   px  = inp @ wi3 + hid @ wh3 + flow8 @ wf3 + b1          (3H: z | r | q)
//   z = sigmoid(px_z + net @ wn3_z)   r = sigmoid(px_r + net @ wn3_r)
//   q = tanh(px_q + (r * net) @ wn3_q)
//   out = (1 - z) * net + z * q
// H = 64 hidden, context and correlation-feature channels; 8 padded flow
// channels.
//
// Bound on the H100 at 1 x 8192 points: 51,200 multiply-adds per point,
// 0.839 GFLOP; 264 floats of per-point input and output plus 211 KB of
// weights, 8.86 MB. Bytes: 2.6 us at 3.35 TB/s. Operations: 12.5 us on the
// fp32 CUDA cores (67 TFLOP/s); 3 x 0.839 GFLOP = 5.1 us on the TF32
// tensor cores (495 TFLOP/s), the bound of this kernel.
//
// Design, and what each part addresses (times: device time at 1 x 8192 on
// an H100 80GB HBM3 at 700 W, python -m pvraft_tpu_torch.gru_ab):
//  * Tensor cores at fp32 accuracy. Every stage is a (points x IN) .
//    (IN x OUT) product on mma.sync m16n8k8 TF32. Each fp32 operand is
//    split as hi = x rounded to TF32 (to nearest, ties away: two integer
//    instructions; cvt.rna.tf32.f32 compiles to about five) and lo = x - hi,
//    exact; the tensor core reads lo's top 11 bits. Per 8-deep step the
//    products a_lo.b_hi, a_hi.b_lo, a_hi.b_hi (small terms first) go into
//    a zeroed partial sum that a rounded fp32 add takes onto the
//    accumulator once per weight chunk: accumulating a whole stage on the
//    tensor core read 4.2e-6 from fp64 against fp32's own 8.2e-7, the
//    partial sums read 1.1e-6 to 1.5e-6. One TF32 pass would be ~2e-3 off.
//  * 64 points per block, 8 warps. Warp (mh, cg) owns rows 32 mh .. +32
//    (two m16 tiles) and output channels 16 cg .. +16 of every stage: two
//    n8 tiles of cor, flo and hid, and of each gate z, r, q, so that z, r,
//    q and net of one (point, channel) meet in one thread's accumulator
//    fragments. 128 blocks at 1 x 8192 on 132 SMs, one block per SM.
//  * Activations are split once, when they are stored: shared tiles of
//    (hi, lo) pairs (64 points x 64 channels, rows padded to 136 floats,
//    fragment reads are 8-byte loads free of bank conflicts). cor_in and
//    flow8 are read first; inp and net wait in registers while the
//    MotionEncoder runs. net is recovered exactly as hi + lo. Four such
//    tiles (cor_in -> hid, cor -> inp -> r * net, flo -> the new state,
//    net) and the flow tile take 145 KB.
//  * Weights stream from L2 through a three-slot ring of 25.6 KB slots in
//    shared memory by cp.async, two chunks ahead of the chunk in use: 12
//    chunks per block (64 rows of a 64-column matrix, 32 of a wider one,
//    8 of a flow matrix), one barrier each. 222 KB of shared memory.
//  * Epilogues on the accumulator fragments: bias, ReLU, sigmoid, tanh,
//    r * net and the blend in registers. Results go back to shared memory
//    only as the next stage's (split) operand, and the new state leaves
//    through shared memory by 16-byte stores. No atomics: bitwise
//    repeatable.
// What holds it above the 5.1 us bound, measured by variants of this
// source: the three TF32 passes cost ~8.8 clocks per mma.sync per SM
// sub-partition (one pass instead of three: 0.0175 ms against 0.0250),
// and loads, splits and barriers do not hide under them (no products at
// all: 0.0204 ms); of the one-pass time the activation fragment loads
// take ~3.3 us, the ring's barriers ~2.4 us, the HBM reads and writes
// ~1.4 us.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kH = 64;             // hidden = context = cor feature width
constexpr int kF = 8;              // padded flow channels (FLOW_PAD)
constexpr int kG = 3 * kH;         // packed gate width
constexpr int kTile = 64;          // points per block
constexpr int kWarps = 8;          // 2 row halves x 4 channel groups
constexpr int kThreads = 32 * kWarps;
constexpr int kNt = kH / 8 / (kWarps / 2);   // n8 tiles of a warp's channels
// Activations are kept split: element (p, c) of a tile is the pair
// (hi, lo) at floats 2c, 2c + 1 of row p; rows padded by 8 floats.
constexpr int kLd2 = 2 * kH + 8;
constexpr int kLdF2 = 2 * kF + 8;
constexpr int kPairTile = kTile * kLd2;
constexpr int kLdOut = kH + 4;     // the new state, staged unsplit
constexpr int kActFloats = 4 * kPairTile + kTile * kLdF2;
// Weights stream through a ring of kStages slots, one chunk of input rows
// each: 64 rows of a 64-column matrix, 32 of a wider one, 8 of a flow
// matrix; rows padded by 8 floats.
constexpr int kStages = 3;
constexpr int kSlotFloats = 32 * (kG + 8);
constexpr int kChunks = 12;
constexpr int kSmemBytes = (kActFloats + kStages * kSlotFloats) * 4;

// x = hi + lo exactly: hi is x rounded to TF32 (10 mantissa bits, to
// nearest, ties away from zero: cvt.rna.tf32.f32 for finite x, in two
// integer instructions), lo = x - hi is exact in fp32. The tensor core
// reads the top 11 significant bits of lo.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float2 split2(float x) {
  uint32_t hi, lo;
  split(x, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// d += a . b on the tensor cores (m16n8k8, TF32 inputs, fp32 sums).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b.
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// acc[i][J0 + j] += A[r0 + 16 i .. + 16][0 : 8 KS] . W[0 : 8 KS][col[J0 + j]
// .. + 8] for i < 2, j < NT, in 3xTF32: per 8-deep step a_lo.b_hi, then
// a_hi.b_lo, then a_hi.b_hi. A points at the first input column of a split
// shared tile with rows of LDA2 floats; W is one ring slot, (8 KS, ldw),
// split here. Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = W[t][g], W[t+4][g];
// acc = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]. The chunk's
// products go into zeroed partial sums (two, alternating by step, where
// NT <= 2, so that more products are independent) that rounded fp32 adds
// take onto the accumulator: the tensor core's own sums are less exact.
template <int NTT, int J0, int NT, int KS, int LDA2>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][NTT][4],
                                          const float* a_tile, int r0,
                                          const float* w, int ldw,
                                          const int (&col)[NTT], int lane) {
  constexpr int P = NT > 2 ? 1 : (KS < 2 ? KS : 2);
  const int g = lane >> 2, t = lane & 3;
  float part[P][2][NT][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* q = w + (8 * s + t) * ldw + col[J0 + j] + g;
      split(q[0], bh[j][0], bl[j][0]);
      split(q[4 * ldw], bh[j][1], bl[j][1]);
    }
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = a_tile + (r0 + 16 * i + g) * LDA2 + 2 * (8 * s + t);
      const float2 v[4] = {*reinterpret_cast<const float2*>(p),
                           *reinterpret_cast<const float2*>(p + 8 * LDA2),
                           *reinterpret_cast<const float2*>(p + 8),
                           *reinterpret_cast<const float2*>(p + 8 * LDA2 + 8)};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ah[i][u] = __float_as_uint(v[u].x);
        al[i][u] = __float_as_uint(v[u].y);
      }
    }
    float (&ps)[2][NT][4] = part[s % P];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (s < P) {
          mma0(ps[i][j], al[i], bh[j][0], bh[j][1]);
        } else {
          mma(ps[i][j], al[i], bh[j][0], bh[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(ps[i][j], ah[i], bl[j][0], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(ps[i][j], ah[i], bh[j][0], bh[j][1]);
    }
  }
#pragma unroll
  for (int s = 0; s < P; ++s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][J0 + j][e] += part[s][i][j][e];
      }
    }
  }
}

// Every accumulator of column tile j starts at bias[col[j] + its column].
template <int NT>
__device__ __forceinline__ void init_bias(float (&acc)[2][NT][4],
                                          const float* __restrict__ bias,
                                          const int (&col)[NT], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float b0 = __ldg(bias + col[j] + 2 * t);
    const float b1 = __ldg(bias + col[j] + 2 * t + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[i][j][0] = b0;
      acc[i][j][1] = b1;
      acc[i][j][2] = b0;
      acc[i][j][3] = b1;
    }
  }
}

// Two adjacent elements, split, into a pair tile (16 bytes).
__device__ __forceinline__ void put2(float* dst, float x, float y) {
  const float2 a = split2(x), b = split2(y);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
}

// relu(acc) of the warp's column tiles (channels ch0 .. + 8 kNt) into a
// pair tile.
__device__ __forceinline__ void store_relu(const float (&acc)[2][kNt][4],
                                           float* tile, int r0, int ch0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        put2(tile + (r0 + 16 * i + g + 8 * h) * kLd2 + 2 * (ch0 + 8 * j + 2 * t),
             fmaxf(acc[i][j][2 * h], 0.f), fmaxf(acc[i][j][2 * h + 1], 0.f));
      }
    }
  }
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// 16 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ROWS x COLS floats of a row-major (., LD) matrix into a ring slot whose
// rows are padded to COLS + 8 (B fragment reads free of bank conflicts).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void copy_chunk(float* slot, const float* src,
                                           int tid) {
  constexpr int per_row = COLS / 4, n = ROWS * per_row;
#pragma unroll
  for (int u = 0; u < (n + kThreads - 1) / kThreads; ++u) {
    const int e = tid + u * kThreads;
    if (n % kThreads == 0 || e < n) {
      const int r = e / per_row, q = 4 * (e % per_row);
      cp_async16(slot + r * (COLS + 8) + q, src + r * LD + q);
    }
  }
}

// Rows of a (rows, W) global tile, four floats per item; zeros past the end.
template <int W>
__device__ __forceinline__ float4 load4(const float* __restrict__ src,
                                        long long row0, int valid, int e) {
  const int p = e / (W / 4), c = 4 * (e % (W / 4));
  return p < valid ? __ldg(reinterpret_cast<const float4*>(
                         src + (row0 + p) * W + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Four floats of a 64-wide tile (item e), split, into a pair tile.
__device__ __forceinline__ void put4(float* tile, int ld2, int w, int e,
                                     float4 v) {
  const int p = e / (w / 4), c = 4 * (e % (w / 4));
  put2(tile + p * ld2 + 2 * c, v.x, v.y);
  put2(tile + p * ld2 + 2 * c + 4, v.z, v.w);
}

constexpr int kItems = kTile * kH / 4 / kThreads;   // float4s per thread

__global__ void __launch_bounds__(kThreads)
gru_kernel(const float* __restrict__ net, const float* __restrict__ inp,
           const float* __restrict__ cor, const float* __restrict__ flow8,
           const float* __restrict__ wc, const float* __restrict__ wf,
           const float* __restrict__ wh, const float* __restrict__ wn3,
           const float* __restrict__ wi3, const float* __restrict__ wh3,
           const float* __restrict__ wf3, const float* __restrict__ bias,
           float* __restrict__ out, int rows) {
  extern __shared__ __align__(16) float smem[];
  float* s_net = smem;
  float* s_x = s_net + kPairTile;    // cor_in, then hid
  float* s_y = s_x + kPairTile;      // cor, then inp, then r * net
  float* s_z = s_y + kPairTile;      // flo, then the new state (unsplit)
  float* s_flow = s_z + kPairTile;
  float* ring = smem + kActFloats;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int valid = (int)min((long long)kTile, rows - row0);

  // The weight chunks in the order the stages read them: chunk c goes to
  // ring slot c % kStages.
  auto fetch = [&](int c) {
    float* slot = ring + (c % kStages) * kSlotFloats;
    switch (c) {
      case 0: copy_chunk<kH, kH, kH>(slot, wc, tid); break;
      case 1: copy_chunk<kF, kH, kH>(slot, wf, tid); break;
      case 2: case 3:
        copy_chunk<kH, kH, kH>(slot, wh + (c - 2) * kH * kH, tid); break;
      case 4: case 5:
        copy_chunk<32, kG, kG>(slot, wi3 + (c - 4) * 32 * kG, tid); break;
      case 6: case 7:
        copy_chunk<32, kG, kG>(slot, wh3 + (c - 6) * 32 * kG, tid); break;
      case 8: copy_chunk<kF, kG, kG>(slot, wf3, tid); break;
      case 9: case 10:     // wn3's z | r columns
        copy_chunk<32, 2 * kH, kG>(slot, wn3 + (c - 9) * 32 * kG, tid); break;
      default:             // wn3's q columns
        copy_chunk<kH, kH, kG>(slot, wn3 + 2 * kH, tid);
    }
  };
  // Wait for chunk c (and every copy before it), then refill the slot of
  // chunk c - 1, which every warp has left; returns chunk c's slot. The
  // barrier also publishes what the warps stored before it.
  int next = 0;
  auto acquire = [&]() -> const float* {
    const int c = next++;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < kChunks) fetch(c + kStages - 1);
    cp_async_commit();
    return ring + (c % kStages) * kSlotFloats;
  };

  for (int c = 0; c < kStages - 1; ++c) {
    fetch(c);
    cp_async_commit();
  }
  // cor_in and flow8 first; inp and net stay in registers until the
  // MotionEncoder is done.
  float4 v_cor[kItems], v_flow = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    v_cor[u] = load4<kH>(cor, row0, valid, tid + u * kThreads);
  }
  if (tid < kTile * kF / 4) v_flow = load4<kF>(flow8, row0, valid, tid);
  float4 v_inp[kItems], v_net[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    v_inp[u] = load4<kH>(inp, row0, valid, tid + u * kThreads);
    v_net[u] = load4<kH>(net, row0, valid, tid + u * kThreads);
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    put4(s_x, kLd2, kH, tid + u * kThreads, v_cor[u]);
  }
  if (tid < kTile * kF / 4) put4(s_flow, kLdF2, kF, tid, v_flow);

  const int r0 = 32 * (warp / (kWarps / 2));       // this warp's rows
  const int ch0 = 8 * kNt * (warp % (kWarps / 2));  // and output channels
  const int g = lane >> 2, t = lane & 3;
  int col[kNt], gcol[3 * kNt], zrcol[3 * kNt], qcol[3 * kNt];
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    col[j] = ch0 + 8 * j;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      gcol[gate * kNt + j] = gate * kH + ch0 + 8 * j;
      zrcol[gate * kNt + j] = gate < 2 ? gate * kH + ch0 + 8 * j : 0;
      qcol[gate * kNt + j] = gate == 2 ? ch0 + 8 * j : 0;
    }
  }

  // MotionEncoder: cor and flo, then hid over concat(cor, flo).
  {
    float a[2][kNt][4];
    init_bias<kNt>(a, bias, col, lane);
    mma_chunk<kNt, 0, kNt, kH / 8, kLd2>(a, s_x, r0, acquire(), kH + 8, col,
                                          lane);
    store_relu(a, s_y, r0, ch0, lane);
    init_bias<kNt>(a, bias + kH, col, lane);
    mma_chunk<kNt, 0, kNt, kF / 8, kLdF2>(a, s_flow, r0, acquire(), kH + 8, col,
                                       lane);
    store_relu(a, s_z, r0, ch0, lane);
  }
  {
    float a[2][kNt][4];
    init_bias<kNt>(a, bias + 2 * kH, col, lane);
#pragma unroll 1
    for (int k = 0; k < 2 * kH; k += kH) {
      const float* w = acquire();
      const float* x = k < kH ? s_y : s_z;
      mma_chunk<kNt, 0, kNt, kH / 8, kLd2>(a, x, r0, w, kH + 8, col, lane);
    }
    store_relu(a, s_x, r0, ch0, lane);   // cor_in is dead: s_x takes hid
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    put4(s_y, kLd2, kH, tid + u * kThreads, v_inp[u]);   // cor is dead
    put4(s_net, kLd2, kH, tid + u * kThreads, v_net[u]);
  }

  // ConvGRU. Column tiles j, kNt + j and 2 kNt + j are z, r and q of
  // channels ch0 + 8 j .. + 8.
  float acc[2][3 * kNt][4];
  init_bias<3 * kNt>(acc, bias + kG, gcol, lane);
#pragma unroll 1
  for (int k = 0; k < 2 * kH; k += 32) {
    const float* w = acquire();
    const float* x = k < kH ? s_y + 2 * k : s_x + 2 * (k - kH);
    mma_chunk<3 * kNt, 0, 3 * kNt, 4, kLd2>(acc, x, r0, w, kG + 8, gcol,
                                              lane);
  }
  mma_chunk<3 * kNt, 0, 3 * kNt, kF / 8, kLdF2>(acc, s_flow, r0, acquire(),
                                                 kG + 8, gcol, lane);
  // z and r over net: the chunk holds wn3's z | r columns only.
#pragma unroll 1
  for (int k = 0; k < kH; k += 32) {
    const float* w = acquire();
    mma_chunk<3 * kNt, 0, 2 * kNt, 4, kLd2>(acc, s_net + 2 * k, r0, w,
                                                 2 * kH + 8, zrcol, lane);
  }
  // z stays in its accumulators; r * net goes to s_y (inp is dead). net
  // is hi + lo of its pair, exactly.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = r0 + 16 * i + g + 8 * h;
        const int c = ch0 + 8 * j + 2 * t;
        const float4 n = *reinterpret_cast<const float4*>(s_net + p * kLd2 + 2 * c);
        acc[i][j][2 * h] = sigmoidf(acc[i][j][2 * h]);
        acc[i][j][2 * h + 1] = sigmoidf(acc[i][j][2 * h + 1]);
        put2(s_y + p * kLd2 + 2 * c,
             sigmoidf(acc[i][kNt + j][2 * h]) * (n.x + n.y),
             sigmoidf(acc[i][kNt + j][2 * h + 1]) * (n.z + n.w));
      }
    }
  }
  // q over r * net: the chunk holds wn3's q columns only.
  // (acquire's barrier also publishes r * net)
  mma_chunk<3 * kNt, 2 * kNt, kNt, kH / 8, kLd2>(acc, s_y, r0, acquire(),
                                                  kH + 8, qcol, lane);
  // q and the blend; the new state goes to s_z unsplit (flo is dead).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = r0 + 16 * i + g + 8 * h;
        const int c = ch0 + 8 * j + 2 * t;
        const float4 n = *reinterpret_cast<const float4*>(s_net + p * kLd2 + 2 * c);
        const float z0 = acc[i][j][2 * h], z1 = acc[i][j][2 * h + 1];
        const float h0 = n.x + n.y, h1 = n.z + n.w;
        *reinterpret_cast<float2*>(s_z + p * kLdOut + c) = make_float2(
            (1.f - z0) * h0 + z0 * tanhf(acc[i][2 * kNt + j][2 * h]),
            (1.f - z1) * h1 + z1 * tanhf(acc[i][2 * kNt + j][2 * h + 1]));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int e = tid + u * kThreads;
    const int p = e / (kH / 4), c = 4 * (e % (kH / 4));
    if (p < valid) {
      *reinterpret_cast<float4*>(out + (row0 + p) * kH + c) =
          *reinterpret_cast<const float4*>(s_z + p * kLdOut + c);
    }
  }
}

}  // namespace

// rows = B * N points. Every operand is contiguous fp32: net, inp, cor
// (rows, 64), flow8 (rows, 8), wc (64, 64), wf (8, 64), wh (128, 64),
// wn3/wi3/wh3 (64, 192), wf3 (8, 192), bias (8, 192); out (rows, 64).
// net, inp, cor, flow8 and out 16-byte aligned. Returns the first CUDA
// error of the set-up or cudaGetLastError() after the launch.
extern "C" int pvraft_gru_update(const float* net, const float* inp,
                                 const float* cor, const float* flow8,
                                 const float* wc, const float* wf,
                                 const float* wh, const float* wn3,
                                 const float* wi3, const float* wh3,
                                 const float* wf3, const float* bias,
                                 float* out, int rows, void* stream) {
  // Above 48 KB of shared memory a kernel must opt in, once per device.
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(gru_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  if (rows > 0) {
    const int grid = (rows + kTile - 1) / kTile;
    gru_kernel<<<grid, kThreads, kSmemBytes,
                 static_cast<cudaStream_t>(stream)>>>(
        net, inp, cor, flow8, wc, wf, wh, wn3, wi3, wh3, wf3, bias, out,
        rows);
  }
  return static_cast<int>(cudaGetLastError());
}
