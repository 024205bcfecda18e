// Fused MotionEncoder + ConvGRU update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pvraft_tpu/ops/pallas/gru_iter.py
// (_gru_forward / _gru_kernel, public fused_gru_update; the math is
// _gru_math). Per point, with the weights packed by pack_gru_weights:
//   cor = relu(cor_in @ wc + b0[0:H])         flo = relu(flow8 @ wf + b0[H:2H])
//   hid = relu(cor @ wh[:H] + flo @ wh[H:] + b0[2H:3H])
//   px  = inp @ wi3 + hid @ wh3 + flow8 @ wf3 + b1          (3H: z | r | q)
//   z = sigmoid(px_z + net @ wn3_z)   r = sigmoid(px_r + net @ wn3_r)
//   q = tanh(px_q + (r * net) @ wn3_q)
//   out = (1 - z) * net + z * q        (fp32 throughout)
// H = 64 hidden, context and correlation-feature channels; 8 padded flow
// channels.
//
// Bound on the H100: operations. 51,200 multiply-adds per point against
// 264 floats of per-point input and output, ~190 flops per byte, above the
// fp32 CUDA-core ridge (67 TFLOP/s / 3.35 TB/s = 20 flops per byte).
//
// Design: one block per tile of 32 points, 256 threads; thread (o, g)
// computes output channel o (and o + H, o + 2H for the three gates) for
// the 8 points of group g. Every intermediate (cor, flo, hid, z, r, q,
// r * net) lives in registers or in 41 KB of shared memory; only the new
// state is written. The packed weights are 211 KB in fp32, too large to
// sit in one block's shared memory beside the activations, so they are
// read through the read-only L1/L2 path: a warp reads one 128-byte row
// segment per input channel, and each weight read feeds 8 points. The
// point activations are read from shared memory as float4 broadcasts.
// fp32 FMAs on the CUDA cores; tensor cores are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kH = 64;             // hidden = context = cor feature width
constexpr int kF = 8;              // padded flow channels (FLOW_PAD)
constexpr int kG = 3 * kH;         // packed gate width
constexpr int kTile = 32;          // points per block
constexpr int kPpt = 8;            // points per thread
constexpr int kThreads = kH * (kTile / kPpt);

// acc[c][j] += sum_i x[p0 + j][i] * W[i][col + c * kH], i in [0, IN).
// x is a (kTile, LD) row-major shared-memory tile, W a (IN, ldw) row-major
// global matrix. Sums run in input-channel order.
template <int IN, int LD, int NC>
__device__ __forceinline__ void dense_acc(float (&acc)[NC][kPpt],
                                          const float* x, int p0,
                                          const float* __restrict__ W,
                                          int ldw, int col) {
#pragma unroll 2
  for (int i = 0; i < IN; i += 4) {
    float w[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        w[c][u] = __ldg(W + (i + u) * ldw + col + c * kH);
      }
    }
#pragma unroll
    for (int j = 0; j < kPpt; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(x + (p0 + j) * LD + i);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c][j] = fmaf(v.x, w[c][0], acc[c][j]);
        acc[c][j] = fmaf(v.y, w[c][1], acc[c][j]);
        acc[c][j] = fmaf(v.z, w[c][2], acc[c][j]);
        acc[c][j] = fmaf(v.w, w[c][3], acc[c][j]);
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void init_acc(float (&acc)[NC][kPpt],
                                         const float* __restrict__ b,
                                         int col) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float v = __ldg(b + col + c * kH);
#pragma unroll
    for (int j = 0; j < kPpt; ++j) acc[c][j] = v;
  }
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
gru_kernel(const float* __restrict__ net, const float* __restrict__ inp,
           const float* __restrict__ cor, const float* __restrict__ flow8,
           const float* __restrict__ wc, const float* __restrict__ wf,
           const float* __restrict__ wh, const float* __restrict__ wn3,
           const float* __restrict__ wi3, const float* __restrict__ wh3,
           const float* __restrict__ wf3, const float* __restrict__ bias,
           float* __restrict__ out, int rows) {
  __shared__ __align__(16) float s_net[kTile * kH];
  __shared__ __align__(16) float s_inp[kTile * kH];
  __shared__ __align__(16) float s_a[kTile * kH];   // cor_in, then hid
  __shared__ __align__(16) float s_b[kTile * kH];   // cor, then r * net
  __shared__ __align__(16) float s_c[kTile * kH];   // flo
  __shared__ __align__(16) float s_flow[kTile * kF];

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kTile;
  const int valid = (int)min((long long)kTile, rows - row0);

  // Stage the tile's inputs; rows past the end are zeros and never stored.
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < kTile * kH / 4; e += kThreads) {
    const int p = e / (kH / 4);
    const long long g = (row0 + p) * (kH / 4) + e % (kH / 4);
    const bool ok = p < valid;
    reinterpret_cast<float4*>(s_net)[e] =
        ok ? reinterpret_cast<const float4*>(net)[g] : zero;
    reinterpret_cast<float4*>(s_inp)[e] =
        ok ? reinterpret_cast<const float4*>(inp)[g] : zero;
    reinterpret_cast<float4*>(s_a)[e] =
        ok ? reinterpret_cast<const float4*>(cor)[g] : zero;
  }
  for (int e = tid; e < kTile * kF; e += kThreads) {
    const int p = e / kF;
    s_flow[e] = p < valid ? flow8[(row0 + p) * kF + e % kF] : 0.f;
  }
  __syncthreads();

  const int o = tid % kH;
  const int p0 = (tid / kH) * kPpt;

  // MotionEncoder: cor and flo projections.
  {
    float a[1][kPpt], b[1][kPpt];
    init_acc<1>(a, bias, o);
    dense_acc<kH, kH, 1>(a, s_a, p0, wc, kH, o);
    init_acc<1>(b, bias, kH + o);
    dense_acc<kF, kF, 1>(b, s_flow, p0, wf, kH, o);
#pragma unroll
    for (int j = 0; j < kPpt; ++j) {
      s_b[(p0 + j) * kH + o] = fmaxf(a[0][j], 0.f);
      s_c[(p0 + j) * kH + o] = fmaxf(b[0][j], 0.f);
    }
  }
  __syncthreads();

  // MotionEncoder: hid over concat(cor, flo); cor_in is dead, hid takes s_a.
  {
    float a[1][kPpt];
    init_acc<1>(a, bias, 2 * kH + o);
    dense_acc<kH, kH, 1>(a, s_b, p0, wh, kH, o);
    dense_acc<kH, kH, 1>(a, s_c, p0, wh + kH * kH, kH, o);
#pragma unroll
    for (int j = 0; j < kPpt; ++j) s_a[(p0 + j) * kH + o] = fmaxf(a[0][j], 0.f);
  }
  __syncthreads();

  // ConvGRU gates: z, r and the net-independent part of q.
  float g[3][kPpt];
  init_acc<3>(g, bias + kG, o);
  dense_acc<kH, kH, 3>(g, s_inp, p0, wi3, kG, o);
  dense_acc<kH, kH, 3>(g, s_a, p0, wh3, kG, o);
  dense_acc<kF, kF, 3>(g, s_flow, p0, wf3, kG, o);
  {
    float zr[2][kPpt];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int j = 0; j < kPpt; ++j) zr[c][j] = 0.f;
    }
    dense_acc<kH, kH, 2>(zr, s_net, p0, wn3, kG, o);
#pragma unroll
    for (int j = 0; j < kPpt; ++j) {
      g[0][j] = sigmoidf(g[0][j] + zr[0][j]);                  // z
      const float r = sigmoidf(g[1][j] + zr[1][j]);
      s_b[(p0 + j) * kH + o] = r * s_net[(p0 + j) * kH + o];   // r * net
    }
  }
  __syncthreads();

  // q and the blend.
  {
    float qa[1][kPpt];
#pragma unroll
    for (int j = 0; j < kPpt; ++j) qa[0][j] = 0.f;
    dense_acc<kH, kH, 1>(qa, s_b, p0, wn3 + 2 * kH, kG, o);
#pragma unroll
    for (int j = 0; j < kPpt; ++j) {
      const int p = p0 + j;
      if (p < valid) {
        const float z = g[0][j];
        const float q = tanhf(g[2][j] + qa[0][j]);
        const float h = s_net[p * kH + o];
        out[(row0 + p) * kH + o] = (1.f - z) * h + z * q;
      }
    }
  }
}

}  // namespace

// rows = B * N points. Every operand is contiguous fp32: net, inp, cor
// (rows, 64), flow8 (rows, 8), wc (64, 64), wf (8, 64), wh (128, 64),
// wn3/wi3/wh3 (64, 192), wf3 (8, 192), bias (8, 192); out (rows, 64).
// Returns cudaGetLastError() after the launch.
extern "C" int pvraft_gru_update(const float* net, const float* inp,
                                 const float* cor, const float* flow8,
                                 const float* wc, const float* wf,
                                 const float* wh, const float* wn3,
                                 const float* wi3, const float* wh3,
                                 const float* wf3, const float* bias,
                                 float* out, int rows, void* stream) {
  if (rows > 0) {
    const int grid = (rows + kTile - 1) / kTile;
    gru_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        net, inp, cor, flow8, wc, wf, wh, wn3, wi3, wh3, wf3, bias, out,
        rows);
  }
  return static_cast<int>(cudaGetLastError());
}
