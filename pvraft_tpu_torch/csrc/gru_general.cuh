// The general-width fused MotionEncoder + ConvGRU update, shared by
// gru_iter_general.cu (float32) and gru_iter_bf16.cu (bfloat16): one kernel
// plan, templated on kBf16, the dtype the JAX kernel computes in
// (pvraft_tpu/ops/pallas/gru_iter.py, _gru_math's dtype_name, :78-118).
// Operands on the layout of pack_gru_weights (ops/cuda/gru_iter.py): wc
// (F, H), wf (8, H), wh (2H, H), wn3 (H, 3H), wi3 (C, 3H), wh3 (H, 3H), wf3
// (8, 3H), bias (8, 3H) with row 0 the MotionEncoder's biases and row 1 the
// gates'; net, inp, flow8 and the weights float32, cor float32 or (kBf16)
// bfloat16. With rnd(x) the identity at float32 and the round-to-nearest-
// even bfloat16 of x at kBf16, every dot product accumulated in float32:
//   cor' = relu(rnd(rnd(cor . wc) + b0[0:H]))
//   flo  = relu(rnd(rnd(flow8 . wf) + b0[H:2H]))
//   hid  = relu(rnd(rnd(rnd(cor' . wh[:H]) + rnd(flo . wh[H:])) + b0[2H:]))
//   px   = rnd(rnd(rnd(rnd(inp . wi3) + rnd(hid . wh3)) + rnd(flow8 . wf3))
//              + b1)
//   z = rnd(sigmoid(rnd(px_z + rnd(netd . wn3_z))))   (r likewise)
//   q = rnd(tanh(rnd(px_q + rnd(rnd(r * netd) . wn3_q))))
//   out = (1 - z) * net + z * q                        (float32)
// where netd, inp, flow8 and the weights and biases are rnd() of the
// float32 operands. At kBf16 that is jnp's order of operations and dtype
// promotions in _gru_math, token for token: the blend is rnd(1 - z) * net +
// rnd(z * q) in float32, its product and sum kept apart with __fmul_rn and
// __fadd_rn so that no FMA contracts them. At float32 every rnd() is the
// identity and the kernel is _gru_math's float32 math.
//
// Design, simple and right first: one block holds `groups` groups of
// kPoints query points and their inputs in shared memory (netd, inp, cor,
// flow8 and every intermediate: cor', flo, hid, z, r * netd, px_q; each
// segment padded to 4 floats so that rows load as float4), each input
// rounded as it is staged and each intermediate rounded before it is
// stored. Each stage is one thread per (group, output channel): the thread
// reads each weight of its column once through __ldg (consecutive threads,
// consecutive channels: coalesced), rounds it, and applies it to the
// group's kPoints points, kPoints fp32 FMA chains side by side, the
// points' inputs read as float4 broadcasts from shared memory; a block
// barrier separates the stages. Every output is one FMA chain over its
// input width in a fixed order, so two launches are bitwise equal. expf
// and tanhf are the accurate library functions (no fast math). The
// products run on the fp32 CUDA cores, not the tensor cores (mma.sync or
// wgmma tiles are later work; the tuned float32 kernel gru_iter.cu shows
// the layout). The host (ops/cuda/gru_iter.py::general_gru_plan) picks
// `groups` (about 256 threads' work within 48 KB of shared memory), and
// refuses widths where one group does not fit in the most a block can
// have.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace pvraft {
namespace gru {

constexpr int kPoints = 8;  // points per thread, one FMA chain each
constexpr int kFlow = 8;    // FLOW_PAD

template <bool kBf16>
using Cor = std::conditional_t<kBf16, __nv_bfloat16, float>;

template <bool kBf16>
struct Gru {
  const float *net, *inp;
  const Cor<kBf16>* cor;
  const float* flow;
  const float *wc, *wf, *wh, *wn3, *wi3, *wh3, *wf3, *bias;
  float* out;
  int rows, h, c, f, groups;
};

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// x rounded where the kernel's dtype rounds: to the nearest bfloat16 (ties
// to even) at kBf16, else x itself.
template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A point's row in shared memory: offsets of its segments, in floats.
struct Layout {
  int net, inp, cor, flow, corp, flo, hid, z, rn, pq, stride;
  __device__ Layout(int h, int c, int f) {
    const int h4 = pad4(h);
    net = 0;
    inp = net + h4;
    cor = inp + pad4(c);
    flow = cor + pad4(f);
    corp = flow + kFlow;
    flo = corp + h4;
    hid = flo + h4;
    z = hid + h4;
    rn = z + h4;
    pq = rn + h4;
    stride = pq + h4;
  }
};

// acc[p] = rnd(sum_i x[p * xs + i] * rnd(w[i * ld + col])), i = 0, 1, ...,
// for the kPoints rows of x; x, xs 4-float aligned.
template <bool kBf16>
__device__ __forceinline__ void dot(const float* x, int xs,
                                    const float* __restrict__ w, int len,
                                    int ld, int col, float (&acc)[kPoints]) {
#pragma unroll
  for (int p = 0; p < kPoints; ++p) acc[p] = 0.f;
  int i = 0;
  for (; i + 4 <= len; i += 4) {
    const float w0 = rnd<kBf16>(__ldg(w + (i + 0) * ld + col));
    const float w1 = rnd<kBf16>(__ldg(w + (i + 1) * ld + col));
    const float w2 = rnd<kBf16>(__ldg(w + (i + 2) * ld + col));
    const float w3 = rnd<kBf16>(__ldg(w + (i + 3) * ld + col));
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
    const float wi = rnd<kBf16>(__ldg(w + i * ld + col));
#pragma unroll
    for (int p = 0; p < kPoints; ++p) acc[p] = fmaf(x[p * xs + i], wi, acc[p]);
  }
#pragma unroll
  for (int p = 0; p < kPoints; ++p) acc[p] = rnd<kBf16>(acc[p]);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The kernel's body. Each source wraps it in a __global__ of its own name
// (gru_general_kernel, gru_bf16_kernel), the names the launch counts read
// in a profile (ops/cuda/__init__.py::KERNEL_SYMBOLS).
template <bool kBf16>
__device__ __forceinline__ void update(const Gru<kBf16>& a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = a.h, h3 = 3 * a.h;
  const Layout L(h, a.c, a.f);
  const int points = a.groups * kPoints;
  const long long first = (long long)blockIdx.x * points;
  const int np = static_cast<int>(min((long long)points, a.rows - first));
  const auto r = [](float x) { return rnd<kBf16>(x); };

  // The inputs, rounded; rows past the last point are zeros (computed, not
  // written).
  const int in_len = L.corp;
  for (int t = threadIdx.x; t < points * in_len; t += blockDim.x) {
    const int p = t / in_len, i = t % in_len;
    const long long row = first + p;
    float v = 0.f;
    if (p < np) {
      if (i < h) {
        v = r(a.net[row * h + i]);
      } else if (i >= L.inp && i < L.inp + a.c) {
        v = r(a.inp[row * a.c + (i - L.inp)]);
      } else if (i >= L.cor && i < L.cor + a.f) {
        v = to_float(a.cor[row * a.f + (i - L.cor)]);
      } else if (i >= L.flow) {
        v = r(a.flow[row * kFlow + (i - L.flow)]);
      }
    }
    smem[p * L.stride + i] = v;
  }
  __syncthreads();

  const float* b0 = a.bias;       // MotionEncoder biases
  const float* b1 = a.bias + h3;  // gate biases
  const int work = a.groups * h;
  const int xs = L.stride;
  float d0[kPoints], d1[kPoints], d2[kPoints];
  // cor' = relu(rnd(cor . wc + b0)), flo = relu(rnd(flow . wf + b0[h:])).
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    float* s = smem + (t / h) * kPoints * xs;
    const int o = t % h;
    dot<kBf16>(s + L.cor, xs, a.wc, a.f, h, o, d0);
    dot<kBf16>(s + L.flow, xs, a.wf, kFlow, h, o, d1);
    const float bc = r(__ldg(b0 + o)), bf = r(__ldg(b0 + h + o));
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      s[p * xs + L.corp + o] = fmaxf(r(d0[p] + bc), 0.f);
      s[p * xs + L.flo + o] = fmaxf(r(d1[p] + bf), 0.f);
    }
  }
  __syncthreads();
  // hid = relu(rnd(rnd(cor' . wh[:h] + flo . wh[h:]) + b0[2h:])).
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    float* s = smem + (t / h) * kPoints * xs;
    const int o = t % h;
    dot<kBf16>(s + L.corp, xs, a.wh, h, h, o, d0);
    dot<kBf16>(s + L.flo, xs, a.wh + h * h, h, h, o, d1);
    const float bh = r(__ldg(b0 + 2 * h + o));
#pragma unroll
    for (int p = 0; p < kPoints; ++p)
      s[p * xs + L.hid + o] = fmaxf(r(r(d0[p] + d1[p]) + bh), 0.f);
  }
  __syncthreads();
  // z, rnd(r * netd) and px_q.
  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    float* s = smem + (t / h) * kPoints * xs;
    const int o = t % h;
    float px[kPoints];
    for (int g = 0; g < 3; ++g) {
      const int col = g * h + o;
      dot<kBf16>(s + L.inp, xs, a.wi3, a.c, h3, col, d0);
      dot<kBf16>(s + L.hid, xs, a.wh3, h, h3, col, d1);
      dot<kBf16>(s + L.flow, xs, a.wf3, kFlow, h3, col, d2);
      const float bg = r(__ldg(b1 + col));
#pragma unroll
      for (int p = 0; p < kPoints; ++p)
        px[p] = r(r(r(d0[p] + d1[p]) + d2[p]) + bg);
      if (g == 2) break;
      dot<kBf16>(s + L.net, xs, a.wn3, h, h3, col, d0);
#pragma unroll
      for (int p = 0; p < kPoints; ++p) {
        const float gate = r(sigmoid(r(px[p] + d0[p])));
        float* row = s + p * xs;
        if (g == 0) {
          row[L.z + o] = gate;
        } else {
          row[L.rn + o] = r(gate * row[L.net + o]);
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
    dot<kBf16>(s + L.rn, xs, a.wn3, h, h3, 2 * h + o, d0);
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      const int point = g * kPoints + p;
      if (point >= np) break;
      const float* row = s + p * xs;
      const float z = row[L.z + o];
      const float q = r(tanhf(r(row[L.pq + o] + d0[p])));
      const long long at = (first + point) * h + o;
      if constexpr (kBf16) {
        // Shared memory holds the rounded carry: read the float32 one.
        a.out[at] = __fadd_rn(__fmul_rn(r(1.f - z), a.net[at]), r(z * q));
      } else {
        a.out[at] = (1.f - z) * row[L.net + o] + z * q;
      }
    }
  }
}

// Launches `kernel` (a __global__ that runs update()) on `stream`:
// a.groups groups of kPoints points per block of `threads` threads with
// `smem` bytes of dynamic shared memory, opted in above 48 KB. Returns the
// opt-in's error, else cudaGetLastError().
template <bool kBf16>
cudaError_t launch(void (*kernel)(Gru<kBf16>), const Gru<kBf16>& a,
                   int threads, int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  if (a.rows > 0) {
    const int points = a.groups * kPoints;
    const int grid = (a.rows + points - 1) / points;
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace gru
}  // namespace pvraft
