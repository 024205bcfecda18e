// General-width fused MotionEncoder + ConvGRU update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pvraft_tpu/ops/pallas/gru_iter.py
// (_gru_forward / _gru_kernel; the math is _gru_math, :78-119) at the widths
// the tuned kernel (gru_iter.cu: hidden = context = correlation width 64,
// 222 KB of shared memory built on that width) does not take: any hidden
// width H, context width C and correlation-feature width F, every operand
// float32:
//   cor = relu(cor_in . wc + b0[0:H]);  flo = relu(flow8 . wf + b0[H:2H])
//   hid = relu(cor . wh[:H] + flo . wh[H:] + b0[2H:3H])
//   px  = inp . wi3 + hid . wh3 + flow8 . wf3 + b1
//   z = sigmoid(px_z + net . wn3_z);  r = sigmoid(px_r + net . wn3_r)
//   q = tanh(px_q + (r * net) . wn3_q);  out = (1 - z) * net + z * q
//
// Bound on the H100: operations, 2 * (F*H + 8*H + 2H*H + (C + H + 8 + H) *
// 3H) FLOP per point on the fp32 CUDA cores (the tuned kernel's tensor-core
// products are what this kernel gives up for generality), against bytes of
// 4 * (2H + C + F + 8) per point.
//
// Design, simple and right first: one block holds `groups` groups of
// kPoints query points and their inputs in shared memory (net, inp, cor,
// flow8 and every intermediate: cor', flo, hid, z, r * net, px_q; each
// segment padded to 4 floats so that rows load as float4). Each stage is
// one thread per (group, output channel): the thread reads each weight of
// its column once through __ldg (consecutive threads, consecutive
// channels: coalesced) and applies it to the group's kPoints points,
// kPoints fp32 FMA chains side by side, the points' inputs read as float4
// broadcasts from shared memory; a block barrier separates the stages.
// Every output is one FMA chain over its input width in a fixed order, so
// two launches are bitwise equal. expf and tanhf are the accurate library
// functions (no fast math). The host (ops/cuda/gru_iter.py::
// general_gru_plan) picks `groups` (about 256 threads' work within 48 KB of
// shared memory), and refuses widths where one group does not fit in the
// most a block can have. The result meets gru_math at 1e-5.

#include <cuda_runtime.h>

namespace {

constexpr int kPoints = 8;  // points per thread, one FMA chain each
constexpr int kFlow = 8;    // FLOW_PAD

struct Gru {
  const float *net, *inp, *cor;
  const float* flow;
  const float *wc, *wf, *wh, *wn3, *wi3, *wh3, *wf3, *bias;
  float* out;
  int rows, h, c, f, groups;
};

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void gru_general_kernel(Gru a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = a.h, h3 = 3 * a.h;
  const Layout L(h, a.c, a.f);
  const int points = a.groups * kPoints;
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
  const int work = a.groups * h;
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
        const float gate = sigmoid(px[p] + d0[p]);
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

}  // namespace

// rows = B * N points; hidden, context, corr_ch: the widths H, C, F;
// groups: groups of 8 query points per block; threads: the block's
// threads; smem: its dynamic shared memory, groups * 8 * 4 * (7 * pad4(H)
// + pad4(C) + pad4(F) + 8) bytes, opted in above 48 KB. Returns the
// opt-in's error, else cudaGetLastError() after the launch.
extern "C" int pvraft_gru_update_general(
    const float* net, const float* inp, const float* cor, const float* flow8,
    const float* wc, const float* wf, const float* wh, const float* wn3,
    const float* wi3, const float* wh3, const float* wf3, const float* bias,
    float* out, int rows, int hidden, int context, int corr_ch, int groups,
    int threads, int smem, void* stream) {
  const Gru a{net, inp, cor, flow8, wc, wf, wh, wn3, wi3, wh3, wf3, bias,
              out, rows, hidden, context, corr_ch, groups};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gru_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (rows > 0) {
    const int points = groups * kPoints;
    const int grid = (rows + points - 1) / points;
    gru_general_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
