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
// The kernel is gru_general.cuh's plan at float32 (every rounding there the
// identity), which gru_iter_bf16.cu instantiates at bfloat16; the result
// meets gru_math at 1e-5.

#include <cuda_runtime.h>

#include "gru_general.cuh"

namespace {

__global__ void gru_general_kernel(pvraft::gru::Gru<false> a) {
  pvraft::gru::update(a);
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
  const pvraft::gru::Gru<false> a{net, inp, cor, flow8, wc, wf,
                                  wh, wn3, wi3, wh3, wf3, bias,
                                  out, rows, hidden, context, corr_ch,
                                  groups};
  return static_cast<int>(
      pvraft::gru::launch(gru_general_kernel, a, threads, smem, stream));
}
