// bfloat16 fused MotionEncoder + ConvGRU update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pvraft_tpu/ops/pallas/gru_iter.py
// (_gru_forward / _gru_kernel, :129-167) at dtype_name "bfloat16": the math
// is _gru_math(..., "bfloat16") (:78-118), the JAX package's default
// serving dtype, at every hidden, context and correlation-feature width.
// Operands in the dtypes the bf16 model hands them over: net (the float32
// carry), inp, flow8 and the eight float32 weight arrays of
// pack_gru_weights, and cor (B*N, F) bfloat16, the correlation head's
// output. Operands and weights are rounded to bf16, every product is
// accumulated in float32 (bf16 products are exact in float32) and rounded
// to bf16 where _gru_math rounds, the gates are bf16, and the float32
// carry is blended last: gru_general.cuh at kBf16 = true, which states
// each rounding.
//
// Bound on the H100: bytes, 4 * (2H + C + 8) + 2F per point, against
// 2 * (F*H + 8*H + 2H*H + (C + H + 8 + H) * 3H) operations per point,
// which bf16 tensor cores (989 TFLOP/s dense) would do in about a third of
// the bytes' time at the flagship's widths. The products run on the fp32
// CUDA cores (gru_general.cuh's plan, shared with gru_iter_general.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gru_general.cuh"

namespace {

__global__ void gru_bf16_kernel(pvraft::gru::Gru<true> a) {
  pvraft::gru::update(a);
}

}  // namespace

// rows = B * N points; hidden, context, corr_ch: the widths H, C, F;
// groups: groups of 8 query points per block; threads: the block's
// threads; smem: its dynamic shared memory, groups * 8 * 4 * (7 * pad4(H)
// + pad4(C) + pad4(F) + 8) bytes, opted in above 48 KB. cor is bfloat16,
// every other operand float32. Returns the opt-in's error, else
// cudaGetLastError() after the launch.
extern "C" int pvraft_gru_update_bf16(
    const float* net, const float* inp, const __nv_bfloat16* cor,
    const float* flow8, const float* wc, const float* wf, const float* wh,
    const float* wn3, const float* wi3, const float* wh3, const float* wf3,
    const float* bias, float* out, int rows, int hidden, int context,
    int corr_ch, int groups, int threads, int smem, void* stream) {
  const pvraft::gru::Gru<true> a{net, inp, cor, flow8, wc, wf,
                                 wh, wn3, wi3, wh3, wf3, bias,
                                 out, rows, hidden, context, corr_ch,
                                 groups};
  return static_cast<int>(
      pvraft::gru::launch(gru_bf16_kernel, a, threads, smem, stream));
}
