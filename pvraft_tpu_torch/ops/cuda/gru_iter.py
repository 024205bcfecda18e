"""Fused MotionEncoder + ConvGRU update: CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``pvraft_tpu/ops/pallas/gru_iter.py``
(``_gru_forward``, public ``fused_gru_update``; the math is ``_gru_math``,
``:78``). The kernel is ``csrc/gru_iter.cu``, on the tensor cores at fp32
accuracy: every stage is a (points x IN) . (IN x OUT) product on
``mma.sync`` TF32, each fp32 operand split into a TF32 ``hi`` and ``lo = x
- hi`` and three products summed per step (3xTF32), in partial sums that
rounded fp32 adds take onto the accumulators. Its bound at 1 x 8192
points: 2.6 us of bytes (8.86 MB at 3.35 TB/s), 5.1 us of 3xTF32
operations (3 x 0.839 GFLOP at 495 TFLOP/s; the kernel's bound), 12.5 us
had the same work run on the fp32 CUDA cores (67 TFLOP/s). Design (the
source header says what each part addresses and what it measured): 64
points per block, 8 warps, each owning 32 points x 16 channels of every
stage, so that z, r, q and net of a (point, channel) meet in one thread;
activations split once into shared (hi, lo) tiles; weights streamed from
L2 through a three-slot shared-memory ring by ``cp.async``; bias,
activations, ``r * net`` and the blend on the accumulator fragments; the
new state leaves by 16-byte stores. ``python -m pvraft_tpu_torch.gru_ab``
times it against other sources of the same entry point.

:func:`fused_gru_update` is a ``torch.autograd.Function``. Its forward
launches the kernel for CUDA tensors and runs :func:`gru_math` for CPU
tensors; its backward recomputes :func:`gru_math` and differentiates it
(the JAX ``_fused_gru_bwd``, ``gru_iter.py:256-262``). Its ``launches``
attribute counts eager kernel launches. :func:`pack_gru_weights` and
:func:`pad_flow` build the kernel's operands exactly as the JAX package
does, outside the Function, so gradients reach the raw ``Linear``
parameters through their pads and concatenations.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from pvraft_tpu_torch.ops import cuda as _cuda

# Flow is zero-padded from 3 to FLOW_PAD channels; the zero columns
# contribute exact zeros.
FLOW_PAD = 8
WIDTH = _cuda.GRU_WIDTH   # hidden, context and correlation-feature width

Weights = Tuple[torch.Tensor, ...]


def pad_flow(flow: torch.Tensor) -> torch.Tensor:
    """Zero-pad the (B, N, 3) flow to (B, N, FLOW_PAD) channels."""
    return F.pad(flow, (0, FLOW_PAD - flow.shape[-1]))


def pack_gru_weights(me_params: Sequence[torch.Tensor],
                     gru_params: Sequence[torch.Tensor],
                     hidden: int, context: int) -> Weights:
    """Pack the raw (in, out) Dense kernels and biases into the kernel's
    operand layout ``(wc, wf, wh, wn3, wi3, wh3, wf3, bias)``.

    ``me_params``: ``(wc, bc, wf, bf, wh, bh)`` of MotionEncoder's
    conv_corr / conv_flow / conv; ``gru_params``: ``(wz, bz, wr, br, wq,
    bq)``. Flow-input kernels are zero-padded to FLOW_PAD rows, ``conv``'s
    output padded hidden-3 -> hidden columns, the three gate kernels
    stacked to (., 3*hidden) and split by the rows of ``concat(net, inp,
    hid, flow)``, and both bias sets stacked into one (FLOW_PAD, 3*hidden)
    array (row 0: MotionEncoder, row 1: gates).
    """
    wc, bc, wf, bf, wh, bh = me_params
    wz, bz, wr, br, wq, bq = gru_params
    h = hidden
    wf8 = F.pad(wf, (0, 0, 0, FLOW_PAD - wf.shape[0]))
    whp = F.pad(wh, (0, h - wh.shape[1]))
    bhp = F.pad(bh, (0, h - bh.shape[0]))
    wg = torch.cat([wz, wr, wq], dim=1)                   # (H+C+H, 3H)
    wn3 = wg[0:h]
    wi3 = wg[h:h + context]
    wh3 = F.pad(wg[h + context:h + context + (h - 3)], (0, 0, 0, 3))
    wf3 = F.pad(wg[h + context + (h - 3):], (0, 0, 0, FLOW_PAD - 3))
    bias2 = torch.stack([torch.cat([bc, bf, bhp]), torch.cat([bz, br, bq])])
    bias = F.pad(bias2, (0, 0, 0, FLOW_PAD - 2))
    return tuple(t.contiguous()
                 for t in (wc, wf8, whp, wn3, wi3, wh3, wf3, bias))


def gru_math(net, inp, cor_in, flow8, weights: Weights) -> torch.Tensor:
    """The fused update in plain PyTorch (``_gru_math`` of the JAX
    package, fp32): the new (B, N, H) hidden state."""
    wc, wf, wh, wn3, wi3, wh3, wf3, bias = weights
    h = net.shape[-1]
    b_me = bias[0]
    b_g = bias[1]
    cor = torch.relu(cor_in @ wc + b_me[0:h])
    flo = torch.relu(flow8 @ wf + b_me[h:2 * h])
    hid = torch.relu(cor @ wh[:h] + flo @ wh[h:] + b_me[2 * h:3 * h])
    px = inp @ wi3 + hid @ wh3 + flow8 @ wf3 + b_g
    zr = px[..., 0:2 * h] + net @ wn3[:, 0:2 * h]
    z = torch.sigmoid(zr[..., 0:h])
    r = torch.sigmoid(zr[..., h:2 * h])
    q = torch.tanh(px[..., 2 * h:3 * h] + (r * net) @ wn3[:, 2 * h:3 * h])
    return (1.0 - z) * net + z * q


def _signature(fn) -> None:
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _launch(net: torch.Tensor, inp: torch.Tensor, cor: torch.Tensor,
            flow8: torch.Tensor, weights: Weights) -> torch.Tensor:
    what = "fused_gru_update"
    b, n, h = net.shape
    _cuda.require_cuda(what, net, inp, cor, flow8, *weights)
    shapes = [tuple(t.shape) for t in (net, inp, cor, flow8, *weights)]
    want = [(b, n, WIDTH)] * 3 + [(b, n, FLOW_PAD), (WIDTH, WIDTH),
                                  (FLOW_PAD, WIDTH), (2 * WIDTH, WIDTH)] \
        + [(WIDTH, 3 * WIDTH)] * 3 + [(FLOW_PAD, 3 * WIDTH)] * 2
    if shapes != want:
        raise ValueError(f"{what}: the kernel takes width {WIDTH}; "
                         f"operand shapes {shapes}, expected {want}")
    if any(t.data_ptr() % 16 for t in (net, inp, cor, flow8, *weights)):
        raise ValueError(f"{what}: every operand must be 16-byte aligned "
                         "(the kernel reads them by 16-byte copies)")
    _cuda.check_capturable(what, net.device)
    out = torch.empty_like(net)
    fn = _cuda.library("gru_iter").pvraft_gru_update
    _signature(fn)
    with torch.cuda.device(net.device):
        code = fn(*(t.data_ptr() for t in (net, inp, cor, flow8, *weights,
                                           out)),
                  b * n, _cuda.stream_ptr(net.device))
    _cuda.check(code, what)
    _cuda.record_launch(fused_gru_update, net.device)
    return out


class _FusedGru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, net, inp, cor, flow8, *weights):
        ctx.save_for_backward(net, inp, cor, flow8, *weights)
        if not net.is_cuda:
            return gru_math(net, inp, cor, flow8, weights)
        return _launch(net, inp, cor, flow8, weights)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(r)
                  for t, r in zip(ctx.saved_tensors, need)]
            out = gru_math(*xs[:4], tuple(xs[4:]))
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return tuple(next(got) if r else None for r in need)


def fused_gru_update(net: torch.Tensor, inp: torch.Tensor, cor: torch.Tensor,
                     flow8: torch.Tensor, weights: Weights) -> torch.Tensor:
    """Fused MotionEncoder + ConvGRU hidden-state update.

    net, inp, cor: (B, N, 64) f32; flow8: (B, N, FLOW_PAD) f32, padded by
    :func:`pad_flow`; weights: the 8-tuple of :func:`pack_gru_weights`.
    Returns the new (B, N, 64) f32 hidden state. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.
    """
    return _FusedGru.apply(net, inp, cor, flow8, *weights)


fused_gru_update.launches = 0
