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
times it against other sources of the same entry point. That kernel is
built on width 64 (its 222 KB of shared memory); every other width, and
operands not 16-byte aligned, run the general kernel
``csrc/gru_iter_general.cu`` (:func:`gru_iter_general`), on the same
3xTF32 tensor-core products at any widths: 32 points and one n8 channel
tile of every stage a warp, the tile's rows in shared memory as fp32
(split as fragments are read), its weights resident in shared memory
where they fit ("resident") or streamed from L2 through a three-slot
ring ("ring"), both moved by bulk (TMA) copies where the widths allow
it; widths no such layout holds (hidden above 128) run its earlier FMA
body ("fma"): :func:`general_gru_plan`. At ``compute_dtype="bfloat16"`` the update is the JAX kernel's
bf16 ``_gru_math`` and runs ``csrc/gru_iter_bf16.cu``
(:func:`gru_iter_bf16`, at every width), on the bf16 tensor cores
(``mma.sync`` m16n8k16, float32 accumulators, one per product): 16 points
go through the chain together on one or two warps, their inputs and bf16
intermediates in rows of shared memory; the weights, rounded to bf16, are
staged once per block of a persistent grid where they fit (widths up to
~80), else a stage's columns at a time (:func:`bf16_gru_plan`). Operands,
weights and every product, sum, gate and ``r * net`` are rounded to bf16
where ``_gru_math`` rounds them, the float32 carry blended last.

:func:`fused_gru_update` is a ``torch.autograd.Function``. Its forward
launches the tuned kernel where it takes the widths, else the general
one (the bf16 kernel at bf16), for CUDA tensors, and runs
:func:`gru_math` for CPU tensors; its backward recomputes :func:`gru_math`
at the same dtype and differentiates it (the JAX ``_fused_gru_bwd``,
``gru_iter.py:256-262``). Its ``launches`` attribute counts eager
launches of the tuned kernel, ``gru_iter_general.launches`` and
``gru_iter_bf16.launches`` those of the other two. :func:`pack_gru_weights` and
:func:`pad_flow` build the kernel's operands exactly as the JAX package
does, outside the Function, so gradients reach the raw ``Linear``
parameters through their pads and concatenations.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

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


def gru_math(net, inp, cor_in, flow8, weights: Weights,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The fused update in plain PyTorch (``_gru_math`` of the JAX
    package): the new (B, N, H) hidden state. With a ``dtype``, operands
    and weights are cast to it, and so is every product, sum and
    activation (each product accumulated in float32 by the backend and
    rounded once), and the carry ``net`` is blended last in its own
    dtype (float32 in the model); without, everything runs in the
    operands' dtype."""
    carry = net
    if dtype is not None:
        weights = tuple(w.to(dtype) for w in weights)
        net, inp, cor_in, flow8 = (t.to(dtype)
                                   for t in (net, inp, cor_in, flow8))
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
    return (1.0 - z) * carry + z * q


def _signature(fn) -> None:
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _launch(net: torch.Tensor, inp: torch.Tensor, cor: torch.Tensor,
            flow8: torch.Tensor, weights: Weights) -> torch.Tensor:
    """The tuned kernel where it takes the operands (every width
    :data:`WIDTH`, every operand 16-byte aligned), else the general one."""
    what = "fused_gru_update"
    b, n, h = net.shape
    _cuda.require_cuda(what, net, inp, cor, flow8, *weights,
                       dtypes=torch.float32)
    shapes = [tuple(t.shape) for t in (net, inp, cor, flow8, *weights)]
    want = [(b, n, WIDTH)] * 3 + [(b, n, FLOW_PAD), (WIDTH, WIDTH),
                                  (FLOW_PAD, WIDTH), (2 * WIDTH, WIDTH)] \
        + [(WIDTH, 3 * WIDTH)] * 3 + [(FLOW_PAD, 3 * WIDTH)] * 2
    if shapes != want or any(t.data_ptr() % 16 for t in
                             (net, inp, cor, flow8, *weights)):
        return gru_iter_general(net, inp, cor, flow8, weights)
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


GENERAL_POINTS = 8     # points per group of the general kernel's "fma" mode
# The general kernel's modes, in the order of the C entry's mode codes.
GENERAL_MODES = ("fma", "resident", "ring")
GENERAL_MAX_TILES = 16   # n8 channel tiles a tensor-core layout takes
GENERAL_SLOTS = 3        # weight chunks a "ring" holds
GENERAL_BARRIERS = 64    # bytes of the tensor-core modes' mbarriers


class GeneralGruPlan(NamedTuple):
    """The general kernel's launch shape: its mode, points per block,
    threads per block, dynamic shared memory bytes and, in "ring", the
    weight rows a ring slot holds."""
    mode: str
    rows: int
    threads: int
    smem: int
    chunk: int

    @property
    def launch(self) -> Tuple[int, int, int]:
        """The C entry's three launch ints: mode code, points per block,
        shared memory bytes."""
        return GENERAL_MODES.index(self.mode), self.rows, self.smem


def _ld(n: int) -> int:
    """A row of n floats (a multiple of 8) padded to 8 or 24 mod 32."""
    return n + 8 if n % 16 == 0 else n


def general_gru_need(mode: str, rows: int, hidden: int, context: int,
                     corr_ch: int) -> Optional[Tuple[int, int, int]]:
    """(shared memory bytes, threads, ring chunk rows) of the general
    kernel in ``mode`` at ``rows`` points a block, or None where that
    layout does not exist: ``plan::need`` of ``csrc/gru_iter_general.cu``,
    which the C entry checks a launch against.

    "resident" and "ring" (the tensor cores): 32 points and one n8
    channel tile a warp (16 tiles at most), 16 warps at most; a point's
    row holds net, flow8, max(cor_in, hid), cor, flo and
    inp, each padded to 8 floats, the row to 4 mod 8, and 64 bytes of
    mbarriers. "resident" adds the eight
    weight arrays (rows padded to 8, each gate's columns to the n8 tiles,
    rows of 8 or 24 mod 32 floats); "ring" GENERAL_SLOTS slots of 8 to 64
    rows (a multiple of 8, the most that fit) of three gates. "fma": 8-point groups of
    4 (7 pad4(H) + pad4(C) + pad4(F) + 8) bytes a point, a thread per
    channel of a group, 256 at most."""
    h, c, f = hidden, context, corr_ch
    if min(h, c, f, rows) < 1:
        return None
    if mode == "fma":
        if rows % GENERAL_POINTS:
            return None
        threads = min(256, -(-(rows // GENERAL_POINTS) * h // 32) * 32)
        return rows * 4 * (7 * _pad(h, 4) + _pad(c, 4) + _pad(f, 4)
                           + FLOW_PAD), threads, 0
    hp, tiles = _pad(h, 8), -(-h // 8)
    if mode not in ("resident", "ring") or rows not in (32, 64) \
            or tiles > GENERAL_MAX_TILES:
        return None
    warps = rows // 32 * tiles
    if warps > 16:
        return None
    row = 3 * hp + FLOW_PAD + max(_pad(f, 8), hp) + _pad(c, 8) + 4
    act = rows * row
    if mode == "resident":
        weights = ((_pad(f, 8) + FLOW_PAD + 2 * hp) * _ld(hp)
                   + (_pad(c, 8) + 2 * hp + FLOW_PAD) * _ld(3 * hp))
        return 4 * (act + weights) + GENERAL_BARRIERS, 32 * warps, 0
    slot_row = GENERAL_SLOTS * _ld(3 * hp)
    room = (_cuda.SMEM_MAX - GENERAL_BARRIERS) // 4 - act
    chunk = min(64, max(8, room // slot_row // 8 * 8))
    return 4 * (act + chunk * slot_row) + GENERAL_BARRIERS, 32 * warps, chunk


@functools.lru_cache(maxsize=None)
def general_gru_plan(hidden: int, context: int, corr_ch: int,
                     mode: Optional[str] = None) -> GeneralGruPlan:
    """The general kernel's launch shape for widths (H, C, F): on the
    tensor cores where a layout fits in the SMEM_MAX a block can have,
    64 points a block before 32, weights "resident" before "ring";
    else mode "fma" (as many 8-point groups as keep about 256 threads
    busy within 48 KB). ``mode`` holds the plan to one mode (an A/B
    between modes). Raises where no layout of the mode fits, naming the
    limit."""
    h, c, f = hidden, context, corr_ch
    if mode is not None and mode not in GENERAL_MODES:
        raise ValueError(f"gru_iter_general: mode {mode!r} is not one of "
                         f"{GENERAL_MODES}")
    if min(h, c, f) >= 1:
        for rows in (64, 32):
            for m in ("resident", "ring"):
                if mode not in (None, m):
                    continue
                got = general_gru_need(m, rows, h, c, f)
                if got is not None and got[0] <= _cuda.SMEM_MAX:
                    return GeneralGruPlan(m, rows, got[1], got[0], got[2])
        group = GENERAL_POINTS * 4 * (7 * _pad(h, 4) + _pad(c, 4)
                                      + _pad(f, 4) + FLOW_PAD)
        if mode in (None, "fma") and group <= _cuda.SMEM_MAX:
            groups = max(1, min(256 // h, _cuda.SMEM_DEFAULT // group))
            smem, threads, _ = general_gru_need(
                "fma", GENERAL_POINTS * groups, h, c, f)
            return GeneralGruPlan("fma", GENERAL_POINTS * groups, threads,
                                  smem, 0)
    raise ValueError(
        f"gru_iter_general: widths hidden={h}, context={c}, corr={f} fit "
        f"no layout{'' if mode is None else ' of mode ' + repr(mode)}; "
        f"the kernel takes widths >= 1 within the {_cuda.SMEM_MAX} bytes "
        f"of shared memory a block can have")


BF16_ROWS = 16         # points per warp tile of the bf16 kernel (mma m16)
BF16_BLOCK = 32        # channels per block of its products (kBlock)
BF16_MAX_WARPS = 8


def _bf16_mats(h: int, c: int, f: int) -> Tuple[Tuple[int, int], ...]:
    """(input rows, gates) of the bf16 kernel's weight arrays: wc, wf,
    wh[:H], wh[H:], wi3, wh3, wf3, wn3."""
    return ((f, 1), (FLOW_PAD, 1), (h, 1), (h, 1), (c, 3), (h, 3),
            (FLOW_PAD, 3), (h, 3))


def _pad(x: int, m: int) -> int:
    return -(-x // m) * m


def bf16_gru_plan(hidden: int, context: int, corr_ch: int, rows: int,
                  sms: int) -> Tuple[int, int, int, str]:
    """The bf16 kernel's launch shape for ``rows`` points on a card of
    ``sms`` SMs: (blocks, threads per block, dynamic shared memory bytes,
    mode). A block holds the rounded biases (24 pad32(H) bytes) and each
    warp 32 bytes a column of its 16 points' rows: the four bf16
    intermediate regions (4 pad32(H)) and, staged, its inputs (netd to
    pad32(H), inp to pad16(C), flow8 to 16, cor to pad16(F) over hid and
    r * netd where it fits there), each row padded by 8. Mode "resident":
    every weight array, rounded to bf16 (rows padded to 16, each gate's
    columns to pad32(H), rows by 8), fits beside four warps' staged rows,
    and a persistent grid of at most one block per SM stages it once per
    block. "streamed": a slab, the weight columns of one stage for one
    block of 32 channels (the largest: wi3, wh3, wf3 over 3 gates and
    wn3's z | r), fits beside one tile's staged rows; the block stages
    each slab in turn for all its warps. "bare": neither (widths whose
    staged rows do not fit); inputs and weights are read from global
    memory. A tile runs on a team of two warps above hidden width 32
    where the weights are resident, else on one. Warps per block spread
    the tiles of 16 points over the SMs (4 to 8 where resident, up to 8
    else). The same formulas as
    ``csrc/gru_iter_bf16.cu`` (``bias_bytes``, ``warp_bytes``,
    ``weight_elems``, ``slab_elems``), which checks them. Raises where one
    warp's bare rows do not fit in the SMEM_MAX a block can have, naming
    the limit."""
    h, c, f = hidden, context, corr_ch
    hp = _pad(h, 32)
    bias = 24 * hp
    bare = 2 * BF16_ROWS * (4 * hp + 8)
    if min(h, c, f) < 1 or bias + bare > _cuda.SMEM_MAX:
        raise ValueError(
            f"gru_iter_bf16: widths hidden={h}, context={c}, corr={f} need "
            f"{bias + bare} bytes of shared memory for {BF16_ROWS} points; "
            f"the kernel takes widths >= 1 within the {_cuda.SMEM_MAX} a "
            f"block can have")
    cor = _pad(f, 16) if _pad(f, 16) > 2 * hp else 0
    staged = 2 * BF16_ROWS * (5 * hp + _pad(c, 16) + 16 + cor + 8)
    mats = _bf16_mats(h, c, f)
    weights = sum(2 * _pad(k, 16) * (ng * hp + 8) for k, ng in mats)

    def part(m, ng):
        return 2 * _pad(mats[m][0], 16) * (ng * BF16_BLOCK + 8)

    slab = max(part(0, 1) + part(1, 1), part(2, 1) + part(3, 1),
               part(4, 3) + part(5, 3) + part(6, 3) + part(7, 2), part(7, 1))
    tiles = -(-rows // BF16_ROWS)
    team = 1                                  # warps a tile
    if bias + weights + 4 * staged <= _cuda.SMEM_MAX:
        mode, base, per = "resident", bias + weights, staged
        team = 2 if hp >= 2 * BF16_BLOCK else 1
    elif bias + slab + staged <= _cuda.SMEM_MAX:
        mode, base, per = "streamed", bias + slab, staged
    else:
        mode, base, per = "bare", bias, bare
    fit = min(BF16_MAX_WARPS, team * ((_cuda.SMEM_MAX - base) // per))
    warps = min(fit, max(team, team * -(-tiles // sms)))
    if mode == "resident":
        warps = max(4, warps)   # the 8 weight arrays staged 4 at a time
    blocks = max(1, -(-tiles // (warps // team)))
    if mode == "resident":
        blocks = min(blocks, sms)
    return blocks, 32 * warps, base + warps * per // team, mode


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _general_signature(fn) -> None:
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _launch_general(wrapper, entry: str, operands: Sequence[torch.Tensor],
                    cor_dtype: torch.dtype, plan) -> torch.Tensor:
    """Check the operands ``(net, inp, cor, flow8, *weights)`` of a
    general-width kernel (every operand float32 but ``cor``, of
    ``cor_dtype``), launch its C ``entry`` on ``plan(h, c, f, rows,
    device)``'s last three ints and count the launch on ``wrapper``."""
    what = wrapper.__name__
    net, inp, cor = operands[:3]
    b, n, h = net.shape
    c, f = inp.shape[-1], cor.shape[-1]
    _cuda.require_cuda(what, *operands, dtypes=[
        torch.float32, torch.float32, cor_dtype] + [torch.float32] * 9)
    shapes = [tuple(t.shape) for t in operands]
    want = [(b, n, h), (b, n, c), (b, n, f), (b, n, FLOW_PAD), (f, h),
            (FLOW_PAD, h), (2 * h, h), (h, 3 * h), (c, 3 * h), (h, 3 * h),
            (FLOW_PAD, 3 * h), (FLOW_PAD, 3 * h)]
    if shapes != want:
        raise ValueError(f"{what}: operand shapes {shapes}, expected {want}")
    launch = plan(h, c, f, b * n, net.device)
    _cuda.check_capturable(what, net.device)
    out = torch.empty_like(net)
    fn = getattr(_cuda.library(what), entry)
    _general_signature(fn)
    with torch.cuda.device(net.device):
        code = fn(*(t.data_ptr() for t in (*operands, out)), b * n, h, c, f,
                  *launch, _cuda.stream_ptr(net.device))
    _cuda.check(code, what)
    _cuda.record_launch(wrapper, net.device)
    return out


def gru_iter_general(net: torch.Tensor, inp: torch.Tensor, cor: torch.Tensor,
                     flow8: torch.Tensor, weights: Weights) -> torch.Tensor:
    """The general GRU kernel (``csrc/gru_iter_general.cu``) at any hidden
    width H, context width C and correlation width F, on the float32
    operands of :func:`pack_gru_weights` and :func:`pad_flow`. Launches
    the kernel or raises (CPU tensors take :func:`gru_math` in the
    Function that calls this)."""
    return _launch_general(
        gru_iter_general, "pvraft_gru_update_general",
        (net, inp, cor, flow8, *weights), torch.float32,
        lambda h, c, f, rows, dev: general_gru_plan(h, c, f).launch)


def gru_iter_bf16(net: torch.Tensor, inp: torch.Tensor, cor: torch.Tensor,
                  flow8: torch.Tensor, weights: Weights) -> torch.Tensor:
    """The bf16 GRU kernel (``csrc/gru_iter_bf16.cu``): ``gru_math(...,
    dtype=torch.bfloat16)`` at any widths, on :func:`bf16_gru_plan`'s
    launch shape. The operands come in the dtypes the bf16 model hands
    over, ``cor`` (the correlation head's output) bfloat16 and the rest
    float32 (the carry, the context, the flow, the float32 parameters);
    the kernel rounds them to bf16 itself. Launches the kernel or raises:
    no operand is cast here, and nothing falls back to the plain
    version."""
    return _launch_general(
        gru_iter_bf16, "pvraft_gru_update_bf16",
        (net, inp, cor, flow8, *weights), torch.bfloat16,
        lambda h, c, f, rows, dev: bf16_gru_plan(
            h, c, f, rows, _sm_count(dev.index))[:3])


class _FusedGru(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dtype, net, inp, cor, flow8, *weights):
        ctx.dtype = dtype
        ctx.save_for_backward(net, inp, cor, flow8, *weights)
        if not net.is_cuda:
            return gru_math(net, inp, cor, flow8, weights, dtype)
        if dtype == torch.bfloat16:
            return gru_iter_bf16(net, inp, cor, flow8, weights)
        if dtype != torch.float32:
            raise ValueError(f"fused_gru_update: no kernel computes in "
                             f"{dtype}; it takes float32 and bfloat16")
        return _launch(net, inp, cor, flow8, weights)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(r)
                  for t, r in zip(ctx.saved_tensors, need)]
            out = gru_math(*xs[:4], tuple(xs[4:]), ctx.dtype)
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        return (None, *(next(got) if r else None for r in need))


def fused_gru_update(net: torch.Tensor, inp: torch.Tensor, cor: torch.Tensor,
                     flow8: torch.Tensor, weights: Weights,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused MotionEncoder + ConvGRU hidden-state update at compute dtype
    ``dtype`` (the JAX ``dtype_name``).

    net (B, N, H), inp (B, N, C) f32; cor (B, N, F) in ``dtype`` (the
    correlation head's output); flow8: (B, N, FLOW_PAD) f32, padded by
    :func:`pad_flow`; weights: the float32 8-tuple of
    :func:`pack_gru_weights`. Returns the new (B, N, H) f32 hidden state.
    CPU tensors take the plain version; CUDA tensors launch, at float32,
    the tuned kernel at width 64, else the general one, and at bfloat16
    the bf16 kernel, or raise.
    """
    return _FusedGru.apply(dtype, net, inp, cor, flow8, *weights)


fused_gru_update.launches = 0
gru_iter_general.launches = 0
gru_iter_bf16.launches = 0
