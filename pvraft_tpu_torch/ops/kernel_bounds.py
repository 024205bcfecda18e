"""What each hand-written kernel must move and compute: one source for the
kernels' bounds.

The H100 SXM's published peaks (NVIDIA data sheet) and, per kernel, the
bytes it must move (each input read once, each output written once) and
the operations it does. ``chip_smoke.py`` computes every kernel's bound
from these, and the program inventory (``programs/costs.py``) counts a
program's kernel launches by the same numbers: inside a kernel's
autograd Function, :func:`kernel_scope` hands them to the counter that is
running, which then counts none of the ops the plain version runs there
on the CPU. So a program's count is the same on the CPU and on the card.

Kernels (the rows of ``PERF.md`` §6): 1 and 1g (:func:`lookup_cost`), 3
and 3g (:func:`voxel_cost`), 2, 2g and 2b (:func:`gru_cost`).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

# Published H100 SXM peaks: HBM3 bytes/s, fp32 CUDA-core FLOP/s, dense
# TF32 and bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
# The card's device memory by the data sheet (80 GB); a run on the card
# reads the real total from torch.cuda.mem_get_info.
HBM_CAPACITY_BYTES = 80 * 10**9

FLOW_PAD = 8           # the GRU kernels' padded flow channels


class KernelCost(NamedTuple):
    """One launch's work: ``bytes`` moved, ``flops`` of arithmetic (the
    lookup and voxel kernels' operations: offsets, distances, binning,
    comparisons), and the ``ops`` at ``rate`` (FLOP/s) that bound it:
    ``flops`` on the fp32 CUDA cores, three TF32 products per fp32
    product on the TF32 tensor cores (3xTF32), or ``flops`` on the bf16
    tensor cores."""

    bytes: int
    flops: int
    ops: int
    rate: float


def bound(bytes_: float, ops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    """The least time (ms) for ``bytes_`` moved and ``ops`` done at
    ``flops_per_s``, and which of the two sets it."""
    t_bytes = 1e3 * bytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / flops_per_s
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cost_bound(cost: KernelCost):
    """:func:`bound` of one launch."""
    return bound(cost.bytes, cost.ops, cost.rate)


def lookup_cost(b: int, n: int, k: int, levels: int, resolution: int,
                knn: int) -> KernelCost:
    """Kernels 1 and 1g: corr (B, N, K), xyz (B, N, K, 3) and coords
    (B, N, 3) read; the voxel means (B, N, L R^3) and the kNN's corr,
    rel xyz and index (5 knn a point) written. Per candidate: 3 offsets,
    5 for the distance, per level 3 divisions, 3 roundings and 3 range
    tests; knn comparisons."""
    bytes_ = (4 * b * n * (k + 3 * k + 3)
              + 4 * b * n * (levels * resolution**3 + 5 * knn))
    ops = b * n * k * (3 + 5 + 9 * levels + knn)
    return KernelCost(bytes_, ops, ops, FP32_FLOPS_PER_S)


def voxel_cost(b: int, n: int, k: int, levels: int,
               resolution: int) -> KernelCost:
    """Kernels 3 and 3g: corr (B, N, K) and rel (B, N, K, 3) read, the
    means (B, N, L R^3) written; per candidate and level 3 divisions, 3
    roundings, 3 range tests."""
    bytes_ = 4 * b * n * (k + 3 * k) + 4 * b * n * levels * resolution**3
    ops = b * n * k * 9 * levels
    return KernelCost(bytes_, ops, ops, FP32_FLOPS_PER_S)


def gru_weight_elems(h: int, c: int, f: int) -> int:
    """Floats of the packed weight 8-tuple (``pack_gru_weights``): wc (F,
    H), wf (8, H), wh (2H, H), wn3 (H, 3H), wi3 (C, 3H), wh3 (H, 3H), wf3
    (8, 3H), bias (8, 3H)."""
    return (f * h + FLOW_PAD * h + 2 * h * h + 3 * h * h + 3 * c * h
            + 3 * h * h + 2 * FLOW_PAD * 3 * h)


def gru_flops(b: int, n: int, h: int, c: int, f: int) -> int:
    """The update's products per point: conv_corr, conv_flow (8 padded
    rows), conv, the three gates over concat(inp, hid, flow8), and net
    into the gates."""
    return 2 * b * n * (f * h + FLOW_PAD * h + 2 * h * h
                        + (c + h + FLOW_PAD) * 3 * h + h * 3 * h)


def gru_cost(b: int, n: int, h: int, c: int, f: int,
             unit: str = "tf32") -> KernelCost:
    """Kernels 2, 2g and 2b: net, inp, flow8 (float32) and cor read, the
    new net (float32) written, the float32 weights read once. ``unit``:
    "tf32" (the tuned kernel, the general one's "resident" and "ring"
    modes: 3xTF32), "fma" (the general one's fp32 CUDA-core mode) or
    "bf16" (kernel 2b: cor bf16, the bf16 tensor cores)."""
    weights = 4 * gru_weight_elems(h, c, f)
    flops = gru_flops(b, n, h, c, f)
    if unit == "bf16":
        bytes_ = b * n * (4 * (2 * h + c + FLOW_PAD) + 2 * f) + weights
        return KernelCost(bytes_, flops, flops, BF16_FLOPS_PER_S)
    bytes_ = 4 * b * n * (2 * h + c + f + FLOW_PAD) + weights
    if unit == "fma":
        return KernelCost(bytes_, flops, flops, FP32_FLOPS_PER_S)
    if unit != "tf32":
        raise ValueError(f"gru_cost: unit {unit!r} is not tf32, fma or bf16")
    return KernelCost(bytes_, flops, 3 * flops, TF32_FLOPS_PER_S)


# --- the counter's hook ----------------------------------------------------

# The counter running now (programs/costs.py::OpCounter), if any: a
# program is counted in one process, one at a time.
_ACTIVE: List[Any] = []


def active_counter() -> Optional[Any]:
    return _ACTIVE[-1] if _ACTIVE else None


class _Scope:
    """A kernel Function's forward while a counter runs: the counter
    counts ``cost`` for it and none of the ops inside; :meth:`done`
    hands it the Function's outputs, whose storage is the launch's."""

    def __init__(self, counter, cost: KernelCost):
        self.counter = counter
        self.cost = cost

    def __enter__(self) -> "_Scope":
        self.counter.enter_kernel()
        return self

    def done(self, outputs) -> None:
        self.counter.kernel_outputs(outputs)

    def __exit__(self, *exc) -> None:
        self.counter.exit_kernel(self.cost)


class _NoScope:
    def __enter__(self) -> "_NoScope":
        return self

    def done(self, outputs) -> None:
        pass

    def __exit__(self, *exc) -> None:
        pass


_NO_SCOPE = _NoScope()


def kernel_scope(cost_of: Callable[..., KernelCost], *dims: Any):
    """The context of one kernel Function's forward: with no counter
    running, nothing (the cost is not even computed); with one, the
    launch counts ``cost_of(*dims)`` and no op inside."""
    counter = active_counter()
    if counter is None:
        return _NO_SCOPE
    return _Scope(counter, cost_of(*dims))
