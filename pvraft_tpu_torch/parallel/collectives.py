"""The collectives of the sequence axis, as autograd Functions.

The JAX package shards the points of a scene over the mesh's ``seq``
axis and lets GSPMD insert every collective the model then needs. The
port runs one process per rank, so the model calls them itself, on the
process group of its seq axis (``Mesh.seq_group``):

* :func:`all_reduce_sum`: a sum over the group (the GroupNorm
  statistics, the loss's mask count); its backward is the same sum of
  the cotangents, since every rank's copy of the sum feeds its own loss;
* :func:`gather_points`: the (B, N/P, C) slices of the group's ranks
  joined along the point axis into (B, N, C), in rank order (the
  neighbour gathers, whose indices are global); its backward sums the
  cotangents of the group and keeps this rank's rows;
* :func:`ring_shift`: a tensor sent to the next rank of the group and
  one received from the previous (the JAX ``lax.ppermute`` of the ring);
  its backward sends the cotangent the other way round.

Summing each rank's gradients over the group then gives the gradient of
the one-rank model (``engine/steps.py::GradientAllReduce``).

Transport: NCCL takes the card's tensors. Gloo takes a CUDA tensor in
its all-reduce and broadcast but not in every call; where the group's
backend is gloo and the tensor lies on the card, each gather and shift
stages it through a host copy (:func:`_staged`): the compute stays on
the card, and a failed call raises. ``CALLS`` counts the collectives
this process issued, by kind, forward and backward alike.
"""

from __future__ import annotations

import collections
from typing import Any

import torch
import torch.distributed as dist

# Collectives issued by this process, by kind ("all_reduce", "all_gather",
# "shift"): read by a caller that counts a step's (clear() first).
CALLS: collections.Counter = collections.Counter()


def group_size(group: Any) -> int:
    """The ranks of ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group: Any) -> bool:
    """Whether a gather or a shift of ``t`` goes through a host copy: a
    tensor on the card in a group whose backend is not NCCL."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def reduce_sum_(t: torch.Tensor, group: Any) -> torch.Tensor:
    """In place: ``t`` summed over ``group`` (no autograd)."""
    CALLS["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gather(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The ranks' (B, n, ...) tensors joined along axis 1, in rank
    order."""
    CALLS["all_gather"] += 1
    src = x.detach().contiguous()
    stage = _staged(src, group)
    if stage:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=1)
    return out.to(x.device) if stage else out


def _shift(x: torch.Tensor, group: Any, step: int) -> torch.Tensor:
    """``x`` sent to the rank ``step`` places on in the group; the tensor
    of the rank ``step`` places back, received."""
    CALLS["shift"] += 1
    p, me = group_size(group), dist.get_rank(group)
    send = x.detach().contiguous()
    stage = _staged(send, group)
    if stage:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + step) % p), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - step) % p), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if stage else recv


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_sum_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_sum_(grad.contiguous().clone(), ctx.group), None


class _GatherPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[1]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        total = reduce_sum_(grad.contiguous().clone(), ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return total.narrow(1, start, ctx.rows), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor), differentiably where
    ``x`` needs a gradient."""
    if _differentiable(x):
        return _AllReduceSum.apply(x, group)
    return reduce_sum_(x.detach().clone(), group)


def gather_points(x: torch.Tensor, group: Any) -> torch.Tensor:
    """(B, N/P, ...) -> (B, N, ...): the group's slices in rank order,
    differentiably where ``x`` needs a gradient."""
    if _differentiable(x):
        return _GatherPoints.apply(x, group)
    return _gather(x, group)


def ring_shift(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``x`` to the next rank of ``group``, the previous rank's ``x``
    back (the backward shifts the other way), differentiably where ``x``
    needs a gradient."""
    if _differentiable(x):
        return _RingShift.apply(x, group)
    return _shift(x, group, 1)
