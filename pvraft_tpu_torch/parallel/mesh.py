"""The data layout over the processes and the batch contract (port of
``pvraft_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, seq)`` mesh and lets
GSPMD shard the batch and all-reduce the gradients. The port runs one
process per card, so a device of the JAX mesh is a rank here:
:class:`Mesh` holds the ``(data, seq)`` layout of the ranks, this
process's place in it and the process group of its data axis (the whole
group). A sequence axis of more than one rank is refused: the ring that
shards the points over it is ROADMAP queue 1 item 8b.

:func:`batch_contract` and :func:`eval_scene_shard` are the JAX
functions' arithmetic over the mesh's process count (here the world
size); :func:`replicate` broadcasts rank 0's parameters and buffers, so
that every rank holds the same copy bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from pvraft_tpu_torch.parallel.distributed import (
    is_initialized,
    process_count,
    process_index,
)

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def _refuse_seq(n_seq: int) -> None:
    if n_seq > 1:
        raise NotImplementedError(
            f"a sequence axis of {n_seq} ranks is not ported yet: it "
            "arrives with the sequence-parallel ring (ROADMAP queue 1 item "
            "8b)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data x n_seq`` ranks; this process is ``process_index`` of
    ``process_count``. ``data_group`` is the process group of the data
    axis (None without a process group). ``n_seq`` > 1 raises (item
    8b)."""

    n_data: int
    n_seq: int = 1
    process_index: int = 0
    process_count: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        _refuse_seq(self.n_seq)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, SEQ_AXIS: self.n_seq}


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1,
              world: Optional[int] = None) -> Mesh:
    """The ``(data, seq)`` layout of the process group's ranks (the JAX
    ``make_mesh``): ``n_data`` None or -1 puts every rank on the data
    axis. ``world``: the ranks to lay out, default the group's (1 without
    one); a layout only of arithmetic, without a group, where it is not
    the group's. A layout that does not cover the world exactly raises:
    a process cannot sit out of its own run, as a JAX device can. One
    that covers it with a sequence axis of more than one rank raises
    ``NotImplementedError`` (item 8b)."""
    group_world = process_count()
    world = group_world if world is None else int(world)
    if n_data is None or n_data < 0:
        n_data = world // n_seq
    want = n_data * n_seq
    if want <= 0:
        raise ValueError(f"mesh {n_data}x{n_seq} must have >= 1 device")
    if want != world:
        raise ValueError(
            f"mesh {n_data}x{n_seq} does not cover {world} devices (the "
            f"ranks of the process group)")
    _refuse_seq(n_seq)
    own = world == group_world
    group = dist.group.WORLD if is_initialized() and own else None
    return Mesh(n_data, n_seq, process_index() if own else 0, world, group)


def batch_contract(per_device_batch: int, mesh: Mesh) -> Tuple[int, int]:
    """``(global_batch, local_batch)``: the batch size is per device, the
    global batch ``per_device_batch`` times the data axis, and each
    process loads its share. Raises when the process count does not
    divide the global batch (the JAX ``batch_contract``)."""
    n_data = mesh.shape[DATA_AXIS]
    global_batch = per_device_batch * n_data
    n_proc = max(1, mesh.process_count)
    if global_batch % n_proc != 0:
        raise ValueError(
            f"global batch {global_batch} (= {per_device_batch}/device x "
            f"{n_data} devices) must be a multiple of the process count "
            f"({n_proc})")
    return global_batch, global_batch // n_proc


def eval_scene_shard(n_scenes: int, eval_batch: int, mesh: Mesh
                     ) -> Tuple[int, int]:
    """``(rank, world)`` of an eval loader's scene shard (the JAX
    ``eval_scene_shard``): sharded only where every process's step is a
    full batch (the scene count divides ``eval_batch * process_count``)
    and ``eval_batch`` divides over the process's share of the data
    axis; anything else is ``(0, 1)``: every process evaluates every
    scene, redundant but exact."""
    n_proc = mesh.process_count
    local_data = max(1, mesh.shape[DATA_AXIS] // max(1, n_proc))
    if (n_proc > 1 and n_scenes % (eval_batch * n_proc) == 0
            and eval_batch % local_data == 0):
        return (mesh.process_index, n_proc)
    return (0, 1)


def _bucketed(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The tensors grouped by (dtype, device), in order."""
    groups: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def replicate(module: torch.nn.Module, mesh: Mesh) -> None:
    """Broadcast rank 0's parameters and buffers of ``module`` over the
    data axis, in place: one flat broadcast per dtype, so that
    every rank holds the same copy bit for bit. Nothing to do without a
    process group (the JAX ``replicate`` on one process)."""
    if mesh.data_group is None:
        return
    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    with torch.no_grad():
        for bucket in _bucketed(tensors):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.broadcast(flat, src=0, group=mesh.data_group)
            torch._foreach_copy_(bucket, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in bucket]), bucket)])


def combine_sums(sums: Dict[str, torch.Tensor], count: int, mesh: Mesh,
                 shard_world: int) -> Tuple[Dict[str, torch.Tensor], int]:
    """Per-scene metric sums and the scene count of every rank as one
    (the JAX evaluators' mean x count accumulation), in one collective:
    summed over the ranks where the scenes were sharded (``shard_world``
    > 1), rank 0's where every rank evaluated every scene, so that every
    rank reads the same means to the bit. Unchanged on one process."""
    if mesh.data_group is None or mesh.process_count == 1:
        return sums, count
    keys = sorted(sums)
    device = sums[keys[0]].device if keys else torch.device("cpu")
    packed = torch.stack([sums[k].float().reshape(()) for k in keys]
                         + [torch.tensor(float(count), device=device)])
    if shard_world > 1:
        dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=mesh.data_group)
    else:
        dist.broadcast(packed, src=0, group=mesh.data_group)
    return dict(zip(keys, packed[:-1])), int(round(float(packed[-1])))


def all_true(flag: bool, mesh: Mesh, device: torch.device) -> bool:
    """Whether ``flag`` holds on every rank (one all-reduce; ``device``
    carries it where the backend is NCCL)."""
    if mesh.data_group is None:
        return bool(flag)
    if dist.get_backend(mesh.data_group) != "nccl":
        device = torch.device("cpu")
    t = torch.tensor([0.0 if flag else 1.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return float(t) == 0.0


def barrier(mesh: Mesh) -> None:
    """Every rank of the group waits here (nothing without one)."""
    if mesh.data_group is not None:
        dist.barrier(group=mesh.data_group)
