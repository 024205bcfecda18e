"""The data layout over the processes and the batch contract (port of
``pvraft_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(data, seq)`` mesh and lets
GSPMD shard the batch over ``data``, the points of each scene over
``seq``, and insert the collectives. The port runs one process per card,
so a device of the JAX mesh is a rank here: :class:`Mesh` holds the
``(data, seq)`` layout of the ranks, this process's place in it (rank
``r`` at data index ``r // n_seq`` and seq index ``r % n_seq``, as JAX's
``reshape(devices, (n_data, n_seq))`` places them) and the process groups
of the whole run, of its data axis and of its seq axis.

:func:`batch_contract` and :func:`eval_scene_shard` are the JAX
functions' arithmetic over the data axis's shares of the processes (the
ranks of one data index load the same block); :func:`seq_rows` gives a
rank its contiguous rows of each scene (the JAX ``P(bspec, "seq")``);
:func:`replicate` broadcasts rank 0's parameters and buffers over the
whole run, so that every rank holds the same copy bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from pvraft_tpu_torch.parallel.distributed import (
    is_initialized,
    process_count,
    process_index,
)

DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data x n_seq`` ranks; this process is ``process_index`` of
    ``process_count``. ``group`` is the whole process group, ``data_group``
    the ranks of this rank's seq index (the whole group when ``n_seq`` is
    1) and ``seq_group`` the ranks of its data index (None when ``n_seq``
    is 1); all None without a process group, where the mesh is a layout
    of arithmetic only. A mesh is a handle: copying a model that holds
    one keeps the same mesh."""

    n_data: int
    n_seq: int = 1
    process_index: int = 0
    process_count: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False)
    seq_group: Any = dataclasses.field(default=None, compare=False)
    group: Any = dataclasses.field(default=None, compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, SEQ_AXIS: self.n_seq}

    @property
    def data_index(self) -> int:
        return self.process_index // self.n_seq

    @property
    def seq_index(self) -> int:
        return self.process_index % self.n_seq

    @property
    def data_shares(self) -> int:
        """The blocks the processes load: one per data index they hold
        (the ranks of a seq group load the same one)."""
        return max(1, self.process_count // self.n_seq)

    def __deepcopy__(self, memo):
        return self


def _axis_groups(n_data: int, n_seq: int, rank: int) -> Tuple[Any, Any]:
    """(data group, seq group) of ``rank``: every rank makes every group,
    in the same order (``dist.new_group``'s rule)."""
    data = seq = None
    for s in range(n_seq):
        g = dist.new_group([d * n_seq + s for d in range(n_data)])
        if rank % n_seq == s:
            data = g
    for d in range(n_data):
        g = dist.new_group([d * n_seq + s for s in range(n_seq)])
        if rank // n_seq == d:
            seq = g
    return data, seq


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1,
              world: Optional[int] = None) -> Mesh:
    """The ``(data, seq)`` layout of the process group's ranks (the JAX
    ``make_mesh``): ``n_data`` None or -1 puts every rank the seq axis
    leaves on the data axis. ``world``: the ranks to lay out, default the
    group's (1 without one); a layout only of arithmetic, without groups,
    where it is not the group's. A layout that does not cover the world
    exactly raises: a process cannot sit out of its own run, as a JAX
    device can. Within a process group every rank must call it, in the
    same order: it makes the axes' groups."""
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
    if not (is_initialized() and world == group_world):
        return Mesh(n_data, n_seq, 0, world)
    rank = process_index()
    whole = dist.group.WORLD
    data, seq = ((whole, None) if n_seq == 1
                 else _axis_groups(n_data, n_seq, rank))
    return Mesh(n_data, n_seq, rank, world, data, seq, whole)


def batch_contract(per_device_batch: int, mesh: Mesh) -> Tuple[int, int]:
    """``(global_batch, local_batch)``: the batch size is per device, the
    global batch ``per_device_batch`` times the data axis, and each
    data index's ranks load its share. Raises when the shares do not
    divide the global batch (the JAX ``batch_contract``)."""
    n_data = mesh.shape[DATA_AXIS]
    global_batch = per_device_batch * n_data
    n_proc = mesh.data_shares
    if global_batch % n_proc != 0:
        raise ValueError(
            f"global batch {global_batch} (= {per_device_batch}/device x "
            f"{n_data} devices) must be a multiple of the process count "
            f"({n_proc})")
    return global_batch, global_batch // n_proc


def eval_scene_shard(n_scenes: int, eval_batch: int, mesh: Mesh
                     ) -> Tuple[int, int]:
    """``(rank, world)`` of an eval loader's scene shard over the data
    axis's shares (the JAX ``eval_scene_shard``): sharded only where
    every share's step is a full batch (the scene count divides
    ``eval_batch`` times the shares) and ``eval_batch`` divides over a
    share's part of the data axis; anything else is ``(0, 1)``: every
    share evaluates every scene, redundant but exact. The ranks of a seq
    group take the same shard."""
    n_proc = mesh.data_shares
    local_data = max(1, mesh.shape[DATA_AXIS] // n_proc)
    if (n_proc > 1 and n_scenes % (eval_batch * n_proc) == 0
            and eval_batch % local_data == 0):
        return (mesh.data_index, n_proc)
    return (0, 1)


def check_seq_axis(mesh: Mesh, seq_shard: bool) -> None:
    """What a seq axis of more than one rank refuses: a model without
    ``seq_shard`` (the ranks of a seq group share each scene's points)."""
    if mesh.n_seq > 1 and not seq_shard:
        raise ValueError(
            f"a seq axis of {mesh.n_seq} ranks needs ModelConfig.seq_shard "
            f"(the ranks of a seq group share each scene's points)")


def seq_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows ``[s n/P, (s + 1) n/P)`` of a scene of
    ``n`` points (s its seq index, P the seq axis). Raises where P does
    not divide ``n``, as the JAX ring does."""
    if n % mesh.n_seq:
        raise ValueError(
            f"seq_shard: the mesh seq axis ({mesh.n_seq}) must divide the "
            f"point count ({n})")
    rows = n // mesh.n_seq
    return slice(mesh.seq_index * rows, (mesh.seq_index + 1) * rows)


def seq_shard_batch(batch: Mapping[str, Any], mesh: Mesh,
                    keys: Iterable[str] = ("pc1", "pc2", "mask", "flow")
                    ) -> Dict[str, Any]:
    """``batch`` with each of ``keys`` (B, N, ...) cut to this rank's
    rows (:func:`seq_rows`); the batch itself where the seq axis is 1."""
    if mesh.n_seq == 1:
        return dict(batch)
    out = dict(batch)
    for k in keys:
        out[k] = batch[k][:, seq_rows(batch[k].shape[1], mesh)]
    return out


def _bucketed(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The tensors grouped by (dtype, device), in order."""
    groups: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def replicate(module: torch.nn.Module, mesh: Mesh) -> None:
    """Broadcast rank 0's parameters and buffers of ``module`` over the
    whole run, in place: one flat broadcast per dtype, so that every rank
    holds the same copy bit for bit. Nothing to do without a process
    group (the JAX ``replicate`` on one process)."""
    if mesh.group is None:
        return
    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    with torch.no_grad():
        for bucket in _bucketed(tensors):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.broadcast(flat, src=0, group=mesh.group)
            torch._foreach_copy_(bucket, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in bucket]), bucket)])


def combine_sums(sums: Dict[str, torch.Tensor], count: int, mesh: Mesh,
                 shard_world: int) -> Tuple[Dict[str, torch.Tensor], int]:
    """Per-scene metric sums and the scene count of every rank as one
    (the JAX evaluators' mean x count accumulation). A seq group's ranks
    hold parts of the same scenes' metrics (each a masked mean's share,
    ``engine/metrics.py``): their sums are added first, over the seq
    group. Then, over the data axis, in one collective: summed where the
    scenes were sharded (``shard_world`` > 1), the first data index's
    where every share evaluated every scene, so that every rank reads the
    same means to the bit. Unchanged on one process."""
    if mesh.group is None or mesh.process_count == 1:
        return sums, count
    keys = sorted(sums)
    device = sums[keys[0]].device if keys else torch.device("cpu")
    packed = torch.stack([sums[k].float().reshape(()) for k in keys]
                         + [torch.tensor(float(count), device=device)])
    if mesh.seq_group is not None:
        seq = packed[:-1].clone()
        dist.all_reduce(seq, op=dist.ReduceOp.SUM, group=mesh.seq_group)
        packed = torch.cat([seq, packed[-1:]])
    if mesh.n_data > 1 and shard_world > 1:
        dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=mesh.data_group)
    elif mesh.n_data > 1:
        # The data group's first rank: global rank seq_index.
        dist.broadcast(packed, src=mesh.seq_index, group=mesh.data_group)
    return dict(zip(keys, packed[:-1])), int(round(float(packed[-1])))


def all_true(flag: bool, mesh: Mesh, device: torch.device) -> bool:
    """Whether ``flag`` holds on every rank (one all-reduce; ``device``
    carries it where the backend is NCCL)."""
    if mesh.group is None:
        return bool(flag)
    if dist.get_backend(mesh.group) != "nccl":
        device = torch.device("cpu")
    t = torch.tensor([0.0 if flag else 1.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return float(t) == 0.0


def barrier(mesh: Mesh) -> None:
    """Every rank of the group waits here (nothing without one)."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
