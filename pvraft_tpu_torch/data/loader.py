"""Batch loaders and the copy to the device (port of
``pvraft_tpu/data/loader.py``).

:class:`PrefetchLoader` yields the same batches in the same order as the
JAX package's for the same arguments, by three paths:

  * ``num_workers=0``: serial numpy loading;
  * threaded: Python threads, which release the interpreter lock inside
    numpy's file reads; a worker's exception is raised in the consuming
    thread;
  * native: the port's C++ batch assembler (``native/npy_loader.cc``)
    reads and subsamples a batch's scenes with a thread pool, for datasets
    with ``native_paths`` (FT3D, KITTI). It draws other subsamples than
    the numpy paths (its own xorshift128+, the JAX package's too). Asked
    for where the library cannot be built, it raises, naming
    ``native=False``; a dataset without ``native_paths`` (synthetic)
    takes the threaded path.

:func:`first_batch` takes a loader's first batch and shuts its workers
down. :func:`to_device` turns a numpy batch into tensors on the device,
through pinned host memory and a non-blocking copy on a GPU;
:func:`device_prefetch` keeps the next batch's copy in flight while the
current one is consumed. The loader's
threads make numpy arrays only: every tensor, and so every tensor a
captured graph reads, is touched by the consuming thread alone.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from pvraft_tpu_torch.data.generic import Item, SceneFlowDataset, collate
from pvraft_tpu_torch.rng import host_rng

# Rows the native assembler's per-scene buffers hold: every pixel of a
# 540 x 960 FlyingThings3D frame, the largest scene either preprocessor
# writes (KITTI frames are at most 376 x 1242). A larger scene fails with
# an IOError naming its file.
NATIVE_MAX_ROWS = 540 * 960
# Batches the threaded path may hold ahead of the consumer, beyond one per
# worker.
PREFETCH = 4


class PrefetchLoader:
    """Iterate collated batches, serially, with worker threads and a
    bounded queue, or through the native assembler."""

    def __init__(self, dataset: SceneFlowDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = True,
                 num_workers: int = 4, seed: int = 0, native: bool = False,
                 shard: tuple = (0, 1)):
        """``shard=(rank, world)`` gives rank ``rank`` its
        ``batch_size``-row block of every global batch of ``batch_size *
        world`` rows, after the seeded shuffle, which every rank draws
        alike (block-cyclic, so that a sharded run holds the same rows on
        the same devices as one process at the global batch). Only full
        global batches are kept, so ``drop_last=False`` with a tail that
        does not fill one is refused rather than silently truncated.
        Default (0, 1): every sample."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.seed = seed
        rank, world = shard
        if not 0 <= rank < world:
            raise ValueError(f"shard rank {rank} outside world {world}")
        if world > 1 and not drop_last and len(dataset) % (batch_size * world):
            raise ValueError(
                f"drop_last=False with shard world={world} requires "
                f"len(dataset) ({len(dataset)}) divisible by "
                f"batch_size*world ({batch_size * world}): the sharded "
                f"epoch keeps only full global batches, so the "
                f"{len(dataset) % (batch_size * world)}-sample tail would "
                f"be silently dropped; pass drop_last=True to accept "
                f"truncation or pad/shard the dataset exactly")
        self.shard = (rank, world)
        self.native = bool(native and hasattr(dataset, "native_paths"))
        if self.native:
            from pvraft_tpu_torch import native as native_mod

            native_mod.library()  # builds, or raises naming native=False

    def __len__(self) -> int:
        world = self.shard[1]
        if world > 1:
            return len(self.dataset) // (self.batch_size * world)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Item]:
        self.dataset.set_epoch(epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            host_rng(self.seed, "data.shuffle", epoch).shuffle(order)
        rank, world = self.shard
        if world > 1:
            # Full global batches only, the same count on every rank; rank
            # r takes rows [r*B, (r+1)*B) of each global batch.
            g = self.batch_size * world
            n_full = (len(order) // g) * g
            order = (order[:n_full].reshape(-1, world, self.batch_size)
                     [:, rank, :].reshape(-1))
        starts = list(range(0, len(order), self.batch_size))
        if self.drop_last:
            starts = [s for s in starts if s + self.batch_size <= len(order)]

        if self.native:
            yield from self._native_epoch(order, starts, epoch)
        elif self.num_workers == 0:
            for s in starts:
                idx = order[s:s + self.batch_size]
                yield collate([self.dataset[int(i)] for i in idx])
        else:
            yield from self._threaded_epoch(order, starts)

    def _native_epoch(self, order, starts, epoch: int) -> Iterator[Item]:
        """C++ batch assembly. Reject-and-advance per item: only the rows
        whose scene has too few points are requested again, at the next
        index; the rest of the batch is kept."""
        from pvraft_tpu_torch import native as native_mod

        ds = self.dataset
        threads = max(1, self.num_workers)
        for s in starts:
            idxs = [int(i) for i in order[s:s + self.batch_size]]
            pending = list(range(len(idxs)))  # batch rows still unfilled
            out = None
            for _attempt in range(len(ds) + 1):
                quads = [ds.native_paths(idxs[p]) for p in pending]
                pc1, pc2, mask, flow, status = native_mod.load_scene_batch(
                    [q[0] for q in quads], [q[1] for q in quads],
                    [idxs[p] for p in pending], ds.nb_points,
                    NATIVE_MAX_ROWS, seed=ds._seed, epoch=epoch,
                    flip_xz=quads[0][2], filter_mode=quads[0][3],
                    n_threads=threads)
                if np.any(status < 0):
                    bad = int(np.argmax(status < 0))
                    raise IOError(f"native loader failed on {quads[bad][0]} "
                                  f"(status {int(status[bad])})")
                if out is None:  # the first pass covers the whole batch
                    out = {"pc1": pc1, "pc2": pc2, "mask": mask, "flow": flow}
                else:
                    for row, p in enumerate(pending):
                        out["pc1"][p] = pc1[row]
                        out["pc2"][p] = pc2[row]
                        out["mask"][p] = mask[row]
                        out["flow"][p] = flow[row]
                retry = [p for row, p in enumerate(pending) if status[row] != 1]
                if not retry:
                    break
                for p in retry:
                    idxs[p] = (idxs[p] + 1) % len(ds)
                pending = retry
            else:
                raise RuntimeError("no scene with enough points")
            yield out

    def _threaded_epoch(self, order, starts) -> Iterator[Item]:
        todo: "queue.Queue[Optional[int]]" = queue.Queue()
        done: Dict[int, Item] = {}
        done_lock = threading.Condition()
        errors: list = []
        stop = False  # guarded by done_lock; True once the epoch ends

        for rank in range(len(starts)):
            todo.put(rank)
        for _ in range(self.num_workers):
            todo.put(None)

        def worker():
            while True:
                rank = todo.get()
                if rank is None:
                    return
                try:
                    s = starts[rank]
                    idx = order[s:s + self.batch_size]
                    batch = collate([self.dataset[int(i)] for i in idx])
                except BaseException as e:  # raised in the consuming thread
                    with done_lock:
                        errors.append(e)
                        done_lock.notify_all()
                    return
                with done_lock:
                    # Bounded prefetch: stall while too far ahead of the
                    # consumer; ``stop`` ends the stall when the consumer
                    # abandons the epoch.
                    while (not stop and rank - min(done.keys(), default=rank)
                           > PREFETCH + self.num_workers):
                        done_lock.wait(timeout=0.5)
                    if stop:
                        return
                    done[rank] = batch
                    done_lock.notify_all()

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in workers:
            t.start()
        try:
            for rank in range(len(starts)):
                with done_lock:
                    while rank not in done:
                        if errors:
                            raise errors[0]
                        done_lock.wait(timeout=0.5)
                    batch = done.pop(rank)
                    done_lock.notify_all()
                yield batch
        finally:
            # Shut the pool down whether the epoch ended or the consumer
            # walked away: wake stalled workers, drain the queue, post the
            # exit sentinels again and join (bounded: a worker may be in a
            # file read; a straggler is a daemon and exits at its next
            # check).
            with done_lock:
                stop = True
                done_lock.notify_all()
            try:
                while True:
                    todo.get_nowait()
            except queue.Empty:
                pass
            for _ in workers:
                todo.put(None)
            for t in workers:
                t.join(timeout=5.0)


def first_batch(loader: PrefetchLoader) -> Item:
    """Epoch 0's first batch of ``loader``, its workers shut down."""
    it = loader.epoch(0)
    try:
        return next(it)
    finally:
        it.close()


def to_device(batch: Item, device: Union[str, torch.device]
              ) -> Dict[str, torch.Tensor]:
    """Numpy batch -> tensors on ``device``. To a GPU the copy goes from
    pinned host memory with ``non_blocking=True``, so it overlaps work
    already queued on the card; PyTorch's pinned-memory allocator keeps
    the pinned source from reuse until the copy has run."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def device_prefetch(host_batches: Iterable[Item], put: Callable[[Item], Any],
                    depth: int = 2) -> Iterator[Any]:
    """Keep ``depth`` batches' copies in flight (``ParallelConfig.
    device_prefetch``): with the default 2, batch n+1's copy (``put``,
    :func:`to_device`'s non-blocking one) is issued before batch n is
    yielded, so before the step that consumes batch n runs and its
    outputs are read; ``depth <= 1`` copies each batch as it is
    consumed."""
    buf: "collections.deque" = collections.deque()
    for b in host_batches:
        buf.append(put(b))
        if len(buf) >= max(1, depth):
            yield buf.popleft()
    while buf:
        yield buf.popleft()
