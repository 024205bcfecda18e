"""Multi-process start-up (port of ``pvraft_tpu/parallel/distributed.py``).

The JAX package joins a pod with ``jax.distributed.initialize`` and lets
XLA route the collectives. The port runs one process per card, as
``torchrun`` launches it, and joins them into one
``torch.distributed`` process group::

    torchrun --nproc_per_node=N -m pvraft_tpu_torch.train ...

:func:`initialize` reads ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or takes
the address, the process count and the rank from its caller. The
backend is NCCL on the card and gloo on the CPU, unless the caller names
one: gloo on the card only when it is asked for by name (its collectives
cannot be captured in a CUDA graph, so the Trainer refuses graphs with
it), never as a substitute after NCCL fails.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (the JAX ``process_index``): 0 without a
    process group."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The processes of the group (the JAX ``process_count``): 1 without a
    process group."""
    return dist.get_world_size() if is_initialized() else 1


def default_backend() -> str:
    """NCCL where a card is present, else gloo."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def _init_method(address: str) -> str:
    """``host:port`` as a TCP rendezvous; a URL (``tcp://``, ``file://``)
    as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               local_rank: Optional[int] = None) -> bool:
    """Join this process into the process group (idempotent). Returns
    True when the group is (already) there, False when the run is one
    process: no arguments and an environment that names no
    multi-process run (``WORLD_SIZE`` unset or 1), as the JAX function
    returns False on one host.

    With no arguments it reads ``torchrun``'s environment
    (``MASTER_ADDR``/``MASTER_PORT`` through ``env://``). Given
    ``num_processes`` and ``process_id``, it meets the others at
    ``coordinator_address`` (``host:port``, or a ``tcp://``/``file://``
    URL), at any world size, 1 included. Where a card is present the
    process binds ``cuda:<local_rank>`` (default ``LOCAL_RANK``, else the
    rank), and raises if this host has no such card."""
    if is_initialized():
        return True
    env = os.environ
    if num_processes is None and coordinator_address is None:
        if int(env.get("WORLD_SIZE", "1")) <= 1:
            return False
        init_method = "env://"
        world = int(env["WORLD_SIZE"])
        rank = int(env["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: num_processes and process_id go "
                             "with coordinator_address")
        if coordinator_address is None:
            coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                                   f"{env['MASTER_PORT']}")
        init_method = _init_method(coordinator_address)
        world, rank = int(num_processes), int(process_id)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    backend = backend or default_backend()
    if torch.cuda.is_available():
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"process {rank}: local rank {local_rank} has no card (this "
                f"host has {torch.cuda.device_count()})")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return True


def shutdown() -> None:
    """Leave the process group, where there is one."""
    if is_initialized():
        dist.destroy_process_group()
