"""Data parallelism over ``torch.distributed`` (port of
``pvraft_tpu/parallel/``): :mod:`.distributed` joins the processes,
:mod:`.mesh` lays the ranks out and holds the batch contract. The
sequence-parallel ring (``pvraft_tpu/parallel/ring.py``) is ROADMAP
queue 1 item 8b."""

from pvraft_tpu_torch.parallel.distributed import (
    initialize,
    is_initialized,
    process_count,
    process_index,
    shutdown,
)
from pvraft_tpu_torch.parallel.mesh import (
    Mesh,
    batch_contract,
    eval_scene_shard,
    make_mesh,
    replicate,
)

__all__ = ["Mesh", "batch_contract", "eval_scene_shard", "initialize",
           "is_initialized", "make_mesh", "process_count", "process_index",
           "replicate", "shutdown"]
