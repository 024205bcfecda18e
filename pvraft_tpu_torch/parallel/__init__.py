"""Data and sequence parallelism over ``torch.distributed`` (port of
``pvraft_tpu/parallel/``): :mod:`.distributed` joins the processes,
:mod:`.mesh` lays the ranks out as a ``(data, seq)`` mesh and holds the
batch contract, :mod:`.collectives` holds the seq axis's differentiable
collectives and :mod:`.ring` the sequence-parallel kNN and correlation
rings."""

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
    seq_rows,
    seq_shard_batch,
)

__all__ = ["Mesh", "batch_contract", "eval_scene_shard", "initialize",
           "is_initialized", "make_mesh", "process_count", "process_index",
           "replicate", "seq_rows", "seq_shard_batch", "shutdown"]
