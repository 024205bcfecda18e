"""Program geometry data of the port: the shapes the catalog declares its
programs at (the port's counterpart of ``pvraft_tpu/programs/
geometries.py``, without its TPU topology and chip memory).

The serve table's buckets, batch sizes, iterations and dtypes are the
engine's own constants (``serve/engine.py``, ``serve/aot.py``), which the
catalog imports, not written twice. "tiny" is each program at a few
points, for the CPU tests: the same code, every width kept.
"""

from __future__ import annotations

from pvraft_tpu_torch.serve.engine import (
    SERVE_BF16_EPE_BOUND,
    SERVE_BF16_REL_EPE_BOUND,
    SERVE_DEFAULT_BATCH_SIZES,
    SERVE_DEFAULT_BUCKETS,
)

# --- flagship training geometry (the reference run.sh configuration) -------

FLAGSHIP_BATCH = 2
FLAGSHIP_POINTS = 8192
FLAGSHIP_ITERS = 8
FLAGSHIP_EVAL_ITERS = 32
FLAGSHIP_REFINE_ITERS = 32
FLAGSHIP_TRUNCATE_K = 512

# --- the kernels' rows of PERF.md §6 ---------------------------------------

# B x N of every kernel spec.
KERNEL_SHAPE = (1, 8192)
# Off the flagship (chip_smoke.py phase 6): the general lookup and voxel
# pass at truncate_k 1024 / corr_knn 64 (resolution 3, 3 levels), the
# general GRU at hidden 32 / context 96 (correlation features 64).
GENERAL_LOOKUP = {"k": 1024, "knn": 64, "resolution": 3, "levels": 3}
GENERAL_GRU = {"hidden": 32, "context": 96, "corr": 64}

# --- the fleet router (fleet/) --------------------------------------------

# The JAX package's FLEET_DEFAULTS. A backend that misses `degraded_after`
# consecutive /healthz polls is degraded (still routed to); at
# `quarantine_after` it leaves the rotation until a probe poll succeeds.
# `retry_after_s` is the Retry-After of a request every backend shed;
# `predict_timeout_s` one forward's budget. The canary gate routes
# `canary_fraction` of the traffic to the new weights and renders its
# verdict after `canary_min_samples` comparisons, against the bf16
# serving bounds: a weight swap that moves the flows more than the
# precision change does is not promoted.
FLEET_DEFAULTS = {
    "poll_interval_s": 0.5,
    "poll_timeout_s": 5.0,
    "degraded_after": 1,
    "quarantine_after": 3,
    "retry_after_s": 1,
    "predict_timeout_s": 60.0,
    "canary_fraction": 0.25,
    "canary_min_samples": 8,
    "canary_epe_bound": SERVE_BF16_EPE_BOUND,
    "canary_rel_epe_bound": SERVE_BF16_REL_EPE_BOUND,
}

# --- "tiny": the CPU tests' size --------------------------------------------

TINY_POINTS = 64
TINY_ITERS = 2
TINY_MODEL = {"truncate_k": 16, "corr_knn": 8, "graph_k": 8}
# A serve bucket at "tiny" is the bucket over this (2048 -> 32 points).
TINY_BUCKET_DIVISOR = 64


def serve_program_keys(buckets=SERVE_DEFAULT_BUCKETS,
                       batch_sizes=SERVE_DEFAULT_BATCH_SIZES):
    """The (bucket, batch size) table a serve config captures, in the
    engine's order."""
    for bucket in buckets:
        for bs in batch_sizes:
            yield bucket, bs
