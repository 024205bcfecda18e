"""Micro-benchmarks of the hot ops of the port (counterpart of
``scripts/kernel_bench.py``'s lookup, corr_init and graph rows).

    python -m pvraft_tpu_torch.kernel_bench [--points 8192] [--k 512]
        [--batch 2] [--device cpu]

Times each row on the card with CUDA events (median of 20 calls after
warm-up); with ``--device cpu`` on the host clock, and the lines say so.
Inputs are seeded. Rows:

  * ``lookup plain``: the per-iteration lookup in plain PyTorch
    (``rel`` materialized, voxel means, kNN);
  * ``lookup voxel-kernel``: the voxel kernel (``csrc/voxel_corr.cu``)
    plus the plain kNN, the JAX bench's "pallas-vox" row;
  * ``lookup fused``: the fused lookup kernel (``csrc/corr_lookup.cu``);
  * ``corr_init dense``: the all-pairs product and top-k truncation;
  * ``knn graph dense``: the 32-NN graph of a cloud.

The chunked and approximate rows of the JAX bench belong to slices not
ported yet; their lines say so. Runs on the card unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from pvraft_tpu_torch.device import resolve_device
from pvraft_tpu_torch.ops.corr import CorrState, corr_init, knn_lookup
from pvraft_tpu_torch.ops.cuda.corr_lookup import fused_corr_lookup
from pvraft_tpu_torch.ops.cuda.voxel_corr import voxel_bin_means_pallas
from pvraft_tpu_torch.ops.geometry import knn_indices
from pvraft_tpu_torch.ops.voxel import voxel_bin_means

LEVELS, BASE_SCALE, RESOLUTION, KNN, FEATURE_DIM = 3, 0.25, 3, 32, 128
REPS = 20
NOT_PORTED = {
    "corr_init chunked": "the streaming correlation slice",
    "corr_init approx": "the approximate top-k slice",
    "knn graph chunked": "the streaming graph slice",
}


def time_ms(fn: Callable[[], object], device: torch.device) -> float:
    """Median time of ``fn()`` over REPS calls after 3 warm-up calls, in
    ms: CUDA events on a GPU, the host clock elsewhere."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def device_ms(fn: Callable[[], object], reps: int = 25) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls captured in one
    CUDA graph, the median of 5 replays divided by ``reps``. Unlike CUDA
    events around one call, no host time (argument checks,
    allocations, the ctypes call) lies between the events, so a kernel
    shorter than its wrapper's host time is still timed as the card runs
    it. Inputs read again from launch to launch stay in the 50 MB L2
    where they fit (below 1 x 8192 at K=512). Needs a CUDA device; ``fn``
    must not synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def lookup_plain(st: CorrState, coords: torch.Tensor):
    rel = st.xyz - coords[:, :, None, :]
    vox = voxel_bin_means(st.corr, rel, LEVELS, BASE_SCALE, RESOLUTION)
    return (vox, *knn_lookup(st, rel, KNN))


def lookup_voxel_kernel(st: CorrState, coords: torch.Tensor):
    rel = st.xyz - coords[:, :, None, :]
    vox = voxel_bin_means_pallas(st.corr, rel, LEVELS, BASE_SCALE, RESOLUTION)
    return (vox, *knn_lookup(st, rel, KNN))


def lookup_fused(st: CorrState, coords: torch.Tensor):
    return fused_corr_lookup(st.corr, st.xyz, coords, LEVELS, BASE_SCALE,
                             RESOLUTION, KNN)[:3]


def bench(points: int = 8192, k: int = 512, batch: int = 2,
          device=None) -> List[Dict[str, object]]:
    """One row per variant: ``{"name", "ms", "timer"}``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def put(*shape, uniform=False):
        a = (rng.uniform(-1, 1, shape) if uniform
             else rng.normal(size=shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    b, n = batch, points
    f1, f2 = put(b, n, FEATURE_DIM), put(b, n, FEATURE_DIM)
    x2, coords = put(b, n, 3, uniform=True), put(b, n, 3, uniform=True)
    timer = "cuda events" if dev.type == "cuda" else "host clock"
    with torch.inference_mode():
        state = corr_init(f1, f2, x2, k)
        rows = [("lookup plain", lambda: lookup_plain(state, coords)),
                ("lookup voxel-kernel",
                 lambda: lookup_voxel_kernel(state, coords)),
                ("lookup fused", lambda: lookup_fused(state, coords)),
                ("corr_init dense", lambda: corr_init(f1, f2, x2, k)),
                ("knn graph dense", lambda: knn_indices(x2, x2, KNN))]
        return [{"name": name, "ms": time_ms(fn, dev), "timer": timer}
                for name, fn in rows]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--k", type=int, default=512)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without one)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device={dev} ({name}) batch={a.batch} points={a.points} k={a.k}")
    for row in bench(a.points, a.k, a.batch, dev):
        print(f"{row['name']:<20}{row['ms']:10.4f} ms  ({row['timer']})")
    for row, where in NOT_PORTED.items():
        print(f"{row:<20}  not ported: arrives with {where}")


if __name__ == "__main__":
    main()
