"""Micro-benchmarks of the hot ops of the port (counterpart of
``scripts/kernel_bench.py``'s lookup, corr_init and graph rows).

    python -m pvraft_tpu_torch.kernel_bench [--points 8192] [--k 512]
        [--batch 2] [--dtype float32|bfloat16] [--device cpu]

Times each row on the card with CUDA events (median of 20 calls after
warm-up); with ``--device cpu`` on the host clock, and the lines say so.
Inputs are seeded. Rows:

  * ``lookup plain``: the per-iteration lookup in plain PyTorch
    (``rel`` materialized, voxel means, kNN);
  * ``lookup voxel-kernel``: the voxel kernel (``csrc/voxel_corr.cu``)
    plus the plain kNN, the JAX bench's "pallas-vox" row;
  * ``lookup fused``: the fused lookup kernel (``csrc/corr_lookup.cu``);
  * ``corr_init dense``: the all-pairs product and top-k truncation;
  * ``corr_init chunked``: the same streamed over chunks of
    ``max(k, points // 8)`` candidates (``corr_chunk``);
  * ``corr_init approx``: ``approx_topk``, the exact top-k in the port;
  * ``knn graph dense``: the 32-NN graph of a cloud;
  * ``knn graph chunked``: the same streamed over chunks of
    ``max(512, points // 8)`` points (``graph_chunk``);
  * ``gru fused``: the fused GRU update at width 64 and ``--dtype``
    (``csrc/gru_iter.cu`` at float32, ``csrc/gru_iter_bf16.cu`` at
    bfloat16).

The lookup and correlation rows are float32 at either dtype: a bfloat16
model's encoders return float32 features (their GroupNorms promote), so
its correlation cache and lookup are float32 too.

The rows are those of the JAX package's ``scripts/kernel_bench.py``, at
its chunk sizes. Runs on the card unless ``--device`` names another
device.
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
from pvraft_tpu_torch.ops.cuda.gru_iter import (
    FLOW_PAD,
    WIDTH,
    fused_gru_update,
)
from pvraft_tpu_torch.ops.cuda.voxel_corr import voxel_bin_means_pallas
from pvraft_tpu_torch.ops.geometry import knn_indices
from pvraft_tpu_torch.ops.voxel import voxel_bin_means

LEVELS, BASE_SCALE, RESOLUTION, KNN, FEATURE_DIM = 3, 0.25, 3, 32, 128
REPS = 20


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
          device=None, dtype: str = "float32") -> List[Dict[str, object]]:
    """One row per variant: ``{"name", "ms", "timer", "dtype"}``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def put(*shape, uniform=False):
        a = (rng.uniform(-1, 1, shape) if uniform
             else rng.normal(size=shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    b, n = batch, points
    f1, f2 = put(b, n, FEATURE_DIM), put(b, n, FEATURE_DIM)
    x2, coords = put(b, n, 3, uniform=True), put(b, n, 3, uniform=True)
    gru_dtype = getattr(torch, dtype)
    gru_weights = tuple(0.15 * put(*s) for s in
                        [(WIDTH, WIDTH), (FLOW_PAD, WIDTH), (2 * WIDTH, WIDTH)]
                        + [(WIDTH, 3 * WIDTH)] * 3 + [(FLOW_PAD, 3 * WIDTH)] * 2)
    gru_args = (torch.tanh(put(b, n, WIDTH)), torch.relu(put(b, n, WIDTH)),
                put(b, n, WIDTH).to(gru_dtype), 0.3 * put(b, n, FLOW_PAD),
                gru_weights, gru_dtype)
    timer = "cuda events" if dev.type == "cuda" else "host clock"
    with torch.inference_mode():
        state = corr_init(f1, f2, x2, k)
        rows = [("lookup plain", lambda: lookup_plain(state, coords)),
                ("lookup voxel-kernel",
                 lambda: lookup_voxel_kernel(state, coords)),
                ("lookup fused", lambda: lookup_fused(state, coords)),
                ("corr_init dense", lambda: corr_init(f1, f2, x2, k)),
                ("corr_init chunked", lambda: corr_init(
                    f1, f2, x2, k, chunk=max(k, n // 8))),
                ("corr_init approx", lambda: corr_init(f1, f2, x2, k,
                                                       approx=True)),
                ("knn graph dense", lambda: knn_indices(x2, x2, KNN)),
                ("knn graph chunked", lambda: knn_indices(
                    x2, x2, KNN, chunk=max(512, n // 8))),
                ("gru fused", lambda: fused_gru_update(*gru_args))]
        return [{"name": name, "ms": time_ms(fn, dev), "timer": timer,
                 "dtype": dtype if name == "gru fused" else "float32"}
                for name, fn in rows]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--points", type=int, default=8192)
    p.add_argument("--k", type=int, default=512)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="compute dtype of the gru fused row")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without one)")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device={dev} ({name}) batch={a.batch} points={a.points} k={a.k} "
          f"dtype={a.dtype}")
    for row in bench(a.points, a.k, a.batch, dev, a.dtype):
        print(f"{row['name']:<20}{row['ms']:10.4f} ms  ({row['timer']})  "
              f"{row['dtype']}")


if __name__ == "__main__":
    main()
