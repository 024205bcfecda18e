"""Where the serve path's time goes on the card.

    python -m pvraft_tpu_torch.profile_serve [--seed S] [--fused-gru]
        [--dtype float32|bfloat16] [--truncate_k K] [--corr_knn KNN]
        [--hidden_dim H --context_dim C]

Serves the flagship ``ModelConfig`` (seeded random weights, 8 GRU
iterations; ``--truncate_k`` and ``--corr_knn``, the serve CLIs' flags,
and ``--hidden_dim`` and ``--context_dim``, ``ModelConfig``'s widths,
default to its 512, 32, 64 and 64, and every row names them: 1024 / 64 runs the general lookup kernel,
hidden 32 / context 96 with ``--fused-gru`` the general GRU kernel; the
two widths sum to the context encoder's 128) on one CUDA device: one 8,192-point request, a batch of four
4,096-point requests, one 2,048-point request, each two ways: ``eager``,
the forward run op by op on the padded inputs (:func:`eager_predict_batch`,
the engine's path before it captured its programs), and ``graphed``,
``InferenceEngine.predict_batch`` replaying the captured program. Each
runs once to warm up, then once under ``torch.profiler`` (CPU and CUDA
activity). One JSON line per group and path gives the wall time, the
device-busy time (union of the kernel intervals), the idle share, the
kernel count, the device-busy time within each model stage (the
``pvraft.*`` ranges of ``models/raft.py``; a replay has none) and the
kernels with the most device time, and names the serving dtype
(``--dtype``, the ``ServeConfig`` default bfloat16 unless it says
otherwise). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.profiling.timers import PROFILER_LEAD_S
from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
from pvraft_tpu_torch.weights import seeded_state_dict


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _clipped_busy_us(kernels, lo: float, hi: float) -> float:
    return _busy_us((max(s, lo), min(e, hi)) for s, e in kernels
                    if e > lo and s < hi)


RANGE_PREFIXES = ("pvraft.", "phase.")


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def profile_call(fn, top: int) -> dict:
    """Run ``fn()`` once under ``torch.profiler``: wall time, device-busy
    time, idle share, kernel count, device-busy time within each
    ``pvraft.*`` range and the ``top`` kernels by device time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_LEAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    # Ranges (the pvraft.* and phase.* ones, the optimizer's own
    # "Optimizer.step#..." range) also appear on the device timeline,
    # spanning the kernels they enclose; they are not kernels.
    ranges = [e for e in device if e.name.startswith("pvraft.")]
    kernels = [e for e in device if not e.name.startswith(RANGE_PREFIXES)
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = _busy_us(spans)
    stages: dict = {}
    for r in ranges:
        stages[r.name] = stages.get(r.name, 0.0) + _clipped_busy_us(
            spans, r.time_range.start, r.time_range.end) / 1e3
    # phase.* ranges are host-side ranges that end in a synchronize (see
    # profile_train.py): every kernel launched inside one also ran inside
    # it, whichever thread launched it.
    phases: dict = {}
    for r in events:
        if r.device_type == DeviceType.CPU and r.name.startswith("phase."):
            phases[r.name] = phases.get(r.name, 0.0) + _clipped_busy_us(
                spans, r.time_range.start, r.time_range.end) / 1e3
    by_name: dict = {}
    for e in kernels:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.end - e.time_range.start)
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    return {
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / wall_us, "kernels": len(kernels),
        "stage_busy_ms": stages,
        **({"phase_busy_ms": phases} if phases else {}),
        "top_kernels": [{"name": name[:100], "calls": calls,
                         "device_ms": us / 1e3}
                        for name, (calls, us) in ranked[:top]],
    }


def eager_predict_batch(engine: InferenceEngine, requests, bucket: int):
    """``engine.predict_batch`` without its captured program: the same
    padding, copies and forward, run op by op on ``engine.model``."""
    inputs = engine.padded_batch(requests, bucket)
    x1, x2, v1, v2 = (torch.from_numpy(a).to(engine.device) for a in inputs)
    with torch.no_grad():
        out = engine.model(x1, x2, engine.cfg.num_iters, v1, v2)
    flow = (out if engine.cfg.refine else out[0][-1]).cpu().numpy()
    return [flow[i, : requests[i][0].shape[0]] for i in range(len(requests))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused-gru", action="store_true")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default=ServeConfig().dtype, help="serving dtype")
    ap.add_argument("--truncate_k", type=int,
                    default=ModelConfig.truncate_k)
    ap.add_argument("--corr_knn", type=int, default=ModelConfig.corr_knn)
    ap.add_argument("--hidden_dim", type=int,
                    default=ModelConfig.hidden_dim)
    ap.add_argument("--context_dim", type=int,
                    default=ModelConfig.context_dim)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ServeConfig(ModelConfig(fused_gru=args.fused_gru,
                                  truncate_k=args.truncate_k,
                                  corr_knn=args.corr_knn,
                                  hidden_dim=args.hidden_dim,
                                  context_dim=args.context_dim),
                      dtype=args.dtype)
    engine = InferenceEngine(seeded_state_dict(cfg.model, args.seed), cfg)
    rng = np.random.default_rng(args.seed + 1)

    def cloud(n):
        return rng.uniform(-2, 2, (n, 3)).astype(np.float32)

    groups = [([(cloud(8192), cloud(8192))], 8192),
              ([(cloud(4096), cloud(4096)) for _ in range(4)], 4096),
              ([(cloud(2048), cloud(2048))], 2048)]
    gpu = nvidia_smi()
    for group, bucket in groups:
        for path, run in (("eager", eager_predict_batch),
                          ("graphed", InferenceEngine.predict_batch)):
            run(engine, group, bucket)                # warm-up
            torch.cuda.synchronize()
            row = profile_call(lambda: run(engine, group, bucket), args.top)
            print(json.dumps({"gpu": gpu, "dtype": args.dtype,
                              "fused_gru": args.fused_gru,
                              "truncate_k": args.truncate_k,
                              "corr_knn": args.corr_knn,
                              "hidden_dim": args.hidden_dim,
                              "context_dim": args.context_dim,
                              "path": path, "bucket": bucket,
                              "requests": len(group), **row}), flush=True)
    print(json.dumps({"gpu": gpu, "programs": engine.compile_report()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
