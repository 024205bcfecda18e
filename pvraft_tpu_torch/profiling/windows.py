"""How whole the port's ``torch.profiler`` windows are.

    python -m pvraft_tpu_torch.profiling.windows [--loops 25] [--seed 0]
        [--out FILE]

The serve requests of two flagship engines (float32, ``fused_gru`` off
and on; one request at 8,192 points, a group of four at 4,096 and one
at 2,048) run ``--loops`` times, each request in turns in a bare window
(opened just before the call, closed after a synchronize) and in a
window of ``ops/cuda.device_kernels`` (head marker kernels before the
call, a tail marker after it). A replay runs the same device activities every
time, so every window of one request should see as many; a shorter
window lost records, and :func:`lost_at` says where in the sequence.
Prints one JSON object: per window kind and request, the activity counts
seen and how often, the short windows and where they lost records, and
the windows ``device_kernels`` ran again. Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def lost_at(full: Sequence[str], seen: Sequence[str]) -> str:
    """Where ``seen`` (activity names in start order) lacks what ``full``
    has: "whole", "head", "tail" or "middle"."""
    n = len(seen)
    if n == len(full) and list(seen) == list(full):
        return "whole"
    if list(seen) == list(full[len(full) - n:]):
        return "head"
    if list(seen) == list(full[:n]):
        return "tail"
    return "middle"


def bare_window(fn: Callable[[], object]) -> List[str]:
    """The device activities of ``fn()`` in start order, in a profiler
    window opened just before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)]


def scene(rng: np.random.Generator, n1: int, n2: int):
    """A request: pc1 in a 4 m box, pc2 a rigid motion of it plus noise,
    resampled to n2 points."""
    pc1 = rng.uniform(-2, 2, (n1, 3)).astype(np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    moved = pc1 @ rot.T + np.array([0.1, -0.05, 0.02], np.float32)
    idx = rng.choice(n1, n2, replace=n2 > n1)
    return pc1, (moved[idx] + rng.normal(0, 0.01, (n2, 3))).astype(np.float32)


def summary(runs: Dict[str, List[List[str]]]) -> Dict[str, dict]:
    """Per request: activity counts seen (count -> windows), the short
    windows and where they lost records."""
    out = {}
    for key, seqs in runs.items():
        full = max(seqs, key=len)
        where = collections.Counter(lost_at(full, s) for s in seqs)
        out[key] = {"lengths": dict(collections.Counter(map(len, seqs))),
                    "short": sum(len(s) < len(full) for s in seqs),
                    "lost_at": dict(where)}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pvraft_tpu_torch.profiling.windows",
        description=__doc__.split("\n\n")[2])
    parser.add_argument("--loops", type=int, default=25)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.device import resolve_device
    from pvraft_tpu_torch.ops import cuda as kernels
    from pvraft_tpu_torch.profile_serve import nvidia_smi
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    dev = resolve_device(None)
    state = seeded_state_dict(ModelConfig(), args.seed)
    # graftlint: disable-next=GD002 -- profile inputs of recorded runs
    rng = np.random.default_rng(args.seed + 1)
    requests = [(8192, [scene(rng, 8192, 8192)]),
                (4096, [scene(rng, int(rng.integers(3000, 4097)),
                              int(rng.integers(3000, 4097)))
                        for _ in range(4)]),
                (2048, [scene(rng, 2048, 2048)])]
    bare, framed = collections.defaultdict(list), collections.defaultdict(list)
    kernels.window_counts.clear()
    t0 = time.perf_counter()
    for fused in (False, True):
        engine = InferenceEngine(
            state, ServeConfig(ModelConfig(fused_gru=fused),
                               dtype="float32"), device=dev)
        for bucket, group in requests:
            engine.predict_batch(group, bucket)
        for _ in range(args.loops):
            for bucket, group in requests:
                key = f"{'fused' if fused else 'unfused'}_gru_{bucket}"
                run = lambda: engine.predict_batch(group, bucket)  # noqa: E731
                bare[key].append(bare_window(run))
                framed[key].append(kernels.device_kernels(run)[1])
        del engine
        torch.cuda.empty_cache()
    record = {"device": nvidia_smi(), "loops": args.loops,
              "bare": summary(bare), "device_kernels": summary(framed),
              "device_kernels_windows": dict(kernels.window_counts),
              "seconds": time.perf_counter() - t0}
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
