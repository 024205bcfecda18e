"""Step and request times of the flagship model in a process of their own.

    python -m pvraft_tpu_torch.step_time [--path eager|graphed] [--seed S]

On one CUDA device: the train step (B=2 x 8,192 points, 8 GRU
iterations, Adam; median of 6 after 2 warm-up steps), the eval step (one
8,192-point scene, 32 iterations; median of 3 after 1) and the serve
groups of ``profile_serve`` (one 8,192-point request, four of 4,096, one
of 2,048, 8 iterations; median of 5 after 2), each by the host clock
around one synchronised call, with no profiler attached. ``eager`` runs
``Trainer(graphs=False)`` (plain Adam, a float learning rate) and
``profile_serve.eager_predict_batch``; ``graphed`` runs the captured
steps and ``InferenceEngine.predict_batch``. One JSON line.

A fresh process is the yardstick for eager times: a long run such as
``chip_smoke.py`` reads its eager steps slower than this, by an amount
that changes from run to run (``PERF.md`` section 6), while its graphed
steps read the same.

The script uses only entry points that every slice of the port has
(``Trainer``, ``InferenceEngine``, ``flagship_train_config``), so it also
times an older checkout: run it by path from that checkout's root, and
it imports the package found there. A checkout without captured programs
runs eagerly whatever ``--path`` says, and the line says so.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import sys
import time


def host_ms(fn, reps: int, warmup: int) -> list:
    """Host-clock ms of ``reps`` synchronised calls after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("eager", "graphed"), default="graphed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # Run by path from a checkout's root: import the package found there.
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import batches, to_device
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.profile_serve import nvidia_smi
    from pvraft_tpu_torch.profile_train import flagship_train_config
    from pvraft_tpu_torch.serve import InferenceEngine, ServeConfig
    from pvraft_tpu_torch.weights import seeded_state_dict

    if not torch.cuda.is_available():
        print("step_time: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    has_graphs = "graphs" in inspect.signature(Trainer).parameters
    eager = args.path == "eager" or not has_graphs
    kw = {"graphs": not eager} if has_graphs else {}

    trainer = Trainer(flagship_train_config(args.seed), **kw)
    batch = to_device(next(batches(trainer.train_ds, 2)), trainer.device)
    scene = to_device(next(batches(trainer.val_ds, 1)), trainer.device)
    train = host_ms(lambda: trainer.train_step(batch), 6, 2)
    evals = host_ms(lambda: trainer.eval_step(scene), 3, 1)
    del trainer, batch, scene
    torch.cuda.empty_cache()

    cfg = ServeConfig(ModelConfig())
    engine = InferenceEngine(seeded_state_dict(cfg.model, args.seed), cfg)
    run = InferenceEngine.predict_batch
    if eager and has_graphs:
        from pvraft_tpu_torch.profile_serve import eager_predict_batch

        run = eager_predict_batch
    rng = np.random.default_rng(args.seed + 1)

    def cloud(n):
        return rng.uniform(-2, 2, (n, 3)).astype(np.float32)

    serve = {}
    for b, n in ((1, 8192), (4, 4096), (1, 2048)):
        group = [(cloud(n), cloud(n)) for _ in range(b)]
        serve[f"{b}x{n}"] = host_ms(lambda: run(engine, group, n), 5, 2)
    print(json.dumps({
        "gpu": nvidia_smi(), "path": "eager" if eager else "graphed",
        "checkout_has_graphs": has_graphs,
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "train_step_ms": statistics.median(train),
        "eval_step_ms": statistics.median(evals),
        "serve_ms": {k: statistics.median(v) for k, v in serve.items()},
        "samples": {"train": train, "eval": evals, "serve": serve}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
