"""Step and request times of the flagship model in a process of their own.

    python -m pvraft_tpu_torch.step_time [--path eager|graphed] [--seed S]
        [--refine] [--dtype float32|bfloat16] [--fused-gru] [--no-serve]
        [--steps_per_dispatch K] [--packed_state [--host_roundtrip]]
        [--remat_policy P] [--corr_chunk C] [--graph_chunk C] [--points N]
        [--telemetry]

On one CUDA device: the train step (B=2 x 8,192 points, 8 GRU
iterations, Adam; median of 6 after 2 warm-up steps), the eval step (one
8,192-point scene, 32 iterations; median of 3 after 1) and the serve
groups of ``profile_serve`` (one 8,192-point request, four of 4,096, one
of 2,048, 8 iterations; median of 5 after 2), each by the host clock
around one synchronised call, with no profiler attached. ``eager`` runs
``Trainer(graphs=False)`` (plain Adam, a float learning rate) and
``profile_serve.eager_predict_batch``; ``graphed`` runs the captured
steps and ``InferenceEngine.predict_batch``. ``--refine`` times stage 2
instead: the refine train and eval steps
(``flagship_train_config(refine=True)``: 32 backbone iterations without
autograd, the head trained; eval at 32) and ``ServeConfig(refine=True)``
(needs a checkout with stage 2). ``--dtype`` (default float32) sets the
model's compute dtype, the gradient dtype and the serving dtype
(``bfloat16`` needs a checkout with the bf16 slice); ``--fused-gru`` the
fused GRU update. One JSON line, with the peak device memory from the
trainer's construction to the end of its timed train steps (a graphed
step's captured pools included), the trainer's construction seconds
(its captures) and its programs' records (``compile_report``: capture
seconds, pool bytes). The train levers (``profile_train.lever_args``)
set the train and eval steps only; the serve groups run without them
(``--no-serve`` skips them): ``--steps_per_dispatch K`` times one call
of the K-step step on the batch stacked K times and reports ms per
step (the call's time / K), ``--packed_state`` the packed single step,
``--host_roundtrip`` it with the round trip, ``--remat_policy``,
``--corr_chunk``, ``--graph_chunk`` and ``--points`` the model levers
and the clouds' size, ``--telemetry`` the Trainer's monitors and
divergence detector (a timed call is ``Trainer.dispatch``'s: the
state's copy, the step with its monitors and the detector's host
read).

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
import dataclasses
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
    # Run by path from a checkout's root: import the package found there.
    sys.path.insert(0, os.getcwd())
    try:
        from pvraft_tpu_torch.profile_train import (
            lever_args,
            lever_config,
            step_call,
        )
    except ImportError:      # a checkout from before the train levers
        lever_args = lever_config = step_call = None
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("eager", "graphed"), default="graphed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--refine", action="store_true",
                    help="the stage-2 (refine) steps and requests")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="compute, gradient and serving dtype")
    ap.add_argument("--fused-gru", action="store_true")
    ap.add_argument("--no-serve", action="store_true",
                    help="time the train and eval steps only")
    if lever_args is not None:
        lever_args(ap)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
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

    stage = {"refine": True} if args.refine else {}
    model_kw = {"fused_gru": True} if args.fused_gru else {}
    if args.dtype != "float32":
        model_kw["compute_dtype"] = args.dtype
        stage["grad_dtype"] = args.dtype
    levers = lever_config(args) if lever_config is not None else {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(flagship_train_config(args.seed, **stage, **model_kw,
                                            **levers), **kw)
    build_s = time.perf_counter() - t0
    stage.pop("grad_dtype", None)
    batch = to_device(first_batch(PrefetchLoader(
        trainer.train_ds, 2, num_workers=0)), trainer.device)
    scene = to_device(first_batch(PrefetchLoader(
        trainer.val_ds, 1, num_workers=0)), trainer.device)
    call = (step_call(trainer, batch) if step_call is not None
            else lambda: trainer.train_step(batch))
    per_call = (trainer.steps_k if getattr(trainer, "multi_step", None)
                is not None else 1)
    train = [t / per_call for t in host_ms(call, 6, 2)]
    peak = torch.cuda.max_memory_allocated()
    evals = host_ms(lambda: trainer.eval_step(scene), 3, 1)
    programs = (trainer.compile_report()
                if hasattr(trainer, "compile_report") else [])
    cfg = trainer.cfg
    del trainer, batch, scene
    torch.cuda.empty_cache()
    train_line = {
        "gpu": nvidia_smi(), "path": "eager" if eager else "graphed",
        "refine": args.refine, "dtype": args.dtype,
        "fused_gru": args.fused_gru,
        "checkout_has_graphs": has_graphs,
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "levers": {k: v if not dataclasses.is_dataclass(v)
                   else dataclasses.asdict(v) for k, v in levers.items()},
        "points": cfg.data.max_points, "steps_per_call": per_call,
        "trainer_build_s": build_s,
        "train_step_ms": statistics.median(train),
        "train_peak_mem_bytes": peak,
        "eval_step_ms": statistics.median(evals),
        "programs": programs}
    if args.no_serve:
        print(json.dumps({**train_line,
                          "samples": {"train": train, "eval": evals}}),
              flush=True)
        return 0

    cfg = ServeConfig(ModelConfig(**model_kw), dtype=args.dtype, **stage)
    engine = InferenceEngine(seeded_state_dict(cfg.model, args.seed,
                                               **stage), cfg)
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
        **train_line,
        "serve_ms": {k: statistics.median(v) for k, v in serve.items()},
        "samples": {"train": train, "eval": evals, "serve": serve}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
