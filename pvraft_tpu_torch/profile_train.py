"""Where a train step's time goes on the card.

    python -m pvraft_tpu_torch.profile_train [--seed S] [--fused-gru]
        [--no-use_pallas] [--refine] [--dtype float32|bfloat16] [--top 12]
        [--steps_per_dispatch K] [--packed_state [--host_roundtrip]]
        [--remat_policy P] [--corr_chunk C] [--graph_chunk C] [--points N]
        [--telemetry]

Trains the flagship ``ModelConfig`` at the ``TrainConfig`` defaults
(B=2 scenes of 8,192 points, 8 GRU iterations, fp32, Adam) on seeded
FT3D-like synthetic scenes, on one CUDA device, two ways: ``eager``
(``Trainer(graphs=False)``: the step op by op, with a plain Adam at a
float learning rate) and ``graphed`` (the
captured train step that ``Trainer`` runs by default). Each: two warm-up
steps, then one step under ``torch.profiler``. One JSON line per way
gives the wall time, device-busy time, idle share, kernel count, the
device-busy time within the model's ``pvraft.*`` stage ranges (a replay
has none) and the kernels with the most device time. The eager line
also gives, from the same step's work with a synchronize after each
phase, the device-busy time of its forward, backward and optimizer
phases (the autograd engine launches the backward from its own thread,
which the device-side ranges of the unsynchronised step do not cover;
inside one graph the phases cannot be told apart). The graphed line
gives its programs' capture records. ``--refine`` profiles the stage-2
step instead (``flagship_train_config(refine=True)``: a PVRaftRefine, 32
backbone iterations without autograd, the head's forward, backward and
Adam). ``--dtype bfloat16`` trains the bf16 model with bf16 gradients
(``compute_dtype`` and ``grad_dtype``; default float32), and every line
names the dtype. The levers (``lever_args``): ``--steps_per_dispatch K``
profiles one call of the K-step step (K steps: its busy time is K
steps'), ``--packed_state`` and ``--host_roundtrip`` the packed single
step, ``--remat_policy``, ``--corr_chunk`` and ``--graph_chunk`` the
model levers, ``--points`` the clouds' size; ``--telemetry`` profiles
the armed call (``Trainer.dispatch``: the state's copy, the step with
its monitors, the detector's host read). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Any, Callable, Dict, Optional

import torch
from torch.profiler import record_function

from pvraft_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)
from pvraft_tpu_torch.data import PrefetchLoader, first_batch, to_device
from pvraft_tpu_torch.device import set_tf32
from pvraft_tpu_torch.engine.steps import (
    refine_loss_of,
    scheduled_step,
    sequence_loss_of,
    stack_batches,
)
from pvraft_tpu_torch.engine.trainer import Trainer
from pvraft_tpu_torch.profile_serve import nvidia_smi, profile_call


def flagship_train_config(seed: int = 0, epochs: int = 1,
                          refine: bool = False, grad_dtype: str = "float32",
                          points: int = 8192, scenes: int = 4,
                          parallel: Optional[ParallelConfig] = None,
                          telemetry: bool = False, **model_kw) -> Config:
    """The flagship ModelConfig and the TrainConfig defaults (B=2,
    8 iterations, eval at 32) on ``scenes`` (4) seeded FT3D-like
    synthetic scenes of ``points`` (8,192) points (4 independently moving
    objects each). ``refine``: the canonical stage-2 run's (``--refine
    --iters 32``; it evaluates at 32 too). ``parallel``: the K-step
    levers (default: none). ``telemetry``: the monitors and the
    divergence detector."""
    return Config(model=ModelConfig(**model_kw),
                  data=DataConfig(dataset="synthetic", synthetic_size=scenes,
                                  synthetic_objects=4, max_points=points),
                  train=TrainConfig(num_epochs=epochs, seed=seed,
                                    refine=refine, grad_dtype=grad_dtype,
                                    iters=32 if refine else 8,
                                    telemetry=telemetry),
                  parallel=parallel or ParallelConfig())


def lever_args(ap: argparse.ArgumentParser) -> None:
    """The train levers that ``profile_train`` and ``step_time`` take."""
    ap.add_argument("--steps_per_dispatch", type=int, default=1,
                    help="K > 1: the K-step train step (packed state); "
                         "times are per step")
    ap.add_argument("--packed_state", action="store_true",
                    help="the packed single step (implied by K > 1)")
    ap.add_argument("--host_roundtrip", action="store_true",
                    help="with --packed_state: the flat buffer to host "
                         "memory and back before each step")
    ap.add_argument("--remat_policy", default="none",
                    help="none|full|dots|dots_no_batch|save_corr")
    ap.add_argument("--corr_chunk", type=int, default=None)
    ap.add_argument("--graph_chunk", type=int, default=None)
    ap.add_argument("--points", type=int, default=8192,
                    help="points per cloud of the train and eval steps")
    ap.add_argument("--telemetry", action="store_true",
                    help="arm the monitors and the divergence detector: a "
                         "call is Trainer.dispatch's, the state's copy, "
                         "the step with its monitors, one host read")


def lever_config(args: argparse.Namespace) -> Dict[str, Any]:
    """``flagship_train_config`` keywords for :func:`lever_args`' flags,
    only those set (so that an older checkout, which lacks them, runs
    with the defaults)."""
    kw: Dict[str, Any] = {}
    k = args.steps_per_dispatch
    if k > 1 or args.packed_state or args.host_roundtrip:
        kw["parallel"] = ParallelConfig(packed_state=True,
                                        steps_per_dispatch=k,
                                        host_roundtrip=args.host_roundtrip)
    if args.remat_policy != "none":
        kw["remat_policy"] = args.remat_policy
    for name in ("corr_chunk", "graph_chunk"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    if args.points != 8192:
        kw["points"] = args.points
    if args.telemetry:
        kw["telemetry"] = True
    return kw


def step_call(trainer: Trainer, batch) -> Callable[[], Any]:
    """One call of the trainer's train step on ``batch`` as an epoch
    makes it (``Trainer.dispatch``: with ``train.telemetry`` the state's
    copy and the detector's host read too): the K-step step on ``batch``
    stacked K times where the trainer has one."""
    if trainer.multi_step is None:
        return lambda: trainer.dispatch(trainer.train_step, batch)
    stacked = stack_batches([batch] * trainer.steps_k)
    return lambda: trainer.dispatch(trainer.multi_step, stacked)


def phased_step(trainer: Trainer, batch) -> None:
    """The train step's work (``make_train_step``) with a synchronize at
    the end of each ``phase.*`` range."""
    cfg = trainer.cfg.train
    trainer.optimizer.zero_grad(set_to_none=True)
    with record_function("phase.forward"):
        if cfg.refine:
            loss, _ = refine_loss_of(trainer.model, batch, cfg.iters)
        else:
            loss, _ = sequence_loss_of(trainer.model, batch, cfg.gamma,
                                       cfg.iters)
        torch.cuda.synchronize()
    with record_function("phase.backward"):
        loss.backward()
        torch.cuda.synchronize()
    with record_function("phase.optimizer"):
        scheduled_step(trainer.optimizer, trainer.schedule)
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused-gru", action="store_true")
    ap.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                    default=None)
    ap.add_argument("--refine", action="store_true",
                    help="the stage-2 (refine) step")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="compute and gradient dtype")
    ap.add_argument("--top", type=int, default=12)
    lever_args(ap)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    set_tf32(False)
    cfg = flagship_train_config(args.seed, refine=args.refine,
                                grad_dtype=args.dtype,
                                fused_gru=args.fused_gru,
                                use_pallas=args.use_pallas,
                                compute_dtype=args.dtype,
                                **lever_config(args))
    gpu = nvidia_smi()
    for path in ("eager", "graphed"):
        trainer = Trainer(cfg, graphs=path == "graphed")
        batch = to_device(first_batch(PrefetchLoader(
            trainer.train_ds, 2, num_workers=0)), trainer.device)
        call = step_call(trainer, batch)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row = profile_call(call, args.top)
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        if path == "eager":
            phased = profile_call(lambda: phased_step(trainer, batch),
                                  args.top)
            row["phase_busy_ms"] = phased["phase_busy_ms"]
            row["phased_top_kernels"] = phased["top_kernels"]
        else:
            row["programs"] = trainer.compile_report()
            row["reserved_bytes"] = torch.cuda.memory_reserved()
        print(json.dumps({"gpu": gpu, "refine": args.refine,
                          "dtype": args.dtype, "fused_gru": args.fused_gru,
                          "use_pallas": args.use_pallas, "path": path,
                          "batch": 2, "points": cfg.data.max_points,
                          "iters": cfg.train.iters,
                          "steps_per_call": trainer.steps_k
                          if trainer.multi_step is not None else 1,
                          "packed_state": cfg.parallel.packed_state,
                          "remat_policy": cfg.model.remat_policy,
                          "corr_chunk": cfg.model.corr_chunk,
                          "graph_chunk": cfg.model.graph_chunk,
                          "telemetry": cfg.train.telemetry,
                          **row}), flush=True)
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
