"""Training entry point of the port.

    python -m pvraft_tpu_torch.train [--dataset FT3D] --root FT3D_ROOT
        [--no_strict_sizes] [--num_workers 8] [--no_native_loader]
        [--num_epochs 2] [--batch_size 2] [--max_points 8192] [--iters 8]
        [--eval_iters 32]
        [--fused_gru] [--no-use_pallas] [--bf16] [--grad_dtype bfloat16]
        [--corr_chunk C] [--graph_chunk C] [--remat_policy P]
        [--packed_state [--steps_per_dispatch K | --host_roundtrip]]
        [--device_prefetch 2] [--device cpu] [--data_parallel N]
        [--telemetry [--divergence_zscore 6] [--divergence_window 64]
                     [--halt_on_divergence]] [--profile_dir DIR]
        [--exp_path EXP] [--resume | --weights CKPT]
        [--refine [--stage1_weights CKPT]] ...

``--dataset FT3D`` (the default) trains on a preprocessed FlyingThings3D
tree (``python -m pvraft_tpu_torch.data.preprocess.flyingthings3d``),
``--dataset synthetic`` on seeded synthetic scenes. The flags are
``train.py``'s for the fields this slice trains with, plus
``--synthetic_objects``, ``--use_pallas/--no-use_pallas``,
``--fused_gru``, ``--no_native_loader`` (the threaded numpy loader,
where no ``g++`` builds the native one) and ``--device``. The model
levers (``--corr_chunk``, ``--graph_chunk``, ``--remat``,
``--remat_policy``; ``--approx_topk`` and ``--approx_knn``, which
compute the exact top-k: approx = exact off the TPU) and the K-step
levers (``--packed_state``, ``--steps_per_dispatch``,
``--host_roundtrip``, ``--device_prefetch``) parse as ``train.py``'s. Runs on the
card unless ``--device`` names another device. ``--telemetry``,
``--divergence_zscore``, ``--divergence_window``,
``--halt_on_divergence`` and ``--profile_dir`` arm the train
observability (``engine/trainer.py``); the event stream
``<exp_path>/train.events.jsonl``, the log
``<exp_path>/logs/Train_<dataset>.log`` and the TensorBoard scalars are
written whatever the flags. Every other flag of ``train.py`` is rejected
with the slice that brings it. Prints each epoch's train and val means
and the final test means as JSON lines. Checkpoints go to
``<exp_path>/checkpoints`` (``engine/checkpoint.py``); ``--weights``
resumes from a checkpoint (parameters, Adam state, schedule position,
epoch), ``--resume`` from ``last_checkpoint`` where there is one: the
root ``train.py``'s semantics. ``--refine`` trains stage 2 (the
``PVRaftRefine`` head on a frozen backbone; the canonical run is
``--iters 32 --num_epochs 10``), and ``--stage1_weights`` imports a
stage-1 checkpoint into its backbone first: stage-1 import, then
``--weights``, then ``--resume``, in the root ``train.py``'s order.

Data parallelism, one process per card::

    torchrun --nproc_per_node=N -m pvraft_tpu_torch.train ... \
        [--data_parallel N]

``main`` joins the process group first (``parallel/distributed.py::
initialize``: NCCL on the card, gloo on the CPU), as the root
``train.py`` initializes ``jax.distributed``. ``--batch_size`` is per
device; ``--data_parallel`` is the data axis (-1, the default: every
rank) and must equal the world size. Rank 0 alone prints, writes
checkpoints, events, logs and tags. ``--seq_parallel P`` shards each
scene's points over P ranks (``ModelConfig.seq_shard``, the ring of
``parallel/ring.py``): the world is ``--data_parallel`` x P ranks, e.g.
on the CPU with gloo::

    torchrun --nproc_per_node=4 -m pvraft_tpu_torch.train --device cpu \
        --dataset synthetic --data_parallel 2 --seq_parallel 2 ...

Stage 2 takes it too: each rank imports the same stage-1 checkpoint into
its backbone and runs the head on its rows, e.g.::

    torchrun --nproc_per_node=2 -m pvraft_tpu_torch.train --device cpu \
        --dataset synthetic --refine --seq_parallel 2 \
        --stage1_weights CKPT ...
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from pvraft_tpu_torch.config import (
    LR_SCHEDULES,
    Config,
    DataConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)

# train.py flags of features a later slice of the port brings.
LATER_FLAGS = {
    "--scatter_free_vjp": "its recorded disposition (ROADMAP queue 1 item 7)",
    "--platform": "no slice: the port picks its device with --device",
    "--scan_unroll": "no slice: a captured graph holds the GRU iterations "
                     "unrolled, whatever the unroll (ModelConfig.scan_unroll "
                     "is accepted only to load configs shared with the JAX "
                     "package)",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("pvraft_tpu_torch train", allow_abbrev=False)
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in LATER_FLAGS:
            p.error(f"{flag} is not ported yet: it arrives with "
                    f"{LATER_FLAGS[flag]}")
    p.add_argument("--exp_path", default="experiments/default")
    p.add_argument("--root", default="", help="preprocessed dataset root")
    p.add_argument("--dataset", default="FT3D", choices=["FT3D", "synthetic"])
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--no_strict_sizes", action="store_true",
                   help="allow dataset subsets (skip the full-size checks)")
    p.add_argument("--no_native_loader", action="store_true",
                   help="train from the threaded numpy loader, not the "
                        "C++ one (which g++ builds at first use)")
    p.add_argument("--max_points", type=int, default=8192)
    p.add_argument("--synthetic_size", type=int, default=64)
    p.add_argument("--synthetic_objects", type=int, default=1,
                   help="independently moving rigid objects per synthetic "
                        "scene (1: one global transform)")
    p.add_argument("--corr_levels", type=int, default=3)
    p.add_argument("--base_scales", type=float, default=0.25)
    p.add_argument("--truncate_k", type=int, default=512)
    p.add_argument("--corr_knn", type=int, default=32)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--eval_iters", type=int, default=32)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_schedule", default="parity", choices=LR_SCHEDULES)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights", default=None,
                   help="checkpoint to resume from (params + optimizer)")
    p.add_argument("--resume", action="store_true",
                   help="auto-resume from <exp_path>/checkpoints/"
                        "last_checkpoint")
    p.add_argument("--checkpoint_interval", type=int, default=5)
    p.add_argument("--refine", action="store_true",
                   help="train stage 2: the refine head on a frozen "
                        "backbone")
    p.add_argument("--stage1_weights", default=None,
                   help="stage-1 checkpoint to import into the backbone "
                        "(with --refine)")
    p.add_argument("--ckpt_backend", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="checkpoint format; orbax is refused (not installed "
                        "where the port runs; ROADMAP queue 1 item 2)")
    p.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the CUDA kernels vs their plain PyTorch versions "
                        "(default: the kernels on a CUDA device)")
    p.add_argument("--fused_gru", action="store_true",
                   help="fused MotionEncoder+ConvGRU update")
    p.add_argument("--bf16", action="store_true",
                   help="train and evaluate at compute_dtype bfloat16")
    p.add_argument("--grad_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="cast gradients once after the backward; the "
                        "optimizer state stays float32")
    p.add_argument("--corr_chunk", type=int, default=None,
                   help="streaming top-k chunk over N2 (memory saver)")
    p.add_argument("--graph_chunk", type=int, default=None,
                   help="streaming kNN graph chunk (memory saver for 16k+ "
                        "points)")
    p.add_argument("--approx_topk", action="store_true",
                   help="accepted; computes the exact top-k, as the JAX "
                        "package does off the TPU")
    p.add_argument("--approx_knn", action="store_true",
                   help="accepted; computes the exact kNN, as the JAX "
                        "package does off the TPU")
    p.add_argument("--remat", action="store_true",
                   help="recompute each GRU iteration in the backward")
    p.add_argument("--remat_policy", default="none",
                   help="none|full|dots|dots_no_batch|save_corr "
                        "(overrides --remat; save_corr keeps the lookup's "
                        "output and recomputes the rest)")
    p.add_argument("--packed_state", action="store_true",
                   help="the trained parameters and Adam's state as one "
                        "flat buffer")
    p.add_argument("--host_roundtrip", action="store_true",
                   help="with --packed_state: the flat buffer to host "
                        "memory and back before each step")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="with --packed_state: K train steps in one "
                        "captured graph")
    p.add_argument("--device_prefetch", type=int, default=2,
                   help="batches kept in flight to the device (1: none "
                        "ahead)")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of the first epoch "
                        "here")
    p.add_argument("--telemetry", action="store_true",
                   help="run-health telemetry (pvraft_tpu_torch/obs): "
                        "in-step numerics monitors in the train step, loss "
                        "divergence detection, crash snapshots replayable "
                        "by python -m pvraft_tpu_torch.doctor")
    p.add_argument("--divergence_zscore", type=float, default=6.0,
                   help="with --telemetry: trip when loss exceeds this "
                        "many trailing std devs over the window (0 "
                        "disables; the NaN/Inf sentinel stays armed)")
    p.add_argument("--divergence_window", type=int, default=64,
                   help="with --telemetry: trailing window (healthy "
                        "steps) of the loss z-score detector")
    p.add_argument("--halt_on_divergence", action="store_true",
                   help="with --telemetry: stop after the first "
                        "divergence snapshot instead of training on "
                        "with corrupt state")
    p.add_argument("--strict_retrace", action="store_true",
                   help="raise RetraceError when a graphed step meets an "
                        "input signature it has not captured")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without one)")
    p.add_argument("--data_parallel", type=int, default=-1,
                   help="ranks on the data axis (-1: all; launch one "
                        "process per card with torchrun)")
    p.add_argument("--seq_parallel", type=int, default=1,
                   help="ranks on the sequence axis: each scene's points "
                        "sharded over them (seq_shard)")
    args = p.parse_args(argv)
    if args.stage1_weights and not args.refine:
        p.error("--stage1_weights needs --refine")
    return args


def config_from_args(a: argparse.Namespace) -> Config:
    return Config(
        model=ModelConfig(truncate_k=a.truncate_k, corr_knn=a.corr_knn,
                          corr_levels=a.corr_levels, base_scale=a.base_scales,
                          use_pallas=a.use_pallas, fused_gru=a.fused_gru,
                          compute_dtype="bfloat16" if a.bf16 else "float32",
                          corr_chunk=a.corr_chunk, graph_chunk=a.graph_chunk,
                          approx_topk=a.approx_topk, approx_knn=a.approx_knn,
                          remat=a.remat, remat_policy=a.remat_policy,
                          seq_shard=a.seq_parallel > 1),
        data=DataConfig(dataset=a.dataset, root=a.root,
                        max_points=a.max_points, num_workers=a.num_workers,
                        native_loader=not a.no_native_loader,
                        strict_sizes=not a.no_strict_sizes,
                        synthetic_size=a.synthetic_size,
                        synthetic_objects=a.synthetic_objects),
        train=TrainConfig(batch_size=a.batch_size, num_epochs=a.num_epochs,
                          lr=a.lr, gamma=a.gamma, iters=a.iters,
                          eval_iters=a.eval_iters, seed=a.seed,
                          lr_schedule=a.lr_schedule,
                          strict_retrace=a.strict_retrace,
                          grad_dtype=a.grad_dtype,
                          profile_dir=a.profile_dir, telemetry=a.telemetry,
                          divergence_zscore=a.divergence_zscore,
                          divergence_window=a.divergence_window,
                          halt_on_divergence=a.halt_on_divergence,
                          checkpoint_interval=a.checkpoint_interval,
                          ckpt_backend=a.ckpt_backend, refine=a.refine),
        parallel=ParallelConfig(data_axis=a.data_parallel,
                                seq_axis=a.seq_parallel,
                                packed_state=a.packed_state,
                                host_roundtrip=a.host_roundtrip,
                                steps_per_dispatch=a.steps_per_dispatch,
                                device_prefetch=a.device_prefetch),
        exp_path=a.exp_path,
    )


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    from pvraft_tpu_torch.engine.checkpoint import latest_checkpoint
    from pvraft_tpu_torch.engine.trainer import Trainer
    from pvraft_tpu_torch.parallel import initialize, process_index

    # Joins torchrun's processes into one group (nothing on one process).
    initialize(backend="gloo" if args.device == "cpu" else None)
    trainer = Trainer(config_from_args(args), device=args.device)
    lead = process_index() == 0
    if args.stage1_weights:
        trainer.load_stage1_weights(args.stage1_weights)
    if args.weights:
        trainer.load_weights(args.weights, resume=True)
    elif args.resume:
        last = latest_checkpoint(trainer.ckpt_dir)
        if last:
            trainer.load_weights(last, resume=True)

    def report(epoch, train, val):
        train = {k: v for k, v in train.items()
                 if k not in ("losses", "epes")}
        if lead:
            print(json.dumps({"epoch": epoch, "train": train, "val": val}),
                  flush=True)

    test = trainer.fit(report)
    if lead:
        print(json.dumps({"test": test, "device": str(trainer.device)}),
              flush=True)


if __name__ == "__main__":
    main()
