"""Evaluation entry point of the port (the counterpart of the root
``test.py``, as ``pvraft_tpu_torch/train.py`` is of ``train.py``).

    python -m pvraft_tpu_torch.test --dataset KITTI|FT3D --root ROOT
        --weights EXP/checkpoints/best_checkpoint.msgpack
        [--no_strict_sizes] [--num_workers 8] [--eval_iters 32]
        [--refine] [--bf16] [--dump_dir result] [--device cpu] ...

``--dataset KITTI`` evaluates zero-shot on the 142 KITTI scenes of a
preprocessed tree (``python -m pvraft_tpu_torch.data.preprocess.kitti``),
``FT3D`` on FlyingThings3D's test split, ``synthetic`` on seeded scenes.

The reference protocol (``engine/evaluator.py``): per-scene metrics at
``eval_iters`` GRU iterations, running means; ``--eval_batch`` scenes a
step (0: one per data rank), and under ``torchrun --nproc_per_node=N -m
pvraft_tpu_torch.test`` the ranks share the scenes; ``--seq_parallel P``
shards each scene's points over P of them (``--refine`` included).
``--weights`` takes a
msgpack checkpoint of the port or of the JAX package, ``--torch_weights``
a reference-published ``.params`` file; with ``--refine`` either holds a
stage-2 (``PVRaftRefine``) model, evaluated at ``eval_iters``. The flags
are ``test.py``'s for the fields this slice evaluates with, plus
``--synthetic_objects``, ``--fused_gru`` and ``--device`` (``--approx_topk``
and ``--approx_knn`` compute the exact top-k, as the JAX package does
off the TPU); every other
flag of ``test.py`` is rejected with the slice that brings it. Runs on
the card unless ``--device`` names another device. Prints the means as
one JSON line; the running means every 50 scenes go to
``<exp_path>/logs/TestAlone_<dataset>.log`` and the ``eval`` record to
``<exp_path>/testalone.events.jsonl`` (``engine/evaluator.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from pvraft_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)

# test.py flags of features a later slice of the port brings.
LATER_FLAGS = {
    "--platform": "no slice: the port picks its device with --device",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("pvraft_tpu_torch test", allow_abbrev=False)
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in LATER_FLAGS:
            p.error(f"{flag} is not ported yet: it arrives with "
                    f"{LATER_FLAGS[flag]}")
    p.add_argument("--exp_path", default="experiments/default")
    p.add_argument("--root", default="")
    p.add_argument("--dataset", default="FT3D",
                   choices=["FT3D", "KITTI", "synthetic"])
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--no_strict_sizes", action="store_true",
                   help="allow dataset subsets (skip the full-size checks)")
    p.add_argument("--max_points", type=int, default=8192)
    p.add_argument("--synthetic_size", type=int, default=16)
    p.add_argument("--synthetic_objects", type=int, default=1,
                   help="independently moving rigid objects per synthetic "
                        "scene (1: one global transform)")
    p.add_argument("--corr_levels", type=int, default=3)
    p.add_argument("--base_scales", type=float, default=0.25)
    p.add_argument("--truncate_k", type=int, default=512)
    p.add_argument("--corr_knn", type=int, default=32)
    p.add_argument("--eval_iters", type=int, default=32)
    p.add_argument("--corr_chunk", type=int, default=None,
                   help="streaming top-k chunk over N2 (memory saver)")
    p.add_argument("--graph_chunk", type=int, default=None,
                   help="streaming kNN graph chunk")
    p.add_argument("--approx_topk", action="store_true",
                   help="accepted; the exact top-k, as off the TPU")
    p.add_argument("--approx_knn", action="store_true",
                   help="accepted; the exact kNN, as off the TPU")
    p.add_argument("--eval_scan", type=int, default=1,
                   help="accepted so that the JAX package's commands "
                        "run, and changes nothing: a replay of the "
                        "captured eval step is one launch per batch")
    p.add_argument("--eval_batch", type=int, default=0,
                   help="scenes per eval step, each with its own "
                        "metrics (0: one per data rank)")
    p.add_argument("--refine", action="store_true",
                   help="evaluate a stage-2 (refine) checkpoint")
    p.add_argument("--weights", default=None,
                   help="a msgpack checkpoint (the port's or the JAX "
                        "package's)")
    p.add_argument("--torch_weights", default=None,
                   help="reference-published torch .params checkpoint")
    p.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the CUDA kernels vs their plain PyTorch versions "
                        "(default: the kernels on a CUDA device)")
    p.add_argument("--fused_gru", action="store_true",
                   help="fused MotionEncoder+ConvGRU update")
    p.add_argument("--bf16", action="store_true",
                   help="evaluate at compute_dtype bfloat16")
    p.add_argument("--dump_dir", default=None,
                   help="write <dump_dir>/<dataset>/<idx>/{pc1,pc2,flow}.npy "
                        "for visual.py")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without one)")
    p.add_argument("--seq_parallel", type=int, default=1,
                   help="ranks on the sequence axis: each scene's points "
                        "sharded over them (seq_shard); launch the ranks "
                        "with torchrun")
    return p.parse_args(argv)


def config_from_args(a: argparse.Namespace) -> Config:
    return Config(
        model=ModelConfig(truncate_k=a.truncate_k, corr_knn=a.corr_knn,
                          corr_levels=a.corr_levels, base_scale=a.base_scales,
                          use_pallas=a.use_pallas, fused_gru=a.fused_gru,
                          compute_dtype="bfloat16" if a.bf16 else "float32",
                          corr_chunk=a.corr_chunk, graph_chunk=a.graph_chunk,
                          approx_topk=a.approx_topk, approx_knn=a.approx_knn,
                          seq_shard=a.seq_parallel > 1),
        data=DataConfig(dataset=a.dataset, root=a.root,
                        max_points=a.max_points, num_workers=a.num_workers,
                        strict_sizes=not a.no_strict_sizes,
                        synthetic_size=a.synthetic_size,
                        synthetic_objects=a.synthetic_objects),
        train=TrainConfig(refine=a.refine, eval_iters=a.eval_iters,
                          eval_batch=a.eval_batch, eval_scan=a.eval_scan),
        parallel=ParallelConfig(seq_axis=a.seq_parallel),
        exp_path=a.exp_path,
    )


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    from pvraft_tpu_torch.engine.evaluator import Evaluator
    from pvraft_tpu_torch.parallel import initialize, make_mesh, process_index

    # Under torchrun the ranks share the scenes (nothing on one process);
    # with --seq_parallel each scene's points too (the JAX test.py's
    # make_mesh(n_data=1, n_seq=P) on one process; here every rank the
    # seq axis leaves goes on the data axis).
    initialize(backend="gloo" if args.device == "cpu" else None)
    ev = Evaluator(config_from_args(args), device=args.device,
                   mesh=make_mesh(n_seq=args.seq_parallel))
    if args.weights:
        ev.load(args.weights)
    if args.torch_weights:
        ev.load_torch(args.torch_weights)
    means = ev.run(dump_dir=args.dump_dir)
    ev.close()
    if process_index() == 0:
        print(json.dumps(dict(sorted(means.items()))), flush=True)


if __name__ == "__main__":
    main()
