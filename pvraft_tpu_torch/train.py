"""Training entry point of the port.

    python -m pvraft_tpu_torch.train --dataset synthetic [--num_epochs 2]
        [--batch_size 2] [--max_points 8192] [--iters 8] [--eval_iters 32]
        [--fused_gru] [--no-use_pallas] [--device cpu] ...

The flags are ``train.py``'s for the fields this slice trains with, plus
``--synthetic_objects``, ``--use_pallas/--no-use_pallas``,
``--fused_gru`` and ``--device``. Runs on the card unless ``--device``
names another device. Every other flag of ``train.py`` is rejected with
the slice that brings it. Prints each epoch's train and val means and
the final test means as JSON lines.
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
    TrainConfig,
)

# train.py flags of features a later slice of the port brings.
LATER_FLAGS = {
    "--root": "the data slice (FT3D, KITTI)",
    "--num_workers": "the data slice (PrefetchLoader)",
    "--no_strict_sizes": "the data slice (FT3D, KITTI)",
    "--exp_path": "the trainer slice (checkpoints, logs)",
    "--weights": "the trainer slice (checkpoints, resume)",
    "--resume": "the trainer slice (checkpoints, resume)",
    "--checkpoint_interval": "the trainer slice (checkpoints, resume)",
    "--ckpt_backend": "the trainer slice (checkpoints, resume)",
    "--refine": "the stage-2 slice",
    "--stage1_weights": "the stage-2 slice",
    "--data_parallel": "the parallel slice",
    "--seq_parallel": "the parallel slice",
    "--corr_chunk": "the streaming correlation slice",
    "--graph_chunk": "the streaming graph slice",
    "--bf16": "the bf16 slice",
    "--grad_dtype": "the bf16 slice",
    "--approx_topk": "the approximate top-k slice",
    "--approx_knn": "the approximate top-k slice",
    "--remat": "the memory levers (ROADMAP queue 1 item 9)",
    "--remat_policy": "the memory levers (ROADMAP queue 1 item 9)",
    "--scatter_free_vjp": "its recorded disposition (ROADMAP queue 1 item 9)",
    "--packed_state": "the CUDA-graph slice (the H100 counterpart of "
                      "packed dispatch)",
    "--host_roundtrip": "the CUDA-graph slice",
    "--steps_per_dispatch": "the CUDA-graph slice",
    "--scan_unroll": "the CUDA-graph slice",
    "--device_prefetch": "the data slice (PrefetchLoader)",
    "--platform": "no slice: the port picks its device with --device",
    "--profile_dir": "the observability slice",
    "--telemetry": "the observability slice",
    "--divergence_zscore": "the observability slice",
    "--divergence_window": "the observability slice",
    "--halt_on_divergence": "the observability slice",
    "--strict_retrace": "the CUDA-graph slice",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("pvraft_tpu_torch train", allow_abbrev=False)
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in LATER_FLAGS:
            p.error(f"{flag} is not ported yet: it arrives with "
                    f"{LATER_FLAGS[flag]}")
    p.add_argument("--dataset", default="FT3D", choices=["FT3D", "synthetic"])
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
    p.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the CUDA kernels vs their plain PyTorch versions "
                        "(default: the kernels on a CUDA device)")
    p.add_argument("--fused_gru", action="store_true",
                   help="fused MotionEncoder+ConvGRU update")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without one)")
    return p.parse_args(argv)


def config_from_args(a: argparse.Namespace) -> Config:
    return Config(
        model=ModelConfig(truncate_k=a.truncate_k, corr_knn=a.corr_knn,
                          corr_levels=a.corr_levels, base_scale=a.base_scales,
                          use_pallas=a.use_pallas, fused_gru=a.fused_gru),
        data=DataConfig(dataset=a.dataset, max_points=a.max_points,
                        synthetic_size=a.synthetic_size,
                        synthetic_objects=a.synthetic_objects),
        train=TrainConfig(batch_size=a.batch_size, num_epochs=a.num_epochs,
                          lr=a.lr, gamma=a.gamma, iters=a.iters,
                          eval_iters=a.eval_iters, seed=a.seed,
                          lr_schedule=a.lr_schedule),
    )


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    from pvraft_tpu_torch.engine.trainer import Trainer

    trainer = Trainer(config_from_args(args), device=args.device)

    def report(epoch, train, val):
        train = {k: v for k, v in train.items() if k != "losses"}
        print(json.dumps({"epoch": epoch, "train": train, "val": val}),
              flush=True)

    test = trainer.fit(report)
    print(json.dumps({"test": test, "device": str(trainer.device)}),
          flush=True)


if __name__ == "__main__":
    main()
