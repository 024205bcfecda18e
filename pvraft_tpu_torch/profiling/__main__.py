"""The profiling CLI of the port.

    python -m pvraft_tpu_torch.profiling profile [--points 8192]
        [--batch 2] [--k 512] [--corr_knn 32] [--graph_k 32] [--iters 8]
        [--reps 3]
        [--dtype float32|bfloat16] [--grad_dtype bfloat16]
        [--no-use_pallas] [--remat_policy P] [--device cpu]
        [--out FILE] [--events FILE]
    python -m pvraft_tpu_torch.profiling validate FILE...

``profile`` runs the step profiler (``step_profiler.py``) on the card
(``--device cpu`` for the CPU) at the flagship ``ModelConfig`` and
prints the validated ``pvraft_step_profile/v1`` record as one JSON line
(``"valid"`` and, where it is not, ``"problems"``); ``--out`` also
writes it to a file, ``--events`` appends its breakdown as ``span``
records (a ``train_step`` tree) to a ``pvraft_events/v1`` stream.
``validate`` checks records written before. Exit 1 on an invalid
record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from pvraft_tpu_torch.profiling.step_profiler import validate_step_profile


def _profile(args: argparse.Namespace) -> int:
    from pvraft_tpu_torch.config import ModelConfig

    cfg = ModelConfig(truncate_k=args.k, corr_knn=args.corr_knn,
                      graph_k=args.graph_k, compute_dtype=args.dtype,
                      use_pallas=args.use_pallas,
                      remat_policy=args.remat_policy)
    variant = "bf16" if args.dtype == "bfloat16" else "fp32"
    if args.use_pallas is False:
        variant += "+plain"
    if args.remat_policy != "none":
        variant += f"+remat:{args.remat_policy}"
    if args.grad_dtype:
        variant += f"+grads:{args.grad_dtype}"
    from pvraft_tpu_torch.profiling.step_profiler import profile_step

    record = profile_step(
        cfg, points=args.points, batch=args.batch, iters=args.iters,
        reps=args.reps, grad_dtype=args.grad_dtype, variant=variant,
        device=args.device, seed=args.seed,
        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    problems = (validate_step_profile(record) if "breakdown_s" in record
                else ["incomplete measurements (see the rungs' errors)"])
    record["valid"] = not problems
    if problems:
        record["problems"] = problems
    print(json.dumps(record), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(record, f, indent=1)
    if args.events and not problems:
        from pvraft_tpu_torch.obs.events import EventLog, run_metadata
        from pvraft_tpu_torch.obs.trace import trace_from_step_profile

        with EventLog(args.events) as log:
            if log.seq == 0:
                log.emit("run_header", **run_metadata(cfg, mode="profile"))
            for span in trace_from_step_profile(record):
                log.emit("span", **span)
    return 0 if not problems else 1


def _validate(paths: List[str]) -> int:
    rc = 0
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                record = json.load(fh)
        except (OSError, ValueError) as exc:
            print(f"{path}: unreadable ({exc})")
            rc = 1
            continue
        problems = validate_step_profile(record)
        for p in problems:
            print(f"{path}: {p}")
        if problems:
            rc = 1
        else:
            print(f"{path}: OK ({record.get('platform')}, "
                  f"total_step_s={record.get('total_step_s')})")
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pvraft_tpu_torch.profiling")
    sub = ap.add_subparsers(dest="cmd", required=True)
    prof = sub.add_parser("profile", help="profile the train step by stage")
    prof.add_argument("--points", type=int, default=8192)
    prof.add_argument("--batch", type=int, default=2)
    prof.add_argument("--k", type=int, default=512, help="truncate_k")
    prof.add_argument("--corr_knn", type=int, default=32)
    prof.add_argument("--graph_k", type=int, default=32)
    prof.add_argument("--iters", type=int, default=8)
    prof.add_argument("--reps", type=int, default=3)
    prof.add_argument("--seed", type=int, default=0)
    prof.add_argument("--dtype", choices=("float32", "bfloat16"),
                      default="float32", help="the model's compute dtype")
    prof.add_argument("--grad_dtype", default=None,
                      help="cast the gradients (TrainConfig.grad_dtype)")
    prof.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                      default=None,
                      help="the CUDA kernels vs their plain versions")
    prof.add_argument("--remat_policy", default="none")
    prof.add_argument("--device", default=None,
                      help="torch device (default: cuda; raises without one)")
    prof.add_argument("--out", default="",
                      help="also write the record to this file")
    prof.add_argument("--events", default="",
                      help="append the breakdown as span records to this "
                           "pvraft_events/v1 stream")
    val = sub.add_parser("validate", help="validate step-profile records")
    val.add_argument("paths", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd == "profile":
        return _profile(args)
    return _validate(args.paths)


if __name__ == "__main__":
    sys.exit(main())
