"""Replay a divergence snapshot one step, stage by stage (port of
``scripts/run_doctor.py``).

    python -m pvraft_tpu_torch.doctor <exp>/snapshots/step_0000042
        [--json report.json] [--device cpu|cuda]

A snapshot (``pvraft_snapshot/v1``, ``obs/divergence.py``; the port's or
the JAX package's) holds the offending batch and the parameters and Adam
state as they were BEFORE the bad update. The doctor rebuilds the model
from the snapshot's config and replays that step in order:

    batch -> encoder(pc1) -> encoder(pc2) -> corr_init ->
    gru_iter[t] for every iteration (refine: refine_flow) -> loss ->
    grads[group] for every top-level parameter group ->
    optimizer_update -> updated_params

and reports each stage's numerics (finite, NaN and Inf counts, the
largest finite magnitude) and the FIRST non-finite stage, under the JAX
doctor's report keys. On the card (the default; ``--device cpu`` for the
CPU) the replay runs through the CUDA kernels; the optimizer stage
replays the Trainer's Adam at the learning rate its schedule gives at
the snapshot's step (the schedule's geometry is in the snapshot's meta).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def stage_stats(name: str, tree: Any) -> Dict[str, Any]:
    """Numerics of one stage's output: every floating array or tensor of
    ``tree`` (dicts, lists, tuples)."""
    leaves: List[np.ndarray] = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif torch.is_tensor(x):
            leaves.append(x.detach().float().cpu().numpy())
        elif x is not None:
            leaves.append(np.asarray(x))

    walk(tree)
    floats = [a for a in leaves if np.issubdtype(a.dtype, np.floating)]
    nan = sum(int(np.isnan(a).sum()) for a in floats)
    inf = sum(int(np.isinf(a).sum()) for a in floats)
    absmax = max((float(np.max(np.abs(a[np.isfinite(a)]), initial=0.0))
                  for a in floats), default=0.0)
    return {"stage": name, "finite": nan == 0 and inf == 0, "nan": nan,
            "inf": inf, "absmax": absmax}


def diagnose(snap_path: str, device=None) -> Dict[str, Any]:
    """Replay the snapshot on ``device`` (default: the card); returns the
    report: ``snapshot``, ``meta`` (step, epoch, reason, loss),
    ``stages`` (one :func:`stage_stats` row each) and
    ``first_nonfinite_stage`` (None when the replay is finite)."""
    from pvraft_tpu_torch.config import ModelConfig
    from pvraft_tpu_torch.device import resolve_device
    from pvraft_tpu_torch.engine.loss import compute_loss, sequence_loss
    from pvraft_tpu_torch.engine.schedule import make_lr_schedule
    from pvraft_tpu_torch.engine.steps import set_lr
    from pvraft_tpu_torch.models.raft import PVRaft, PVRaftRefine
    from pvraft_tpu_torch.obs.divergence import load_snapshot
    from pvraft_tpu_torch.obs.monitors import param_group
    from pvraft_tpu_torch.ops.corr import corr_init
    from pvraft_tpu_torch.weights import (
        opt_state_from_jax,
        params_from_jax,
        schedule_count,
        trained_parameters,
    )

    device = resolve_device(device)
    meta, batch, params_np, opt_np = load_snapshot(snap_path)
    cfg_d = meta.get("config", {})
    # The kernels where the device has them, whatever the run used.
    model_cfg = dataclasses.replace(ModelConfig(**cfg_d.get("model", {})),
                                    use_pallas=None)
    train_d = cfg_d.get("train", {})
    refine = bool(train_d.get("refine", False))
    iters = int(train_d.get("iters", 8))
    gamma = float(train_d.get("gamma", 0.8))
    model = (PVRaftRefine if refine else PVRaft)(model_cfg)
    model.load_state_dict(params_from_jax(params_np), strict=True)
    model.to(device)
    b = {k: torch.from_numpy(np.asarray(v)).to(device)
         for k, v in batch.items()}
    pc1, pc2, mask, gt = b["pc1"], b["pc2"], b["mask"], b["flow"]

    rows = [stage_stats("batch", batch)]
    backbone = model.backbone if refine else model
    with torch.no_grad():
        fmap1, _ = backbone.feature_extractor(pc1)
        rows.append(stage_stats("encoder(pc1)", fmap1))
        fmap2, _ = backbone.feature_extractor(pc2)
        rows.append(stage_stats("encoder(pc2)", fmap2))
        state = corr_init(fmap1, fmap2, pc2, model_cfg.truncate_k,
                          model_cfg.corr_chunk, model_cfg.approx_topk)
        rows.append(stage_stats("corr_init", state))

    def loss_of():
        if refine:
            flow = model(pc1, pc2, iters)
            return compute_loss(flow, mask, gt), [("refine_flow", flow)]
        flows, _ = model(pc1, pc2, iters)
        return (sequence_loss(flows, mask, gt, gamma),
                [(f"gru_iter[{t}]", flows[t]) for t in range(len(flows))])

    loss, flows = loss_of()
    rows += [stage_stats(name, f) for name, f in flows]
    rows.append(stage_stats("loss", loss))

    # Gradients per top-level group; a parameter without one (the frozen
    # backbone) counts as zeros, as JAX's stop_gradient gives.
    named = list(model.named_parameters())
    live = [(n, p) for n, p in named if p.requires_grad]
    grads = dict(zip([n for n, _ in live], torch.autograd.grad(
        loss, [p for _, p in live], allow_unused=True)))
    for group in sorted({param_group(n) for n, _ in named}):
        rows.append(stage_stats(f"grads[{group}]", [
            grads.get(n) if grads.get(n) is not None else torch.zeros_like(p)
            for n, p in named if param_group(n) == group]))

    # The update the run would have taken: Adam from the dumped state at
    # the schedule's learning rate for the snapshot's step.
    trained = trained_parameters(model)
    optimizer = torch.optim.Adam([p for _, p in trained], lr=1e-3,
                                 betas=(0.9, 0.999), eps=1e-8)
    optimizer.load_state_dict(opt_state_from_jax(opt_np, model, optimizer))
    sched = meta.get("schedule", {})
    schedule = make_lr_schedule(
        train_d.get("lr_schedule", "parity"), float(train_d.get("lr", 1e-3)),
        int(train_d.get("num_epochs", 20)), sched.get("steps_per_epoch", 1),
        sched.get("dataset_size", 1))
    count = schedule_count(opt_np)
    if count is None:
        count = int(optimizer.state[trained[0][1]]["step"])
    set_lr(optimizer, schedule(count))
    before = [p.detach().clone() for _, p in named]
    for n, p in trained:
        p.grad = (grads.get(n) if grads.get(n) is not None
                  else torch.zeros_like(p))
    optimizer.step()
    rows.append(stage_stats("optimizer_update", [
        p.detach() - q for (_, p), q in zip(named, before)]))
    rows.append(stage_stats("updated_params", [p for _, p in named]))

    first_bad = next((r["stage"] for r in rows if not r["finite"]), None)
    return {
        "snapshot": os.path.abspath(snap_path),
        "meta": {k: meta.get(k) for k in ("step", "epoch", "reason", "loss")},
        "device": str(device),
        "stages": rows,
        "first_nonfinite_stage": first_bad,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pvraft_tpu_torch.doctor")
    ap.add_argument("snapshot", help="pvraft_snapshot/v1 directory")
    ap.add_argument("--json", default=None,
                    help="also write the report as JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    report = diagnose(args.snapshot, args.device)
    meta = report["meta"]
    print(f"snapshot {report['snapshot']} on {report['device']}")
    print(f"  step {meta['step']} epoch {meta['epoch']} "
          f"reason={meta['reason']} recorded_loss={meta['loss']}")
    print(f"{'stage':<26} {'finite':<7} {'nan':>9} {'inf':>7} {'absmax':>12}")
    for r in report["stages"]:
        mark = "ok" if r["finite"] else "BAD"
        print(f"{r['stage']:<26} {mark:<7} {r['nan']:>9} {r['inf']:>7} "
              f"{r['absmax']:>12.4e}")
    if report["first_nonfinite_stage"] is None:
        print("verdict: replay is finite end to end — the divergence was "
              "state/batch-order dependent (z-score trip?) or lives in a "
              "config this replay does not reproduce")
    else:
        print(f"verdict: first non-finite stage is "
              f"{report['first_nonfinite_stage']}")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
