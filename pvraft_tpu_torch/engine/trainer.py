"""Stage-1 trainer (port of ``pvraft_tpu/engine/trainer.py::Trainer``).

One card, eager PyTorch: seeded (or JAX-imported) weights, Adam with the
configured learning-rate schedule, the train step over the shuffled
synthetic training set, and per-epoch validation at ``eval_iters`` with
one scene per step. ``fit`` trains and validates every epoch, then tests
once.

Not in this slice: checkpoints and resume, TensorBoard and the event
log, divergence snapshots (the trainer slice and the observability
slice), FT3D and KITTI (the data slice), data-parallel meshes (the
parallel slice).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from pvraft_tpu_torch.config import Config
from pvraft_tpu_torch.data import SyntheticDataset, batches, to_device
from pvraft_tpu_torch.device import resolve_device
from pvraft_tpu_torch.engine.schedule import make_lr_schedule
from pvraft_tpu_torch.engine.steps import make_eval_step, make_train_step
from pvraft_tpu_torch.models.raft import PVRaft
from pvraft_tpu_torch.rng import torch_seed
from pvraft_tpu_torch.weights import (
    opt_state_from_jax,
    params_from_jax,
    seeded_state_dict,
)


def build_datasets(cfg: Config):
    """(train, val, test) datasets; synthetic scenes are seeded 0/1/2 as
    in the JAX package."""
    d = cfg.data
    if d.dataset == "synthetic":
        return tuple(
            SyntheticDataset(size=d.synthetic_size, nb_points=d.max_points,
                             noise=0.01, seed=seed,
                             n_objects=d.synthetic_objects)
            for seed in (0, 1, 2))
    raise NotImplementedError(
        f"dataset {d.dataset!r} is not ported yet: it arrives with the data "
        f"slice; this slice trains on 'synthetic'")


class Trainer:
    """``Trainer(cfg, device=None, weights=None, opt_state=None)``.

    ``weights``: a port state_dict or a JAX flax params tree (mapped by
    :func:`params_from_jax`); default: seeded from ``cfg.train.seed``'s
    ``model.init`` stream. ``opt_state``: an optax Adam state to resume
    (:func:`opt_state_from_jax`). Runs on ``cuda`` unless ``device``
    names another device; raises when no card is present and none was
    named.
    """

    def __init__(self, cfg: Config, device: Union[str, torch.device, None] = None,
                 weights: Optional[Mapping] = None, opt_state: Any = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_ds, self.val_ds, self.test_ds = build_datasets(cfg)
        bs = cfg.train.batch_size
        if bs > len(self.train_ds):
            raise ValueError(f"batch size {bs} exceeds the dataset size "
                             f"{len(self.train_ds)}")
        if weights is None:
            weights = seeded_state_dict(
                cfg.model, torch_seed(cfg.train.seed, "model.init"))
        elif any(isinstance(v, Mapping) for v in weights.values()):
            weights = params_from_jax(weights)
        self.model = PVRaft(cfg.model)
        self.model.load_state_dict(weights, strict=True)
        self.model.to(self.device)

        self.steps_per_epoch = max(1, len(self.train_ds) // bs)
        self.schedule = make_lr_schedule(
            cfg.train.lr_schedule, cfg.train.lr, cfg.train.num_epochs,
            self.steps_per_epoch, len(self.train_ds))
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8.
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.schedule(0), betas=(0.9, 0.999),
            eps=1e-8)
        if opt_state is not None:
            self.optimizer.load_state_dict(
                opt_state_from_jax(opt_state, self.model))
        self.train_step = make_train_step(
            self.model, self.optimizer, self.schedule, cfg.train.gamma,
            cfg.train.iters, grad_dtype=cfg.train.grad_dtype,
            telemetry=cfg.train.telemetry)
        self.eval_step = make_eval_step(self.model, cfg.train.eval_iters,
                                        cfg.train.gamma, per_scene=True)

    def training(self, epoch: int) -> Dict[str, Any]:
        """The train steps of one epoch. Returns the mean loss and EPE,
        the step count, each step's loss, and the epoch's wall time per
        step in ms (host clock, synchronised at the end)."""
        cfg = self.cfg
        self.model.train()
        metrics: List[Dict[str, torch.Tensor]] = []
        t0 = time.perf_counter()
        for batch in batches(self.train_ds, cfg.train.batch_size,
                             shuffle=True, seed=cfg.train.seed, epoch=epoch):
            metrics.append(self.train_step(to_device(batch, self.device)))
        # One device-to-host read per epoch, not per step.
        losses = [float(m["loss"]) for m in metrics]
        epes = [float(m["epe"]) for m in metrics]
        wall_ms = 1e3 * (time.perf_counter() - t0)
        n = len(losses)
        return {"loss": float(np.mean(losses)) if n else float("nan"),
                "epe": float(np.mean(epes)) if n else float("nan"),
                "steps": n, "losses": losses,
                "step_ms": wall_ms / n if n else 0.0}

    def val_test(self, epoch: int, mode: str = "val") -> Dict[str, float]:
        """Means of the per-scene eval metrics over the val (or test) set,
        one scene per step at ``eval_iters`` iterations."""
        ds = self.val_ds if mode == "val" else self.test_ds
        self.model.eval()
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in batches(ds, 1, drop_last=False):
            out, _ = self.eval_step(to_device(batch, self.device))
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + v.sum()
            count += batch["pc1"].shape[0]
        return {k: float(v) / max(1, count) for k, v in sums.items()}

    def fit(self, report: Optional[Callable[[int, Dict, Dict], None]] = None
            ) -> Dict[str, float]:
        """Train and validate every epoch (``report(epoch, train, val)``
        after each), then test once; returns the test means."""
        for epoch in range(self.cfg.train.num_epochs):
            train = self.training(epoch)
            val = self.val_test(epoch, "val")
            if report is not None:
                report(epoch, train, val)
        return self.val_test(self.cfg.train.num_epochs - 1, "test")
