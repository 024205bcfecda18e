"""Trainer of both stages (port of ``pvraft_tpu/engine/trainer.py::
Trainer``).

One card: seeded (or JAX-imported) weights, Adam with the configured
learning-rate schedule, the train step over the shuffled training set
(FT3D's train split, or synthetic scenes), and per-epoch validation at
``eval_iters`` with one scene per step. ``fit`` trains, saves and
validates every epoch from ``begin_epoch``, then tests once on the
weights of the epoch with the lowest validation EPE (strict ``<``), read
back from ``best_checkpoint``.

Checkpoints (``engine/checkpoint.py``, the JAX package's files) go to
``exp_path/checkpoints``: ``last_checkpoint`` after every epoch of
``fit`` (and ``{epoch:03d}`` every ``checkpoint_interval`` epochs),
``best_checkpoint`` (with ``last_checkpoint``) after a validation
improvement.
:meth:`Trainer.load_weights` loads one, and with ``resume`` also Adam's
moments and step, the schedule's position and ``begin_epoch``: copied
into the tensors the captured steps read, never swapped for new ones.

The train and eval steps are the graphed ones (``engine/steps.py``): at
construction the trainer captures the train step at the training batch's
shape and the eval step at one scene's, each as one CUDA graph on the
card (on the CPU: the same functions on the same static buffers), with
Adam's learning rate a tensor on the trainer's device and Adam
``capturable`` on the card. ``graphs=False`` takes the eager steps with
a plain Adam (a float learning rate): the yardstick of the graphed
steps. ``capturable=True`` gives the eager steps the graphed steps' Adam
instead, for a bitwise comparison.

The data come through :class:`~pvraft_tpu_torch.data.PrefetchLoader`s,
as in the JAX Trainer: training with ``num_workers`` threads, or the
native assembler (``native_loader``) where the dataset has it, seeded by
``train.seed``; validation and test with ``min(2, num_workers)`` threads.
Batch n+1's copy to the device is issued before step n runs
(``device_prefetch``); the captured steps copy each batch into their
static inputs.

The K-step levers (``cfg.parallel``, the JAX ``ParallelConfig``):
``packed_state`` packs the trained parameters and Adam's state into one
flat buffer (``engine/steps.py::PackedState``; ``self.flat``,
``self.unravel``) and runs the packed step (``packed_train_step``),
with ``host_roundtrip`` sending that buffer to host memory and back
before each step; ``steps_per_dispatch`` K > 1 runs K stacked device
batches a call of the K-step step (``multistep_train_step``, one graph
on the card), the epoch's last ``steps % K`` through the single packed
step; ``device_prefetch`` is the depth of the device copies in flight.

Stage 2 (``train.refine``): the model is a ``PVRaftRefine``, Adam covers
its head only (``weights.trained_parameters``, the JAX ``_refine_mask``:
the backbone gets no Adam state, no gradient and no update), the step is
the refine step (masked L1 of the refined flow), validation and test run
at ``train.iters`` (the reference's ``engine_refine.py:199``), and
:meth:`Trainer.load_stage1_weights` imports a stage-1 checkpoint into the
backbone. Checkpoints hold ``optax.masked``'s state, as the JAX refine
Trainer's do.

Not in this slice: TensorBoard and the event log, divergence snapshots
(the observability slice), data-parallel meshes (the parallel slice).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from pvraft_tpu_torch.config import Config
from pvraft_tpu_torch.data import (
    FT3D,
    PrefetchLoader,
    SyntheticDataset,
    device_prefetch,
    first_batch,
    to_device,
)
from pvraft_tpu_torch.device import resolve_device
from pvraft_tpu_torch.engine.checkpoint import (
    find_checkpoint,
    load_checkpoint,
    load_params,
    save_checkpoint,
)
from pvraft_tpu_torch.engine.schedule import make_lr_schedule
from pvraft_tpu_torch.engine.steps import (
    BATCH_KEYS,
    PackedState,
    init_adam_state,
    make_eval_step,
    make_graphed_eval_step,
    make_graphed_multistep_train_step,
    make_graphed_packed_train_step,
    make_graphed_refine_train_step,
    make_graphed_train_step,
    make_multistep_train_step,
    make_packed_train_step,
    make_refine_train_step,
    make_train_step,
    stack_batches,
)
from pvraft_tpu_torch.models.raft import PVRaft, PVRaftRefine
from pvraft_tpu_torch.rng import torch_seed
from pvraft_tpu_torch.weights import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
    schedule_count,
    seeded_state_dict,
    trained_parameters,
)


def build_datasets(cfg: Config):
    """(train, val, test) datasets: FT3D's three splits, or synthetic
    scenes seeded 0/1/2 as in the JAX package. KITTI is eval-only."""
    d = cfg.data
    if d.dataset == "synthetic":
        return tuple(
            SyntheticDataset(size=d.synthetic_size, nb_points=d.max_points,
                             noise=0.01, seed=seed,
                             n_objects=d.synthetic_objects)
            for seed in (0, 1, 2))
    if d.dataset == "FT3D":
        return tuple(FT3D(d.root, d.max_points, mode,
                          strict_sizes=d.strict_sizes)
                     for mode in ("train", "val", "test"))
    if d.dataset == "KITTI":
        raise NotImplementedError(
            "KITTI is eval-only; use the Evaluator or python -m "
            "pvraft_tpu_torch.test")
    raise ValueError(f"unknown dataset {d.dataset!r}")


class Trainer:
    """``Trainer(cfg, device=None, weights=None, opt_state=None,
    graphs=True, capturable=None)``.

    ``weights``: a port state_dict or a JAX flax params tree (mapped by
    :func:`params_from_jax`) of the stage's model (a PVRaftRefine's with
    ``train.refine``); default: seeded from ``cfg.train.seed``'s
    ``model.init`` stream. ``opt_state``: an optax Adam state to resume
    (:func:`opt_state_from_jax`; masked with ``train.refine``). Runs on ``cuda`` unless ``device``
    names another device; raises when no card is present and none was
    named. ``graphs``: the graphed steps (default) or the eager ones.
    ``capturable``: the graphed steps' Adam, its learning rate a tensor
    on ``device`` and, on the card, ``capturable`` (default: with the
    graphed steps).
    """

    def __init__(self, cfg: Config, device: Union[str, torch.device, None] = None,
                 weights: Optional[Mapping] = None, opt_state: Any = None,
                 graphs: bool = True, capturable: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_ds, self.val_ds, self.test_ds = build_datasets(cfg)
        bs = cfg.train.batch_size
        if bs > len(self.train_ds):
            raise ValueError(f"batch size {bs} exceeds the dataset size "
                             f"{len(self.train_ds)}")
        refine = cfg.train.refine
        if weights is None:
            weights = seeded_state_dict(
                cfg.model, torch_seed(cfg.train.seed, "model.init"), refine)
        elif any(isinstance(v, Mapping) for v in weights.values()):
            weights = params_from_jax(weights)
        self.model = (PVRaftRefine if refine else PVRaft)(cfg.model)
        self.model.load_state_dict(weights, strict=True)
        self.model.to(self.device)

        d = cfg.data
        self.train_loader = PrefetchLoader(
            self.train_ds, bs, shuffle=True, drop_last=True,
            num_workers=d.num_workers, seed=cfg.train.seed,
            native=d.native_loader)
        self.val_loader, self.test_loader = (
            PrefetchLoader(ds, 1, drop_last=False,
                           num_workers=min(2, d.num_workers))
            for ds in (self.val_ds, self.test_ds))
        self.steps_per_epoch = max(1, len(self.train_loader))
        self.schedule = make_lr_schedule(
            cfg.train.lr_schedule, cfg.train.lr, cfg.train.num_epochs,
            self.steps_per_epoch, len(self.train_ds))
        if capturable is None:
            capturable = graphs
        lr = self.schedule(0)
        if capturable:
            lr = torch.tensor(lr, device=self.device)
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8.
        self.optimizer = torch.optim.Adam(
            [p for _, p in trained_parameters(self.model)], lr=lr,
            betas=(0.9, 0.999), eps=1e-8,
            capturable=capturable and self.device.type == "cuda")
        if opt_state is not None:
            self.optimizer.load_state_dict(
                opt_state_from_jax(opt_state, self.model, self.optimizer))
        t = cfg.train
        self.ckpt_dir = os.path.join(cfg.exp_path, "checkpoints")
        self.best_epe = float("inf")
        self.begin_epoch = 0
        self.save_s: List[float] = []     # seconds of each checkpoint save
        self._graphs = ()
        # Refine trains and evaluates at train.iters (engine_refine.py:199).
        self.eval_iters = t.iters if refine else t.eval_iters
        levers = {"grad_dtype": t.grad_dtype, "telemetry": t.telemetry}
        par = cfg.parallel
        self.steps_k = par.steps_per_dispatch
        self.multi_step = self.packed = self.flat = self.unravel = None
        if par.packed_state:
            self._build_packed(graphs, levers)
        elif not graphs:
            if refine:
                self.train_step = make_refine_train_step(
                    self.model, self.optimizer, self.schedule, t.iters,
                    **levers)
            else:
                self.train_step = make_train_step(
                    self.model, self.optimizer, self.schedule, t.gamma,
                    t.iters, **levers)
        elif refine:
            self.train_step = make_graphed_refine_train_step(
                self.model, self.optimizer, self.schedule, t.iters,
                self.device, strict_retrace=t.strict_retrace, **levers)
        else:
            self.train_step = make_graphed_train_step(
                self.model, self.optimizer, self.schedule, t.gamma, t.iters,
                self.device, strict_retrace=t.strict_retrace, **levers)
        if not graphs:
            self.eval_step = make_eval_step(self.model, self.eval_iters,
                                            t.gamma, per_scene=True,
                                            refine=refine)
            return
        self.eval_step = make_graphed_eval_step(
            self.model, self.eval_iters, t.gamma, self.device, per_scene=True,
            strict_retrace=t.strict_retrace, refine=refine)
        # Capture at the shapes training and evaluation feed them, from
        # their loaders' first batches: the K-step step at K of them; the
        # single step where it runs (with K > 1: an epoch's tail).
        batch = to_device(first_batch(self.train_loader), self.device)
        scene = to_device(first_batch(self.val_loader), self.device)
        captures = []
        if self.multi_step is None or self.steps_per_epoch % self.steps_k:
            captures.append((self.train_step.graphs,
                             [batch[k] for k in BATCH_KEYS]))
        if self.multi_step is not None:
            captures.append((self.multi_step.graphs, self.multi_step.inputs(
                stack_batches([batch] * self.steps_k))))
        captures.append((self.eval_step.graphs,
                         [scene[k] for k in BATCH_KEYS]))
        self._graphs = tuple(c for c, _ in captures)
        for cache, inputs in captures:
            cache.program_for(inputs)

    def _build_packed(self, graphs: bool, levers: Dict[str, Any]) -> None:
        """The packed single step and, with K > 1, the K-step step, on one
        packed state (``self.flat``)."""
        t, par = self.cfg.train, self.cfg.parallel
        args = (self.model, self.optimizer, self.schedule, t.gamma, t.iters)
        self.packed = PackedState(self.model, self.optimizer)
        common = {"refine": t.refine, "packed": self.packed, **levers}
        if graphs:
            common.update(device=self.device,
                          strict_retrace=t.strict_retrace)
            single, multi = (make_graphed_packed_train_step,
                             make_graphed_multistep_train_step)
        else:
            single, multi = make_packed_train_step, make_multistep_train_step
        self.train_step, self.flat, self.unravel = single(
            *args, host_roundtrip=par.host_roundtrip, **common)
        if self.steps_k > 1:
            self.multi_step, _, _ = multi(*args, self.steps_k, **common)

    def _on_device(self, host_batches):
        """Host batches -> device batches, the copies of the next
        ``parallel.device_prefetch - 1`` issued before the current one is
        consumed."""
        return device_prefetch(host_batches,
                               lambda b: to_device(b, self.device),
                               self.cfg.parallel.device_prefetch)

    def compile_report(self) -> List[Dict[str, Any]]:
        """The captured train and eval programs' records (empty with
        ``graphs=False``)."""
        return [r for g in self._graphs for r in g.report()]

    def training(self, epoch: int) -> Dict[str, Any]:
        """The train steps of one epoch. Returns the mean loss and EPE,
        the step count, each step's loss and EPE, and the epoch's wall
        time per step in ms (host clock, synchronised at the end)."""
        cfg = self.cfg
        self.model.train()
        # Each step's loss and EPE, copied out of the step's outputs (a
        # graphed step overwrites them at the next replay).
        kept = torch.empty(self.steps_per_epoch, 2, device=self.device)
        n = 0

        def keep(m):
            nonlocal n
            j = m["loss"].numel()
            kept[n:n + j, 0].copy_(m["loss"].reshape(j))
            kept[n:n + j, 1].copy_(m["epe"].reshape(j))
            n += j

        # With K > 1: K device batches stacked a call of the K-step step;
        # the tail through the single (packed) step.
        pending: List[Dict[str, torch.Tensor]] = []
        t0 = time.perf_counter()
        for batch in self._on_device(self.train_loader.epoch(epoch)):
            if self.multi_step is None:
                keep(self.train_step(batch))
                continue
            pending.append(batch)
            if len(pending) == self.steps_k:
                keep(self.multi_step(stack_batches(pending)))
                pending = []
        for batch in pending:
            keep(self.train_step(batch))
        # One device-to-host read per epoch, not per step.
        losses, epes = kept[:n].cpu().numpy().T.tolist() if n else ([], [])
        wall_ms = 1e3 * (time.perf_counter() - t0)
        return {"loss": float(np.mean(losses)) if n else float("nan"),
                "epe": float(np.mean(epes)) if n else float("nan"),
                "steps": n, "losses": losses, "epes": epes,
                "step_ms": wall_ms / n if n else 0.0}

    def save(self, epoch: int, checkpoint_interval: int,
             best: bool = False) -> Tuple[str, ...]:
        """Write the model's parameters, Adam's state and the schedule's
        position as ``last_checkpoint`` (``save_checkpoint``'s names:
        also ``{epoch:03d}`` by ``checkpoint_interval``, and
        ``best_checkpoint`` with ``best``);
        returns the paths and appends the seconds it took to
        ``save_s``."""
        t0 = time.perf_counter()
        paths = save_checkpoint(
            self.ckpt_dir, params_to_jax(self.model.state_dict()),
            opt_state_to_jax(self.optimizer, self.model,
                             self.train_step.count[0]),
            epoch, checkpoint_interval, best=best,
            backend=self.cfg.train.ckpt_backend)
        self.save_s.append(time.perf_counter() - t0)
        return paths

    def load_weights(self, path: str, resume: bool = False) -> int:
        """Load a checkpoint's parameters (``tools/engine.py:100-108``)
        and, with ``resume``, Adam's moments and step, the schedule's
        position (the optax state's ``"1"`` count) and ``begin_epoch =
        epoch + 1``. Every value is copied into the tensor that holds it
        now, which is the one a captured step reads. Returns the
        checkpoint's epoch."""
        params, opt_state, epoch = load_checkpoint(path, with_opt_state=resume)
        self.model.load_state_dict(params_from_jax(params), strict=True)
        if resume:
            if opt_state is None:
                raise KeyError(f"{path}: no optimizer state to resume")
            want = opt_state_from_jax(opt_state, self.model,
                                      self.optimizer)["state"]
            init_adam_state(self.optimizer)
            with torch.no_grad():
                for i, (_, p) in enumerate(trained_parameters(self.model)):
                    state = self.optimizer.state[p]
                    for key in ("exp_avg", "exp_avg_sq", "step"):
                        state[key].copy_(want[i][key])
            sched = schedule_count(opt_state)
            self.train_step.count[0] = (int(float(want[0]["step"]))
                                        if sched is None else sched)
            self.begin_epoch = epoch + 1
        self._repack()
        return epoch

    def _repack(self) -> None:
        """Put the parameters and Adam's state back into their slots of
        the packed buffer, which the packed steps read (the JAX
        ``_repack``): anything that replaced one of those tensors
        (``optimizer.load_state_dict``) broke its view."""
        if self.packed is not None:
            self.packed.repack()

    def load_stage1_weights(self, path: str) -> int:
        """Import a stage-1 checkpoint's parameters into the refine
        model's ``backbone`` (``engine_refine.py:110``; the JAX
        ``Trainer.load_stage1_weights``), strictly, copied into the
        tensors the captured steps read. Returns the checkpoint's
        epoch."""
        if not self.cfg.train.refine:
            raise ValueError("load_stage1_weights needs train.refine")
        params, epoch = load_params(path)
        self.model.backbone.load_state_dict(params_from_jax(params),
                                            strict=True)
        return epoch

    def val_test(self, epoch: int, mode: str = "val") -> Dict[str, float]:
        """Means of the per-scene eval metrics over the val (or test) set,
        one scene per step at ``self.eval_iters`` iterations. A val pass
        whose EPE is the lowest so far saves ``best_checkpoint``; the test
        pass
        loads ``best_checkpoint`` first where there is one (the JAX
        ``val_test``, ``engine.py:191``)."""
        loader = self.val_loader if mode == "val" else self.test_loader
        if mode == "test":
            best = find_checkpoint(self.ckpt_dir, "best_checkpoint")
            if best is not None:
                self.load_weights(best)
        self.model.eval()
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in self._on_device(loader.epoch(0)):
            out, _ = self.eval_step(batch)
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + v.sum()
            count += batch["pc1"].shape[0]
        means = {k: float(v) / max(1, count) for k, v in sums.items()}
        if mode == "val" and means["epe3d"] < self.best_epe:
            self.best_epe = means["epe3d"]
            self.save(epoch, 0, best=True)
        return means

    def fit(self, report: Optional[Callable[[int, Dict, Dict], None]] = None
            ) -> Dict[str, float]:
        """Train, save ``last_checkpoint`` (the JAX ``training``'s save)
        and validate every epoch from ``begin_epoch`` (``report(epoch,
        train, val)`` after each), then test once on the best validation
        epoch's weights; returns the test means."""
        for epoch in range(self.begin_epoch, self.cfg.train.num_epochs):
            train = self.training(epoch)
            self.save(epoch, self.cfg.train.checkpoint_interval)
            val = self.val_test(epoch, "val")
            if report is not None:
                report(epoch, train, val)
        return self.val_test(self.cfg.train.num_epochs - 1, "test")
