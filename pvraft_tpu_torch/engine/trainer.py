"""Trainer of both stages (port of ``pvraft_tpu/engine/trainer.py::
Trainer``).

Seeded (or JAX-imported) weights, Adam with the configured
learning-rate schedule, the train step over the shuffled training set
(FT3D's train split, or synthetic scenes), and per-epoch validation at
``eval_iters``, ``eval_batch`` scenes per step (one on one card). ``fit`` trains, saves and
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
shape and the eval step at each of its loaders' batch sizes, each as
one CUDA graph on the card (on the CPU: the same functions on the same
static buffers), with Adam's learning rate a tensor on the trainer's
device and Adam ``capturable`` on the card. ``graphs=False`` takes the eager steps with
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

Observability (the JAX Trainer's): one :class:`~pvraft_tpu_torch.obs.
events.RunTelemetry` (``self.telemetry``) writes the ``pvraft_events/v1``
stream ``exp_path/train.events.jsonl`` (a ``run_header``; per epoch the
``step`` events, flushed at the epoch's end from its one read of the
device, a ``device_memory`` sample on the card, ``epoch_summary``;
``checkpoint``, ``eval``, ``trace_window``, ``divergence``,
``snapshot`` and ``recompile`` records), the reference's TensorBoard
scalars and ``exp_path/logs/Train_<dataset>.log``. A
:class:`~pvraft_tpu_torch.obs.retrace.RetraceWatchdog` watches the train
programs (not the eval step, as in JAX). ``train.telemetry`` arms the
in-step monitors (``metrics["telemetry"]``, written into the ``step``
events) and the divergence detector (``obs/divergence.py``), which reads
the loss and the non-finite count on the host once per optimizer step:
its one cost. Before each step it copies the train state on the device
(the flat buffer in packed mode), and on a trip writes that copy with
the step's batch as a snapshot (at most ``max_snapshots``; none with
``steps_per_dispatch`` > 1, where detection runs per dispatch), emits
the ``divergence`` record (at most :attr:`Trainer.MAX_DIVERGENCE_EVENTS`)
and, under ``halt_on_divergence``, raises
:class:`~pvraft_tpu_torch.obs.divergence.DivergenceHalt` once the
epoch's step events are written: a halted epoch gets no summary and no
checkpoint. ``train.profile_dir``: a ``torch.profiler`` window over the
first epoch, every thread, written there as a Chrome trace
(``profiling/timers.py::trace_context``), between ``trace_window``
records. :meth:`Trainer.close` (``fit`` calls it) closes the stream.
Each ``epoch_summary`` carries a ``cost`` block where the inventory
prices the train step (:meth:`Trainer._step_cost_report`): the measured
step against the flagship train step's roofline, ``step_ratio`` and
``hw_utilization``, never ``comparable`` off a TPU. The inventory is the
``cost_surface`` given, else ``programs/costs.py::default_costs_path()``
looked up once; any failure leaves the block out: observability never
fails training.

Data parallelism (the JAX ``Trainer(cfg, mesh)``; ``parallel/``): one
process per card, as ``torchrun --nproc_per_node=N -m
pvraft_tpu_torch.train`` starts them, on a :class:`~pvraft_tpu_torch.
parallel.mesh.Mesh` of the process group's ranks (``mesh``, default
``make_mesh(parallel.data_axis)``). ``train.batch_size`` is per device:
``batch_contract`` gives the global and the local batch, and the train
loader gives this rank its block of every global batch (``shard=(rank,
world)``). The parameters are broadcast from rank 0 at construction and
after every load (``replicate``), and every train step averages its
gradients, loss and EPE over the ranks in one collective
(``engine/steps.py::GradientAllReduce``): the ranks stay bitwise equal.
Validation and test run ``train.eval_batch`` scenes a step (0: one per
data rank), sharded over the ranks by ``eval_scene_shard`` where that is
exact, and their sums meet in one all-reduce. Rank 0 alone writes
checkpoints (a barrier and a visibility check follow, before any rank
reads one), events, logs and TensorBoard tags. As in JAX, several
processes refuse ``steps_per_dispatch`` > 1 and ``host_roundtrip``, and
take no divergence snapshots; graphs need NCCL (gloo collectives cannot
be captured: with gloo on the card, ``graphs=False``).

Sequence parallelism (the JAX ``Trainer`` on a mesh with a ``seq`` axis,
``ModelConfig.seq_shard``): ``parallel.seq_axis`` ranks share each scene,
rank ``r`` at data index ``r // seq_axis``. The model is
``PVRaft(cfg.model, mesh)`` (``models/raft.py``); the ranks of one data
index load the same block of every batch and each takes its contiguous
rows of every scene's points (``parallel/mesh.py::seq_shard_batch``; a
point count the seq axis does not divide raises). Each step sums the
seq group's gradients and averages over the data axis; the per-scene
eval metrics are summed over the seq group before they meet over the
data axis (``combine_sums``). Stage 2 runs so too: the model is
``PVRaftRefine(cfg.model, mesh)``, whose backbone and head hold this
rank's rows; ``load_stage1_weights`` gives every rank the same backbone.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

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
    checkpoint_paths,
    find_checkpoint,
    load_checkpoint,
    load_params,
    save_checkpoint,
)
from pvraft_tpu_torch.engine.schedule import make_lr_schedule
from pvraft_tpu_torch.engine.steps import (
    ADAM_KEYS,
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
from pvraft_tpu_torch.obs import monitors
from pvraft_tpu_torch.obs.device_memory import sample_device_memory
from pvraft_tpu_torch.obs.divergence import (
    DivergenceDetector,
    DivergenceHalt,
    dump_snapshot,
)
from pvraft_tpu_torch.obs.events import RunTelemetry
from pvraft_tpu_torch.obs.retrace import RetraceWatchdog, signature
from pvraft_tpu_torch.parallel.mesh import (
    Mesh,
    all_true,
    barrier,
    batch_contract,
    check_seq_axis,
    combine_sums,
    eval_scene_shard,
    make_mesh,
    replicate,
    seq_shard_batch,
)
from pvraft_tpu_torch.profiling.timers import StepTimer, trace_context
from pvraft_tpu_torch.programs.costs import CostSurface, hardware_utilization
from pvraft_tpu_torch.programs.partitioning import check_replicated
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


def _check_parallel(cfg: Config, mesh: Mesh, device: torch.device,
                    graphs: bool) -> None:
    """The levers a data-parallel run refuses (the JAX Trainer's
    refusals, and the port's own: graphs need NCCL; a seq axis needs
    ``seq_shard``)."""
    par = cfg.parallel
    check_seq_axis(mesh, cfg.model.seq_shard)
    if mesh.process_count > 1 and par.steps_per_dispatch > 1:
        raise ValueError(
            "parallel.steps_per_dispatch > 1 is single-process only (the "
            "fused mode stacks every process's device batches into one "
            "graph, as the JAX Trainer refuses); set steps_per_dispatch=1 "
            "on multi-process runs")
    if mesh.process_count > 1 and par.host_roundtrip:
        raise ValueError(
            "parallel.host_roundtrip is single-host only (it round-trips "
            "the full train state through this process's host memory); "
            "disable it on multi-process runs")
    if (graphs and device.type == "cuda" and mesh.data_group is not None
            and dist.get_backend(mesh.data_group) != "nccl"):
        raise ValueError(
            f"graphed train steps need NCCL: a "
            f"{dist.get_backend(mesh.data_group)} collective cannot be "
            f"captured in a CUDA graph; pass graphs=False for the eager "
            f"steps on that backend")


class Trainer:
    """``Trainer(cfg, device=None, weights=None, opt_state=None,
    graphs=True, capturable=None, cost_surface=None, mesh=None)``.

    ``weights``: a port state_dict or a JAX flax params tree (mapped by
    :func:`params_from_jax`) of the stage's model (a PVRaftRefine's with
    ``train.refine``); default: seeded from ``cfg.train.seed``'s
    ``model.init`` stream. ``opt_state``: an optax Adam state to resume
    (:func:`opt_state_from_jax`; masked with ``train.refine``). Runs on ``cuda`` unless ``device``
    names another device; raises when no card is present and none was
    named. ``graphs``: the graphed steps (default) or the eager ones.
    ``capturable``: the graphed steps' Adam, its learning rate a tensor
    on ``device`` and, on the card, ``capturable`` (default: with the
    graphed steps). ``cost_surface``: the inventory that prices the
    ``epoch_summary``'s ``cost`` block, a ``CostSurface`` or a path
    (default: ``programs/costs.py::default_costs_path()``, where it
    exists). ``mesh``: the data-parallel layout of the process group's
    ranks (default: ``make_mesh`` of ``cfg.parallel.data_axis``).
    """

    # Divergence records a run emits before it mutes them (snapshots are
    # bounded by TrainConfig.max_snapshots): once the state is corrupt
    # every later step trips again.
    MAX_DIVERGENCE_EVENTS = 10

    def __init__(self, cfg: Config, device: Union[str, torch.device, None] = None,
                 weights: Optional[Mapping] = None, opt_state: Any = None,
                 graphs: bool = True, capturable: Optional[bool] = None,
                 cost_surface: Any = None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        # The cost block's inventory: looked up at the first epoch's end.
        self._cost_surface: Any = cost_surface
        # The last cost block's step_ratio and hw_utilization unrounded.
        self.step_cost: Optional[Dict[str, Any]] = None
        self.device = resolve_device(device)
        par = cfg.parallel
        self.mesh = mesh = mesh if mesh is not None else make_mesh(
            None if par.data_axis < 0 else par.data_axis, par.seq_axis)
        _check_parallel(cfg, mesh, self.device, graphs)
        self.telemetry = RunTelemetry(cfg.exp_path, "Train", cfg.data.dataset,
                                      enabled=mesh.process_index == 0)
        self.log = self.telemetry.log
        self.tb = self.telemetry.tb
        self.telemetry.emit_header(cfg, mode="train")
        # Whatever raises after this point leaves no open sink behind.
        try:
            self._build(weights, opt_state, graphs, capturable)
        except BaseException:
            self.telemetry.close()
            raise

    def _build(self, weights: Optional[Mapping], opt_state: Any,
               graphs: bool, capturable: Optional[bool]) -> None:
        """The rest of ``__init__``, once the telemetry is open: the
        datasets, the model, the optimizer, the steps and their
        captures."""
        cfg, mesh = self.cfg, self.mesh
        t, par = cfg.train, cfg.parallel
        self.detector = (DivergenceDetector(t.divergence_window,
                                            t.divergence_zscore)
                         if t.telemetry else None)
        self.snap_dir = os.path.join(cfg.exp_path, "snapshots")
        self.snapshots_taken = 0
        self.trips_emitted = 0
        self.step_count = 0       # optimizer steps before this epoch
        self._epoch_steps = 0     # steps the detector has seen this epoch
        self._held: List[torch.Tensor] = []   # the pre-step state's copy
        # A snapshot holds this process's batch only: one process alone.
        self._snap_capable = mesh.process_count == 1
        if t.telemetry and not self._snap_capable:
            self.log.info(
                "telemetry: divergence snapshots disabled on multi-process "
                "runs (the offending global batch is not host-addressable); "
                "monitors + detection stay on")
        if t.telemetry and cfg.parallel.steps_per_dispatch > 1:
            self.log.info(
                "telemetry: divergence snapshots disabled with "
                "steps_per_dispatch > 1 (per-step pre-states never exist "
                "outside the fused scan); monitors + detection stay on at "
                "dispatch granularity")
        self.train_ds, self.val_ds, self.test_ds = build_datasets(cfg)
        n_data, n_proc = mesh.shape["data"], mesh.process_count
        self.global_batch, bs = batch_contract(t.batch_size, mesh)
        self.log.info(
            f"mesh {mesh.shape}: per-device batch {t.batch_size} -> global "
            f"batch {self.global_batch}"
            + (f" ({bs}/process x {n_proc})" if n_proc > 1 else "")
            + (f", each scene's points over {mesh.n_seq} ranks"
               if mesh.n_seq > 1 else ""))
        if self.global_batch > len(self.train_ds):
            raise ValueError(
                f"global batch {self.global_batch} (= {t.batch_size}/device "
                f"x {n_data} devices) exceeds dataset size "
                f"{len(self.train_ds)}; use a smaller mesh or per-device "
                f"batch")
        refine = cfg.train.refine
        if weights is None:
            weights = seeded_state_dict(
                cfg.model, torch_seed(cfg.train.seed, "model.init"), refine)
        elif any(isinstance(v, Mapping) for v in weights.values()):
            weights = params_from_jax(weights)
        self.model = (PVRaftRefine if refine else PVRaft)(cfg.model, mesh)
        self.model.load_state_dict(weights, strict=True)
        self.model.to(self.device)
        # Every leaf replicates (the rules' specs are all ()); the refine
        # head, which no rule names, replicates too.
        check_replicated(self.model.backbone if refine else self.model)
        replicate(self.model, mesh)

        d = cfg.data
        self.train_loader = PrefetchLoader(
            self.train_ds, bs, shuffle=True, drop_last=True,
            num_workers=d.num_workers, seed=cfg.train.seed,
            native=d.native_loader,
            shard=(mesh.data_index, mesh.data_shares))
        # eval_batch scenes a step, per-scene metrics (0: one scene per
        # data rank); scene-sharded over the processes where exact.
        self.eval_batch = max(1, n_data if t.eval_batch <= 0
                              else t.eval_batch)
        self.eval_shards = {
            mode: eval_scene_shard(len(ds), self.eval_batch, mesh)
            for mode, ds in (("val", self.val_ds), ("test", self.test_ds))}
        self.val_loader, self.test_loader = (
            PrefetchLoader(ds, self.eval_batch, drop_last=False,
                           num_workers=min(2, d.num_workers),
                           shard=self.eval_shards[mode])
            for mode, ds in (("val", self.val_ds), ("test", self.test_ds)))
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
        self.ckpt_dir = os.path.join(cfg.exp_path, "checkpoints")
        self.best_epe = float("inf")
        self.begin_epoch = 0
        self.save_s: List[float] = []     # seconds of each checkpoint save
        self._graphs = ()
        # Refine trains and evaluates at train.iters (engine_refine.py:199).
        self.eval_iters = t.iters if refine else t.eval_iters
        levers = {"grad_dtype": t.grad_dtype, "telemetry": t.telemetry}
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
        else:
            self.eval_step = make_graphed_eval_step(
                self.model, self.eval_iters, t.gamma, self.device,
                per_scene=True, strict_retrace=t.strict_retrace,
                refine=refine)
            self._capture()
        # The train programs' retraces become `recompile` records (strict:
        # RetraceError); the eval step is not watched, as in JAX.
        self.retrace = RetraceWatchdog(emit=self.telemetry.emit_recompile,
                                       strict=t.strict_retrace,
                                       context="train")
        for step in (self.train_step, self.multi_step):
            graphs_of = getattr(step, "graphs", None)
            if graphs_of is not None:
                self.retrace.watch(graphs_of.name, graphs_of)

    def _eval_sizes(self) -> List[int]:
        """The batch sizes the val and test loaders give: ``eval_batch``
        and each loader's smaller tail batch."""
        sizes = {self.eval_batch}
        for mode, ds in (("val", self.val_ds), ("test", self.test_ds)):
            tail = (len(ds) // self.eval_shards[mode][1]) % self.eval_batch
            sizes |= {tail} if tail else set()
        return sorted(sizes, reverse=True)

    def _capture(self) -> None:
        """Capture the steps at the shapes training and evaluation feed
        them, from their loaders' first batches: the K-step step at K of
        them; the single step where it runs (with K > 1: an epoch's
        tail); the eval step at every batch size of the val and test
        loaders."""
        batch = self._put(first_batch(self.train_loader))
        scenes = self._put(first_batch(self.val_loader))
        captures = []
        if self.multi_step is None or self.steps_per_epoch % self.steps_k:
            captures.append((self.train_step.graphs,
                             [batch[k] for k in BATCH_KEYS]))
        if self.multi_step is not None:
            captures.append((self.multi_step.graphs, self.multi_step.inputs(
                stack_batches([batch] * self.steps_k))))
        for size in self._eval_sizes():
            if size <= scenes["pc1"].shape[0]:
                captures.append((self.eval_step.graphs,
                                 [scenes[k][:size] for k in BATCH_KEYS]))
        self._graphs = tuple(dict.fromkeys(c for c, _ in captures))
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
        """Host batches -> (host batch, device batch) pairs, the copies of
        the next ``parallel.device_prefetch - 1`` issued before the
        current one is consumed."""
        return device_prefetch(host_batches, lambda b: (b, self._put(b)),
                               self.cfg.parallel.device_prefetch)

    def _put(self, host_batch):
        """A host batch on the device: this rank's rows of its scenes
        (all of them without a seq axis)."""
        return to_device(seq_shard_batch(host_batch, self.mesh), self.device)

    def compile_report(self) -> List[Dict[str, Any]]:
        """The captured train and eval programs' records (empty with
        ``graphs=False``)."""
        return [r for g in self._graphs for r in g.report()]

    # -- divergence: pre-step state copies and trips -----------------------

    def _trained(self) -> List[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _capture_state(self) -> Tuple[Any, int]:
        """A copy on the device of the train state before the next step
        (the flat buffer in packed mode; else the trained parameters and
        Adam's state) and the schedule's position. The copy goes into
        buffers kept from step to step, in one multi-tensor copy: no
        allocation, a few launches, nothing read to the host."""
        count = self.train_step.count[0]
        if self.packed is not None:
            src = [self.packed.flat]
        else:
            init_adam_state(self.optimizer)
            trained = self._trained()
            src = trained + [self.optimizer.state[p][k] for p in trained
                             for k in ADAM_KEYS]
        if len(self._held) != len(src):
            self._held = [torch.empty_like(t) for t in src]
        with torch.no_grad():
            torch._foreach_copy_(self._held, src)
        return (self._held[0] if self.packed is not None
                else self._held), count

    def _state_trees(self, state: Tuple[Any, int]):
        """A :meth:`_capture_state` copy as the flax state-dict trees of
        the parameters and the optax state (``params_to_jax``,
        ``opt_state_to_jax``), read to the host."""
        copy, count = state
        trained = self._trained()
        if self.packed is not None:
            params, adam = self.packed.unravel(copy)
        else:
            n = len(trained)
            names = dict((id(p), name)
                         for name, p in trained_parameters(self.model))
            params = {names[id(p)]: c for p, c in zip(trained, copy[:n])}
            adam = [dict(zip(ADAM_KEYS, copy[n + 3 * j:n + 3 * j + 3]))
                    for j in range(n)]
        full = {name: params.get(name, p)
                for name, p in self.model.named_parameters()}
        held = SimpleNamespace(state=dict(zip(trained, adam)))
        return (params_to_jax(full),
                opt_state_to_jax(held, self.model, count))

    def _handle_trip(self, trip, epoch: int, step: int, prev_state,
                     host_batch) -> None:
        """One firing of the detector: a snapshot where the step's batch
        and pre-step state were kept and the budget allows, the
        ``divergence`` record, and under ``halt_on_divergence``
        :class:`DivergenceHalt`."""
        if self.trips_emitted >= self.MAX_DIVERGENCE_EVENTS:
            return
        self.trips_emitted += 1
        t = self.cfg.train
        snap_path = None
        if (prev_state is not None and host_batch is not None
                and self.snapshots_taken < t.max_snapshots):
            params, opt_state = self._state_trees(prev_state)
            snap_path = dump_snapshot(
                self.snap_dir, host_batch, params, opt_state, step=step,
                epoch=epoch, reason=trip.reason, loss=trip.loss, cfg=self.cfg,
                extra_meta={"zscore": trip.zscore, "schedule": {
                    "steps_per_epoch": self.steps_per_epoch,
                    "dataset_size": len(self.train_ds)}})
            self.snapshots_taken += 1
            self.telemetry.emit_snapshot(epoch, step, snap_path, trip.reason)
        self.telemetry.emit_divergence(epoch, step, trip.reason, trip.loss,
                                       zscore=trip.zscore,
                                       snapshot=snap_path)
        if self.trips_emitted == self.MAX_DIVERGENCE_EVENTS:
            self.log.info(
                f"telemetry: {self.trips_emitted} divergence events "
                "emitted; muting further divergence reporting for this run "
                "(state is likely persistently corrupt — see the first "
                "snapshot)")
        if t.halt_on_divergence:
            raise DivergenceHalt(
                f"training diverged at epoch {epoch} step {step} "
                f"({trip.reason}, loss={trip.loss})"
                + (f"; snapshot dumped to {snap_path} — replay with "
                   f"python -m pvraft_tpu_torch.doctor" if snap_path else ""))

    # -- loops ---------------------------------------------------------------

    def dispatch(self, step: Callable, batch: Dict[str, torch.Tensor],
                 epoch: int = 0, host_batch=None,
                 keep: Optional[Callable[[Dict], None]] = None):
        """One call of a train step (``self.train_step`` or
        ``self.multi_step``) as an epoch makes it: under
        ``train.telemetry`` a device copy of the state first (one step a
        call, while the snapshot budget lasts), then the step,
        ``keep(metrics)``, the retrace check, and the armed detector's
        one host read of the loss and the non-finite count
        (:meth:`_observe`), which may raise :class:`DivergenceHalt`.
        Returns the step's metrics."""
        armed = self.detector is not None
        prev = (self._capture_state()
                if armed and self.multi_step is None and self._snap_capable
                and self.snapshots_taken < self.cfg.train.max_snapshots
                else None)
        m = step(batch)
        if keep is not None:
            keep(m)
        self.retrace.check(signature=lambda: signature(
            [batch[k] for k in BATCH_KEYS]))
        if armed:
            self._observe(m, epoch, host_batch, prev)
        return m

    def _observe(self, m, epoch: int, host_batch, prev_state) -> None:
        losses, nonfinite = torch.stack([
            m["loss"].reshape(-1).float(),
            m["telemetry"]["nonfinite"].reshape(-1).float()]).tolist()
        for loss, bad in zip(losses, nonfinite):
            self._epoch_steps += 1
            trip = self.detector.update(loss, int(bad))
            if trip is not None:
                self._handle_trip(trip, epoch,
                                  self.step_count + self._epoch_steps,
                                  prev_state, host_batch)

    def training(self, epoch: int) -> Dict[str, Any]:
        """The train steps of one epoch. Returns the mean loss and EPE,
        the step count, each step's loss and EPE, and the epoch's wall
        time per step in ms (host clock, synchronised at the end). Writes
        the epoch's ``step`` events (with their telemetry) and its
        ``epoch_summary``; raises :class:`DivergenceHalt` after the step
        events under ``halt_on_divergence``."""
        t = self.cfg.train
        self.model.train()
        # Each step's loss and EPE, copied out of the step's outputs (a
        # graphed step overwrites them at the next replay), and each
        # step's telemetry as one row.
        kept = torch.empty(self.steps_per_epoch, 2, device=self.device)
        rows: List[torch.Tensor] = []
        layout: List[Any] = []
        n = 0
        self._epoch_steps = 0

        def keep(m):
            nonlocal n
            j = m["loss"].numel()
            kept[n:n + j, 0].copy_(m["loss"].reshape(j))
            kept[n:n + j, 1].copy_(m["epe"].reshape(j))
            n += j
            if "telemetry" in m:
                rows.append(monitors.step_rows(m["telemetry"], j))
                layout[:] = layout or [m["telemetry"], j]

        profile = t.profile_dir if epoch == self.begin_epoch else ""
        timer = StepTimer()
        halt: Optional[DivergenceHalt] = None
        with trace_context(profile) as window:
            if window is not None:
                self.telemetry.emit_trace_window("start", profile, epoch)
            timer.start()
            # With K > 1: K device batches stacked a call of the K-step
            # step; the tail through the single (packed) step.
            pending: List[Dict[str, torch.Tensor]] = []
            try:
                for host, batch in self._on_device(
                        self.train_loader.epoch(epoch)):
                    if self.multi_step is None:
                        self.dispatch(self.train_step, batch, epoch, host,
                                      keep)
                        continue
                    pending.append(batch)
                    if len(pending) == self.steps_k:
                        self.dispatch(self.multi_step,
                                      stack_batches(pending), epoch,
                                      keep=keep)
                        pending = []
                for batch in pending:
                    self.dispatch(self.train_step, batch, epoch, keep=keep)
            except DivergenceHalt as e:
                halt = e
            timer.stop(kept)
        if profile:
            self.telemetry.emit_trace_window("stop", profile, epoch)
        # One device-to-host read per epoch, not per step.
        losses, epes = kept[:n].cpu().numpy().T.tolist() if n else ([], [])
        tels = (monitors.host_records(layout[0], layout[1],
                                      torch.cat(rows).cpu().tolist())
                if rows else [None] * n)
        for i, (loss, epe, tel) in enumerate(zip(losses, epes, tels)):
            self.telemetry.emit_step(epoch, self.step_count + i + 1, loss,
                                     epe, telemetry=tel)
        self.step_count += n
        devmem = sample_device_memory()
        if devmem:
            self.telemetry.emit_device_memory(devmem, context="train")
        if halt is not None:
            raise halt
        step_ms = 1e3 * timer.mean / n if n else 0.0
        out = {"loss": float(np.mean(losses)) if n else float("nan"),
               "epe": float(np.mean(epes)) if n else float("nan"),
               "steps": n, "losses": losses, "epes": epes,
               "step_ms": step_ms}
        if n:
            cost = self._step_cost_report(step_ms / 1e3)
            self.telemetry.emit_epoch_summary(
                epoch, steps=n, loss=out["loss"], epe=out["epe"],
                step_ms=round(step_ms, 3),
                **({"cost": cost} if cost is not None else {}))
            self.log.info(f"epoch {epoch}: loss {out['loss']:.4f} epe "
                          f"{out['epe']:.4f} step {step_ms:.1f} ms")
        else:
            self.telemetry.emit_epoch_summary(epoch, steps=0)
            self.log.info(f"epoch {epoch}: steps=0 (empty epoch — loader "
                          "yielded no batches)")
        return out

    def _step_cost_report(self, step_s: float) -> Optional[Dict[str, Any]]:
        """The ``epoch_summary`` ``cost`` block (the JAX Trainer's): the
        measured step seconds beside the inventory's flagship train step
        at the model's compute dtype (``CostSurface.lookup_train_step``),
        its roofline seconds, their ratio and the hardware utilization
        its flops give, rounded (the JAX block's digits; ``step_cost``
        keeps the two unrounded). A run at another shape reads the ratio
        as scale evidence. Any failure gives None."""
        if self._cost_surface is None or isinstance(self._cost_surface, str):
            try:
                self._cost_surface = CostSurface.load(self._cost_surface)
            except Exception:  # noqa: BLE001 — observability must not fail training
                self._cost_surface = False
        surface = self._cost_surface
        if surface is False or step_s <= 0:
            return None
        dtype = self.cfg.model.compute_dtype or "float32"
        rec = surface.lookup_train_step(dtype)
        if rec is None or rec.device_seconds <= 0:
            return None
        platform = "gpu" if self.device.type == "cuda" else self.device.type
        util = hardware_utilization(rec.flops, step_s, dtype)
        ratio = step_s / rec.device_seconds
        self.step_cost = {"step_ratio": ratio, "hw_utilization": util}
        return {
            "program": rec.name,
            "basis": rec.basis,
            "predicted_step_ms": round(rec.device_seconds * 1e3, 3),
            "step_ratio": round(ratio, 4),
            "hw_utilization": round(util, 6) if util is not None else None,
            "platform": platform,
            "comparable": platform == "tpu" and rec.comparable,
        }

    def save(self, epoch: int, checkpoint_interval: int,
             best: bool = False) -> Tuple[str, ...]:
        """Write the model's parameters, Adam's state and the schedule's
        position as ``last_checkpoint`` (``save_checkpoint``'s names:
        also ``{epoch:03d}`` by ``checkpoint_interval``, and
        ``best_checkpoint`` with ``best``);
        returns the paths and appends the seconds it took to
        ``save_s``. On several processes rank 0 alone writes (the ranks
        hold the same state), then every rank waits for it and checks
        that the file is there: a rank that cannot see it fails with
        every other (the JAX package's one writer, barrier and
        visibility check; ``exp_path`` must be shared)."""
        t0 = time.perf_counter()
        if self.mesh.process_index == 0:
            paths = save_checkpoint(
                self.ckpt_dir, params_to_jax(self.model.state_dict()),
                opt_state_to_jax(self.optimizer, self.model,
                                 self.train_step.count[0]),
                epoch, checkpoint_interval, best=best,
                backend=self.cfg.train.ckpt_backend)
        if self.mesh.process_count > 1:
            barrier(self.mesh)
            if self.mesh.process_index != 0:
                paths = checkpoint_paths(self.ckpt_dir, epoch,
                                         checkpoint_interval, best)
            seen = os.path.exists(paths[0])
            for _ in range(10):
                if seen:
                    break
                time.sleep(0.5)
                seen = os.path.exists(paths[0])
            if not all_true(seen, self.mesh, self.device):
                raise RuntimeError(
                    f"checkpoint {paths[0]} written by process 0 is not "
                    "visible on every process: multi-process checkpoints "
                    "need a shared exp_path")
        self.save_s.append(time.perf_counter() - t0)
        self.telemetry.emit_checkpoint(epoch, "best" if best else "last",
                                       path=self.ckpt_dir)
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
            # The step events' axis continues across restarts.
            self.step_count = self.begin_epoch * self.steps_per_epoch
        replicate(self.model, self.mesh)
        self._repack()
        self.log.info(f"loaded weights from {path} (epoch {epoch})")
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
        replicate(self.model, self.mesh)
        self.log.info(f"imported stage-1 weights from {path} (epoch {epoch})")
        return epoch

    def val_test(self, epoch: int, mode: str = "val") -> Dict[str, float]:
        """Means of the per-scene eval metrics over the val (or test) set,
        ``self.eval_batch`` scenes a step at ``self.eval_iters``
        iterations, summed scene by scene and, on several processes,
        over the ranks (``parallel/mesh.py::combine_sums``). A val pass
        whose EPE is the lowest so far saves ``best_checkpoint``; the
        test pass loads ``best_checkpoint`` first where there is one (the
        JAX ``val_test``, ``engine.py:191``)."""
        loader = self.val_loader if mode == "val" else self.test_loader
        if mode == "test":
            best = find_checkpoint(self.ckpt_dir, "best_checkpoint")
            if best is not None:
                self.load_weights(best)
        self.model.eval()
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        t0 = time.perf_counter()
        for _, batch in self._on_device(loader.epoch(0)):
            out, _ = self.eval_step(batch)
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + v.sum()
            count += batch["pc1"].shape[0]
        sums, count = combine_sums(sums, count, self.mesh,
                                   self.eval_shards[mode][1])
        means = {k: float(v) / max(1, count) for k, v in sums.items()}
        eval_s = time.perf_counter() - t0
        self.log.info(f"{mode} epoch {epoch}: {count} scenes in "
                      f"{eval_s:.1f}s ({count / max(eval_s, 1e-9):.1f} "
                      f"scenes/s, eval_batch={self.eval_batch})")
        self.telemetry.emit_eval(mode, epoch, count, means)
        self.log.info(f"{mode} epoch {epoch}: " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(means.items())))
        if mode == "val" and means.get("epe3d", float("inf")) < self.best_epe:
            self.best_epe = means["epe3d"]
            self.save(epoch, 0, best=True)
        return means

    def fit(self, report: Optional[Callable[[int, Dict, Dict], None]] = None
            ) -> Dict[str, float]:
        """Train, save ``last_checkpoint`` (the JAX ``training``'s save)
        and validate every epoch from ``begin_epoch`` (``report(epoch,
        train, val)`` after each), then test once on the best validation
        epoch's weights and :meth:`close`; returns the test means."""
        for epoch in range(self.begin_epoch, self.cfg.train.num_epochs):
            train = self.training(epoch)
            self.save(epoch, self.cfg.train.checkpoint_interval)
            val = self.val_test(epoch, "val")
            if report is not None:
                report(epoch, train, val)
        result = self.val_test(self.cfg.train.num_epochs - 1, "test")
        self.close()
        return result

    def close(self) -> None:
        """Close the telemetry sink (the event stream, the TensorBoard
        writer, the log file). Idempotent; a Trainer used without ``fit``
        should be closed when done."""
        self.telemetry.close()
