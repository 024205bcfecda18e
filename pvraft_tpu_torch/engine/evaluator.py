"""Standalone evaluation (port of ``pvraft_tpu/engine/evaluator.py::
Evaluator``, the reference's ``test.py:70-156``).

The reference protocol: the per-scene metrics at ``eval_iters`` (32) GRU
iterations, their running means, and an optional dump of each scene's
``pc1``, ``pc2`` and flow as ``<dump_dir>/<dataset>/<idx>/{pc1,pc2,
flow}.npy`` (the layout the reference's ``visual.py`` reads). As in the
JAX ``Evaluator``, ``TrainConfig.eval_batch`` scenes run as one batch a
step (0: one scene per data rank), each with its own mask and metrics,
so the running means are those of the reference's one-scene loop. The
eval step is the graphed one (``engine/steps.py::
make_graphed_eval_step``), captured at construction at ``eval_batch``
and at the dataset's smaller tail batch. The running sums add each
step's scenes in dataset order, as ``Trainer.val_test`` does, so the
means equal the trainer's test pass on the same weights to the bit.

On several processes (``mesh``, ``parallel/``) the scenes are sharded
over the ranks where ``eval_scene_shard`` says that is exact, and the
sums and counts of every rank meet in one collective at the end
(``parallel/mesh.py::combine_sums``); rank 0 alone writes the log, the
stream and the tags. ``dump_dir`` is single-process, as in JAX.
On a mesh with a seq axis (``ModelConfig.seq_shard``, the test CLI's
``--seq_parallel``) the ranks of a seq group evaluate the same scenes,
each on its rows of their points (``parallel/mesh.py::
seq_shard_batch``), and their per-scene metrics are summed over the
group before the data axis's collective. With gloo on the card the eval
step there runs eagerly (``graphs=False``): a gloo collective cannot be
captured.

With ``TrainConfig.refine`` the model is a ``PVRaftRefine`` and the
step the refine eval step (the masked L1 and the metrics of the refined
flow), still at ``eval_iters``, as the JAX ``Evaluator`` runs it (the
Trainer's own refine validation runs at ``train.iters``).

``TrainConfig.eval_scan`` is accepted, so that configs shared with the
JAX package load, and changes nothing: the JAX ``Evaluator`` runs S
batches per dispatch through a ``lax.scan`` to save the per-batch
dispatches, and a replay of the port's captured step is already one
launch per batch.

The datasets are the JAX ``build_eval_dataset``'s: FT3D's test split
(``val/``), KITTI's 142 scenes (zero-shot, the reference protocol), or
synthetic scenes from seed 2. They come through a
:class:`~pvraft_tpu_torch.data.PrefetchLoader` with ``min(2,
num_workers)`` threads, each scene's copy to the device issued before the
previous scene's step runs.

Like the JAX ``Evaluator`` it writes a ``pvraft_events/v1`` stream,
``exp_path/testalone.events.jsonl`` (a ``run_header`` of mode
``"eval"`` and one ``eval`` record, epoch -1), the ``<Dataset>/...``
TensorBoard scalars and ``exp_path/logs/TestAlone_<dataset>.log``,
whose ``[count/n] k=v ...`` lines give the running means every
``log_every`` scenes: the only reads of the device before the end.
:meth:`Evaluator.close` closes them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from pvraft_tpu_torch.config import Config
from pvraft_tpu_torch.data import (
    FT3D,
    KITTI,
    PrefetchLoader,
    SyntheticDataset,
    device_prefetch,
    first_batch,
    to_device,
)
from pvraft_tpu_torch.device import resolve_device
from pvraft_tpu_torch.engine.checkpoint import (
    load_checkpoint,
    load_torch_checkpoint,
)
from pvraft_tpu_torch.engine.steps import (
    BATCH_KEYS,
    make_eval_step,
    make_graphed_eval_step,
)
from pvraft_tpu_torch.models.raft import PVRaft, PVRaftRefine
from pvraft_tpu_torch.obs.events import RunTelemetry
from pvraft_tpu_torch.parallel.mesh import (
    Mesh,
    check_seq_axis,
    combine_sums,
    eval_scene_shard,
    make_mesh,
    replicate,
    seq_shard_batch,
)
from pvraft_tpu_torch.rng import torch_seed
from pvraft_tpu_torch.weights import params_from_jax, seeded_state_dict


def build_eval_dataset(cfg: Config):
    """The evaluation set: FT3D's test split, KITTI, or synthetic scenes
    from seed 2."""
    d = cfg.data
    if d.dataset == "FT3D":
        return FT3D(d.root, d.max_points, "test", strict_sizes=d.strict_sizes)
    if d.dataset == "KITTI":
        return KITTI(d.root, d.max_points, strict_sizes=d.strict_sizes)
    if d.dataset == "synthetic":
        return SyntheticDataset(size=d.synthetic_size, nb_points=d.max_points,
                                noise=0.01, seed=2,
                                n_objects=d.synthetic_objects)
    raise ValueError(f"unknown dataset {d.dataset!r}")


def _check_seq(cfg: Config, mesh: Mesh, device: torch.device,
               graphs: bool) -> None:
    """What a seq axis refuses (``check_seq_axis``), and a captured step
    over a gloo seq group on the card."""
    check_seq_axis(mesh, cfg.model.seq_shard)
    if (graphs and device.type == "cuda" and mesh.seq_group is not None
            and dist.get_backend(mesh.seq_group) != "nccl"):
        raise ValueError(
            f"a captured eval step on a seq axis needs NCCL: a "
            f"{dist.get_backend(mesh.seq_group)} collective cannot be "
            f"captured in a CUDA graph; pass graphs=False")


class Evaluator:
    """``Evaluator(cfg, device=None, mesh=None)``: the eval dataset, a
    PVRaft (a PVRaftRefine with ``train.refine``) with seeded weights
    (``cfg.train.seed``'s ``model.init`` stream, as the Trainer seeds it)
    until :meth:`load` or :meth:`load_torch`, and the captured eval
    program. Runs on ``cuda`` unless ``device`` names another device.
    ``mesh``: the ranks (default: every rank of the process group on the
    data axis, as the JAX ``make_mesh(n_seq=1)``). ``graphs``: the
    captured eval step (default) or the eager one, which a seq axis needs
    on the card where its backend is not NCCL."""

    def __init__(self, cfg: Config,
                 device: Union[str, torch.device, None] = None,
                 mesh: Optional[Mesh] = None, graphs: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        _check_seq(cfg, self.mesh, self.device, graphs)
        self.telemetry = RunTelemetry(cfg.exp_path, "TestAlone",
                                      cfg.data.dataset,
                                      enabled=self.mesh.process_index == 0)
        self.log = self.telemetry.log
        self.telemetry.emit_header(cfg, mode="eval")
        self.dataset = build_eval_dataset(cfg)
        t = cfg.train
        self.eval_batch = max(1, self.mesh.shape["data"]
                              if t.eval_batch <= 0 else t.eval_batch)
        self.shard = eval_scene_shard(len(self.dataset), self.eval_batch,
                                      self.mesh)
        self.loader = PrefetchLoader(
            self.dataset, self.eval_batch, drop_last=False,
            num_workers=min(2, cfg.data.num_workers), shard=self.shard)
        self.model = (PVRaftRefine if t.refine else PVRaft)(cfg.model,
                                                            self.mesh)
        self.model.load_state_dict(seeded_state_dict(
            cfg.model, torch_seed(t.seed, "model.init"), t.refine),
            strict=True)
        self.model.to(self.device).eval()
        replicate(self.model, self.mesh)
        self.epoch: Optional[int] = None
        if not graphs:
            self.eval_step = make_eval_step(
                self.model, t.eval_iters, t.gamma, per_scene=True,
                refine=t.refine)
            return
        self.eval_step = make_graphed_eval_step(
            self.model, t.eval_iters, t.gamma, self.device, per_scene=True,
            strict_retrace=t.strict_retrace, refine=t.refine)
        scenes = self._put(first_batch(self.loader))
        tail = (len(self.dataset) // self.shard[1]) % self.eval_batch
        for size in sorted({scenes["pc1"].shape[0], tail} - {0},
                           reverse=True):
            self.eval_step.graphs.program_for(
                [scenes[k][:size] for k in BATCH_KEYS])

    def _put(self, host_batch):
        """A host batch on the device: this rank's rows of its scenes."""
        return to_device(seq_shard_batch(host_batch, self.mesh), self.device)

    def compile_report(self):
        """The captured program's records (none with ``graphs=False``)."""
        graphs = getattr(self.eval_step, "graphs", None)
        return graphs.report() if graphs is not None else []

    def load(self, path: str) -> int:
        """Load a checkpoint's parameters (the port's or the JAX
        package's msgpack file), in place; returns its epoch."""
        params, _, self.epoch = load_checkpoint(path, with_opt_state=False)
        self.model.load_state_dict(params_from_jax(params), strict=True)
        replicate(self.model, self.mesh)
        self.log.info(f"loaded checkpoint {path} (epoch {self.epoch})")
        return self.epoch

    def load_torch(self, path: str) -> int:
        """Load a reference-published torch ``.params`` checkpoint
        (``test.py:101-106``), in place; returns its epoch."""
        state, self.epoch = load_torch_checkpoint(
            path, refine=self.cfg.train.refine)
        self.model.load_state_dict(state, strict=True)
        replicate(self.model, self.mesh)
        self.log.info(f"imported torch checkpoint {path} (epoch "
                      f"{self.epoch})")
        return self.epoch

    def run(self, dump_dir: Optional[str] = None,
            log_every: int = 50) -> Dict[str, float]:
        """The running means of the per-scene metrics over the dataset.
        ``dump_dir`` (one process only) writes each scene's clouds and
        flow. Every ``log_every`` scenes (0: never) the running means of
        this rank's scenes go to the log, as ``[count/n] k=v ...``."""
        if dump_dir is not None and self.mesh.process_count > 1:
            raise ValueError(
                "--dump_dir is single-host only; re-run eval on one host "
                "to dump scenes for visualization")
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        n_scenes = len(self.dataset) // self.shard[1]
        for batch, scene in device_prefetch(
                self.loader.epoch(0),
                lambda b: (b, self._put(b))):
            metrics, flow = self.eval_step(scene)
            if dump_dir is not None:
                flow = flow.cpu().numpy()
                for row in range(flow.shape[0]):
                    scene = os.path.join(dump_dir, self.cfg.data.dataset,
                                         str(count + row))
                    os.makedirs(scene, exist_ok=True)
                    np.save(os.path.join(scene, "pc1.npy"), batch["pc1"][row])
                    np.save(os.path.join(scene, "pc2.npy"), batch["pc2"][row])
                    np.save(os.path.join(scene, "flow.npy"), flow[row])
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.sum()
            seen = count + batch["pc1"].shape[0]
            if log_every and count // log_every != seen // log_every:
                self.log.info(f"[{seen}/{n_scenes}] " + " ".join(
                    f"{k}={float(v) / seen:.4f}"
                    for k, v in sorted(sums.items())))
            count = seen
        sums, count = combine_sums(sums, count, self.mesh, self.shard[1])
        means = {k: float(v) / max(1, count) for k, v in sums.items()}
        self.log.info(f"{self.cfg.data.dataset} ({count} scenes): " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(means.items())))
        # A standalone evaluation has no epoch: -1.
        self.telemetry.emit_eval(self.cfg.data.dataset, epoch=-1,
                                 scenes=count, metrics=means)
        return means

    def close(self) -> None:
        """Close the telemetry sink (the event stream, the TensorBoard
        writer, the log file). Idempotent."""
        self.telemetry.close()
