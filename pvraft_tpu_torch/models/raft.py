"""PV-RAFT, stage 1 and stage 2 (port of ``pvraft_tpu/models/raft.py``:
``PVRaft`` and ``PVRaftRefine``).

The JAX ``nn.scan`` over a shared-parameter step becomes a Python loop
over one :class:`UpdateIter` module. Submodule names follow the flax
param paths (``feature_extractor.conv1.fc1``,
``update_iter.corr_lookup.out_conv1``, ...) so that ``weights.py`` maps a
flax tree onto the state_dict by name.

``remat``/``remat_policy`` (the JAX ``nn.remat`` of the scanned step):
with autograd on, each iteration runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` and is
recomputed in the backward (:func:`remat_iteration`); under ``no_grad``
(serving, evaluation, the stage-2 backbone) nothing changes.

Sequence parallelism (the JAX ``PVRaft(cfg, mesh)`` with ``seq_shard``):
``PVRaft(cfg, mesh=...)`` with ``cfg.seq_shard`` and a mesh whose seq
axis holds more than one rank runs on this rank's contiguous rows of both
clouds (``parallel/mesh.py::seq_rows``) through the whole forward and
backward: the kNN graphs and the correlation cache come from the rings
of ``parallel/ring.py``, every GroupNorm takes the seq group's
statistics, every SetConv gathers its neighbours from its input joined
over the group, and the flows are this rank's rows. ``PVRaftRefine(cfg,
mesh=...)`` runs that backbone and its head on the same rows: the head's
SetConvs gather over the group and take its GroupNorm statistics.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from pvraft_tpu_torch.config import (
    ModelConfig,
    compute_dtype,
    resolve_remat_policy,
)
from pvraft_tpu_torch.models.corr_block import CorrLookup
from pvraft_tpu_torch.models.encoder import PointEncoder
from pvraft_tpu_torch.models.layers import Dense, SetConv
from pvraft_tpu_torch.models.update import UpdateBlock
from pvraft_tpu_torch.ops.corr import CorrState, corr_init
from pvraft_tpu_torch.ops.geometry import Graph
from pvraft_tpu_torch.parallel.ring import ring_corr_init


# The aten products whose outputs the "dots" policies keep (the JAX
# checkpoint_dots and dots_with_no_batch_dims_saveable). The CUDA kernels
# are ctypes calls that fill tensors made by torch.empty, which a
# dispatch-mode policy cannot tell from any other empty tensor: the
# policies name products only, and the kernels run again in the backward.
SAVED_PRODUCTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default),
    "dots_no_batch": (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default),
}


def _save_products(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_iteration(policy: str, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` for ``policy``:
    "full" keeps nothing and recomputes ``fn`` in the backward; "dots" and
    "dots_no_batch" keep the outputs of :data:`SAVED_PRODUCTS` (selective
    checkpointing) and recompute the rest. ("save_corr" is built by
    structure in :class:`UpdateIter`.) ``preserve_rng_state=False``: the
    model draws no random numbers, and reading the CUDA generator's state
    fails while a graph is being captured."""
    kw = {}
    if policy in SAVED_PRODUCTS:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_save_products, SAVED_PRODUCTS[policy]))
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


class UpdateIter(nn.Module):
    """One GRU refinement step. With a remat policy in force and autograd
    on, the step runs under :func:`remat_iteration`; "save_corr" runs the
    lookup outside the checkpoint, so its output is kept and the lookup
    does not run again in the backward, and checkpoints the update
    block. ``seq_group``: the ranks the points are sharded over."""

    def __init__(self, cfg: ModelConfig, seq_group: Any = None):
        super().__init__()
        self.corr_lookup = CorrLookup(cfg, seq_group)
        self.update_block = UpdateBlock(cfg, seq_group)
        self.remat = resolve_remat_policy(cfg)

    def forward(self, net, coords2, coords1, state: CorrState, inp,
                graph: Graph, mask: Optional[torch.Tensor] = None):
        coords2 = coords2.detach()
        policy = self.remat if torch.is_grad_enabled() else None
        if policy == "save_corr":
            corr = self.corr_lookup(state, coords2, mask)
            return remat_iteration("full", self._update, net, coords2,
                                   coords1, corr, inp, graph, mask)
        if policy is not None:
            return remat_iteration(policy, self._step, net, coords2, coords1,
                                   state, inp, graph, mask)
        return self._step(net, coords2, coords1, state, inp, graph, mask)

    def _step(self, net, coords2, coords1, state, inp, graph, mask):
        corr = self.corr_lookup(state, coords2, mask)
        return self._update(net, coords2, coords1, corr, inp, graph, mask)

    def _update(self, net, coords2, coords1, corr, inp, graph, mask):
        flow = coords2 - coords1
        net, delta = self.update_block(net, inp, corr, flow, graph, mask)
        return net, coords2 + delta


class PVRaft(nn.Module):
    """``forward(xyz1, xyz2, num_iters, valid1, valid2)`` returns
    ``(flows, graph1)``: flows (num_iters, B, N, 3) and pc1's feature
    graph. ``valid1``/``valid2`` (B, N)/(B, M) bool, True = real point,
    exclude padding from every GroupNorm statistic and from the
    correlation truncation (the serve path's padded buckets).

    ``cfg.compute_dtype`` sets the dtype of every Dense product and of the
    fused GRU update; the encoders' outputs, the correlation cache, the
    GRU carry and the flows stay float32, as in the JAX model.

    ``mesh`` (``parallel/mesh.py::Mesh``): with ``cfg.seq_shard`` and a
    seq axis of more than one rank, the model is sequence-parallel over
    ``mesh.seq_group`` (``seq_group``; None otherwise): ``xyz1``/``xyz2``
    are this rank's rows of each cloud, and so are the flows; pc1's graph
    holds global indices."""

    def __init__(self, cfg: ModelConfig, mesh: Any = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        sharded = cfg.seq_shard and mesh is not None and mesh.n_seq > 1
        if sharded and mesh.seq_group is None:
            raise ValueError(
                f"seq_shard over a seq axis of {mesh.n_seq} needs the mesh "
                f"of a process group (make_mesh), not a layout without "
                f"groups")
        self.seq_group = seq = mesh.seq_group if sharded else None
        d = compute_dtype(cfg)
        graph = (cfg.graph_chunk, cfg.approx_knn)
        self.feature_extractor = PointEncoder(cfg.encoder_width, cfg.graph_k,
                                              d, *graph, seq_group=seq)
        self.context_extractor = PointEncoder(cfg.encoder_width, cfg.graph_k,
                                              d, *graph, seq_group=seq)
        self.update_iter = UpdateIter(cfg, seq)

    def _corr_init(self, fmap1, fmap2, xyz2, valid2=None) -> CorrState:
        """The correlation cache: the ring over the seq group where the
        model is sequence-parallel (``valid2`` refused there, as in JAX),
        else ``ops/corr.py::corr_init``."""
        cfg = self.cfg
        if self.seq_group is None:
            return corr_init(fmap1, fmap2, xyz2, cfg.truncate_k,
                             cfg.corr_chunk, cfg.approx_topk, valid2)
        if valid2 is not None:
            raise ValueError(
                "valid2 masking is not supported with seq_shard: the ring "
                "correlation assembles exact top-k across shards without a "
                "padding mask; serve on the unsharded correlation path")
        return ring_corr_init(fmap1, fmap2, xyz2, cfg.truncate_k,
                              self.seq_group)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                num_iters: int = 8, valid1: Optional[torch.Tensor] = None,
                valid2: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Graph]:
        cfg = self.cfg
        # The pvraft.* ranges name the stages in a torch.profiler trace
        # (profile_serve.py); they change no result.
        with record_function("pvraft.encoder"):
            fmap1, graph1 = self.feature_extractor(xyz1, mask=valid1)
            fmap2, _ = self.feature_extractor(xyz2, mask=valid2)
        with record_function("pvraft.corr_init"):
            state = self._corr_init(fmap1, fmap2, xyz2, valid2)
        with record_function("pvraft.context"):
            fct, _ = self.context_extractor(xyz1, graph=graph1, mask=valid1)
            net, inp = torch.split(fct, [cfg.hidden_dim, cfg.context_dim],
                                   dim=-1)
            net = torch.tanh(net)
            inp = torch.relu(inp)
        coords1 = coords2 = xyz1
        flows = []
        for _ in range(num_iters):
            with record_function("pvraft.update_iter"):
                net, coords2 = self.update_iter(net, coords2, coords1, state,
                                                inp, graph1, valid1)
            flows.append(coords2 - coords1)
        return torch.stack(flows), graph1


class PVRaftRefine(nn.Module):
    """Stage 2 (the reference's ``RAFTSceneFlowRefine``): the stage-1
    ``backbone`` under ``torch.no_grad()`` (JAX: ``stop_gradient`` on its
    last flow and on pc1's graph), then a residual head on that flow over
    pc1's feature graph: SetConvs 3 -> w -> 2w -> 4w (w =
    ``encoder_width``, at the compute dtype) and a float32 Dense to 3.
    ``forward(xyz1, xyz2, num_iters, valid1, valid2)`` returns the
    refined flow (B, N, 3); ``valid1`` masks the head's GroupNorms as the
    backbone's.

    ``mesh``: as :class:`PVRaft`'s. Where the backbone is
    sequence-parallel, ``xyz1``/``xyz2`` and the refined flow are this
    rank's rows, pc1's graph holds global indices, and the head's
    SetConvs take the backbone's ``seq_group`` (the JAX head gets no
    mesh: GSPMD shards it)."""

    def __init__(self, cfg: ModelConfig, mesh: Any = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.backbone = PVRaft(cfg, mesh)
        self.seq_group = seq = self.backbone.seq_group
        n = cfg.encoder_width
        d = compute_dtype(cfg)
        self.ref_conv1 = SetConv(3, n, d, seq)
        self.ref_conv2 = SetConv(n, 2 * n, d, seq)
        self.ref_conv3 = SetConv(2 * n, 4 * n, d, seq)
        self.fc = Dense(4 * n, 3)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                num_iters: int = 32, valid1: Optional[torch.Tensor] = None,
                valid2: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.no_grad():
            flows, graph1 = self.backbone(xyz1, xyz2, num_iters, valid1,
                                          valid2)
        flow = flows[-1]
        with record_function("pvraft.refine"):
            x = self.ref_conv1(flow, graph1, valid1)
            x = self.ref_conv2(x, graph1, valid1)
            x = self.ref_conv3(x, graph1, valid1)
            return flow + self.fc(x)
