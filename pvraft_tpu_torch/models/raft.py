"""Stage-1 PV-RAFT (port of ``pvraft_tpu/models/raft.py::PVRaft``).

The JAX ``nn.scan`` over a shared-parameter step becomes a Python loop
over one :class:`UpdateIter` module. Submodule names follow the flax
param paths (``feature_extractor.conv1.fc1``,
``update_iter.corr_lookup.out_conv1``, ...) so that ``weights.py`` maps a
flax tree onto the state_dict by name.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.models.corr_block import CorrLookup
from pvraft_tpu_torch.models.encoder import PointEncoder
from pvraft_tpu_torch.models.update import UpdateBlock
from pvraft_tpu_torch.ops.corr import CorrState, corr_init
from pvraft_tpu_torch.ops.geometry import Graph


class UpdateIter(nn.Module):
    """One GRU refinement step."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.corr_lookup = CorrLookup(cfg)
        self.update_block = UpdateBlock(cfg)

    def forward(self, net, coords2, coords1, state: CorrState, inp,
                graph: Graph, mask: Optional[torch.Tensor] = None):
        coords2 = coords2.detach()
        corr = self.corr_lookup(state, coords2, mask)
        flow = coords2 - coords1
        net, delta = self.update_block(net, inp, corr, flow, graph, mask)
        return net, coords2 + delta


class PVRaft(nn.Module):
    """``forward(xyz1, xyz2, num_iters, valid1, valid2)`` returns
    ``(flows, graph1)``: flows (num_iters, B, N, 3) and pc1's feature
    graph. ``valid1``/``valid2`` (B, N)/(B, M) bool, True = real point,
    exclude padding from every GroupNorm statistic and from the
    correlation truncation (the serve path's padded buckets)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = PointEncoder(cfg.encoder_width, cfg.graph_k)
        self.context_extractor = PointEncoder(cfg.encoder_width, cfg.graph_k)
        self.update_iter = UpdateIter(cfg)

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
            state = corr_init(fmap1, fmap2, xyz2, cfg.truncate_k,
                              valid2=valid2)
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
