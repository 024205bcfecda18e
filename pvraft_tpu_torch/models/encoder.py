"""Point-cloud feature encoder (port of ``pvraft_tpu/models/encoder.py``):
one kNN graph per cloud and three SetConvs widening 3 -> w -> 2w -> 4w."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from pvraft_tpu_torch.models.layers import SetConv
from pvraft_tpu_torch.ops.geometry import Graph, build_graph


class PointEncoder(nn.Module):
    def __init__(self, width: int = 32, graph_k: int = 32):
        super().__init__()
        self.graph_k = graph_k
        self.conv1 = SetConv(3, width)
        self.conv2 = SetConv(width, 2 * width)
        self.conv3 = SetConv(2 * width, 4 * width)

    def forward(self, pc: torch.Tensor, graph: Optional[Graph] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Graph]:
        """``graph`` skips the kNN build (the context encoder reuses pc1's
        graph); ``mask`` (B, N) excludes padding rows from the GroupNorm
        statistics. The kNN build itself is unmasked: the serve engine
        places padding geometrically far."""
        if graph is None:
            graph = build_graph(pc, self.graph_k)
        x = self.conv1(pc, graph, mask)
        x = self.conv2(x, graph, mask)
        x = self.conv3(x, graph, mask)
        return x, graph
