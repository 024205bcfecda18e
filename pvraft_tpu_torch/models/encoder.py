"""Point-cloud feature encoder (port of ``pvraft_tpu/models/encoder.py``):
one kNN graph per cloud and three SetConvs widening 3 -> w -> 2w -> 4w,
their products at ``compute_dtype``, their outputs float32. With a
``seq_group`` the cloud is this rank's rows of it, and the kNN graph comes
from the sequence-parallel ring (``parallel/ring.py::
seq_sharded_graph``) instead of the dense (N, N) distances."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from pvraft_tpu_torch.models.layers import SetConv
from pvraft_tpu_torch.ops.geometry import Graph, build_graph
from pvraft_tpu_torch.parallel.ring import seq_sharded_graph


class PointEncoder(nn.Module):
    """``graph_chunk`` and ``graph_approx`` are the kNN build's ``chunk``
    and ``approx`` (``ops/geometry.py::knn_indices``); ``seq_group`` the
    ranks a cloud's points are sharded over (the ring graph, and the
    SetConvs' group-wide GroupNorms and gathers)."""

    def __init__(self, width: int = 32, graph_k: int = 32,
                 compute_dtype: torch.dtype = torch.float32,
                 graph_chunk: Optional[int] = None,
                 graph_approx: bool = False, seq_group: Any = None):
        super().__init__()
        self.graph_k = graph_k
        self.graph_chunk = graph_chunk
        self.graph_approx = graph_approx
        self.seq_group = seq_group
        self.conv1 = SetConv(3, width, compute_dtype, seq_group)
        self.conv2 = SetConv(width, 2 * width, compute_dtype, seq_group)
        self.conv3 = SetConv(2 * width, 4 * width, compute_dtype, seq_group)

    def forward(self, pc: torch.Tensor, graph: Optional[Graph] = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Graph]:
        """``graph`` skips the kNN build (the context encoder reuses pc1's
        graph); ``mask`` (B, N) excludes padding rows from the GroupNorm
        statistics. The kNN build itself is unmasked: the serve engine
        places padding geometrically far."""
        if graph is None and self.seq_group is not None:
            graph = seq_sharded_graph(pc, self.graph_k, self.seq_group)
        elif graph is None:
            graph = build_graph(pc, self.graph_k, self.graph_chunk,
                                self.graph_approx)
        x = self.conv1(pc, graph, mask)
        x = self.conv2(x, graph, mask)
        x = self.conv3(x, graph, mask)
        return x, graph
