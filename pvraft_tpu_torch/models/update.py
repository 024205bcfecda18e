"""GRU update block (port of ``pvraft_tpu/models/update.py``): motion
encoder, 1x1-conv GRU and a flow head whose spatial mixing is a SetConv on
the context graph."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from pvraft_tpu_torch.config import ModelConfig, resolve_use_pallas
from pvraft_tpu_torch.models.layers import SetConv
from pvraft_tpu_torch.ops.cuda.gru_iter import (
    fused_gru_update,
    gru_math,
    pack_gru_weights,
    pad_flow,
)
from pvraft_tpu_torch.ops.geometry import Graph


class MotionEncoder(nn.Module):
    """Mixes correlation features with the current flow: 61 learned
    channels concatenated with the raw flow."""

    def __init__(self, hidden: int = 64, corr_ch: int = 64):
        super().__init__()
        self.conv_corr = nn.Linear(corr_ch, hidden)
        self.conv_flow = nn.Linear(3, hidden)
        self.conv = nn.Linear(2 * hidden, hidden - 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.conv_corr(corr))
        flo = torch.relu(self.conv_flow(flow))
        h = torch.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        return torch.cat([h, flow], dim=-1)


class ConvGRU(nn.Module):
    """z/r/q gates via 1x1 convs over concat(h, x); fp32 carry."""

    def __init__(self, hidden: int = 64, in_ch: int = 128):
        super().__init__()
        self.convz = nn.Linear(hidden + in_ch, hidden)
        self.convr = nn.Linear(hidden + in_ch, hidden)
        self.convq = nn.Linear(hidden + in_ch, hidden)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1)))
        return (1.0 - z) * h + z * q


class FlowHead(nn.Module):
    """Parallel Linear + SetConv over the hidden state, fused to a
    3-channel flow delta."""

    def __init__(self, hidden: int = 64):
        super().__init__()
        self.conv1 = nn.Linear(hidden, 64)
        self.setconv = SetConv(hidden, 64)
        self.out_conv1 = nn.Linear(128, 64)
        self.out_conv2 = nn.Linear(64, 3)

    def forward(self, x: torch.Tensor, graph: Graph,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.conv1(x)
        out_set = self.setconv(x, graph, mask)
        h = torch.relu(self.out_conv1(torch.cat([out_set, out], dim=-1)))
        return self.out_conv2(h)


def _kernel_in(layer: nn.Linear) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Linear's (in, out) kernel and bias, the JAX Dense layout."""
    return layer.weight.t(), layer.bias


class UpdateBlock(nn.Module):
    """MotionEncoder -> ConvGRU -> FlowHead. ``cfg.fused_gru`` runs the
    MotionEncoder + ConvGRU pair as one fused update on the same
    parameters: :func:`fused_gru_update` (the CUDA kernel, with its
    hand-written backward) when ``use_pallas`` resolves True, else its
    plain version :func:`gru_math` under autograd. The FlowHead stays
    unfused either way."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.motion_encoder = MotionEncoder(cfg.hidden_dim)
        self.gru = ConvGRU(cfg.hidden_dim, cfg.context_dim + cfg.hidden_dim)
        self.flow_head = FlowHead(cfg.hidden_dim)

    def packed_weights(self):
        """The fused kernel's operand tuple (:func:`pack_gru_weights`)."""
        me, gru = self.motion_encoder, self.gru
        me_params = (*_kernel_in(me.conv_corr), *_kernel_in(me.conv_flow),
                     *_kernel_in(me.conv))
        gru_params = (*_kernel_in(gru.convz), *_kernel_in(gru.convr),
                      *_kernel_in(gru.convq))
        return pack_gru_weights(me_params, gru_params, self.cfg.hidden_dim,
                                self.cfg.context_dim)

    def forward(self, net, inp, corr, flow, graph: Graph,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.cfg.fused_gru:
            kernel = resolve_use_pallas(self.cfg, net, "gru_iter")
            update = fused_gru_update if kernel else gru_math
            net = update(net, inp, corr, pad_flow(flow), self.packed_weights())
        else:
            motion = self.motion_encoder(flow, corr)
            net = self.gru(net, torch.cat([inp, motion], dim=-1))
        delta = self.flow_head(net, graph, mask)
        return net, delta
