"""GRU update block (port of ``pvraft_tpu/models/update.py``): motion
encoder, 1x1-conv GRU and a flow head whose spatial mixing is a SetConv on
the context graph.

At a ``compute_dtype`` below float32 each module casts where its flax
twin does: the Denses compute in it, the GRU's carry and blend stay
float32 (``ConvGRU``), and the flow head's last Dense is float32, so the
flow delta is float32."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from pvraft_tpu_torch.config import (
    ModelConfig,
    compute_dtype,
    resolve_use_pallas,
)
from pvraft_tpu_torch.models.layers import Dense, SetConv
from pvraft_tpu_torch.ops.cuda.gru_iter import (
    fused_gru_update,
    gru_math,
    pack_gru_weights,
    pad_flow,
)
from pvraft_tpu_torch.ops.geometry import Graph


class MotionEncoder(nn.Module):
    """Mixes correlation features with the current flow: 61 learned
    channels concatenated with the raw flow, all at ``compute_dtype``."""

    def __init__(self, hidden: int = 64, corr_ch: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_corr = Dense(corr_ch, hidden, compute_dtype=compute_dtype)
        self.conv_flow = Dense(3, hidden, compute_dtype=compute_dtype)
        self.conv = Dense(2 * hidden, hidden - 3, compute_dtype=compute_dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.conv_corr(corr))
        flo = torch.relu(self.conv_flow(flow))
        h = torch.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        return torch.cat([h, flow.to(h.dtype)], dim=-1)


class ConvGRU(nn.Module):
    """z/r/q gates via 1x1 convs over concat(h, x) at ``compute_dtype``;
    the carry h stays float32: the gates' inputs are concatenated in h's
    dtype, ``r * h`` is taken in the gates' dtype, and the blend
    ``(1 - z) * h + z * q`` promotes to float32 (the JAX ``ConvGRU``)."""

    def __init__(self, hidden: int = 64, in_ch: int = 128,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convz = Dense(hidden + in_ch, hidden, compute_dtype=compute_dtype)
        self.convr = Dense(hidden + in_ch, hidden, compute_dtype=compute_dtype)
        self.convq = Dense(hidden + in_ch, hidden, compute_dtype=compute_dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x = x.to(h.dtype)
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        rh = (r * h.to(r.dtype)).to(h.dtype)
        q = torch.tanh(self.convq(torch.cat([rh, x], dim=-1)))
        return ((1.0 - z) * h.float() + z * q).float()


class FlowHead(nn.Module):
    """Parallel Dense + SetConv over the hidden state, fused to a
    3-channel flow delta; the last Dense is float32 at every compute
    dtype. ``seq_group``: the SetConv's (its gather and GroupNorms)."""

    def __init__(self, hidden: int = 64,
                 compute_dtype: torch.dtype = torch.float32,
                 seq_group: Any = None):
        super().__init__()
        self.conv1 = Dense(hidden, 64, compute_dtype=compute_dtype)
        self.setconv = SetConv(hidden, 64, compute_dtype, seq_group)
        self.out_conv1 = Dense(128, 64, compute_dtype=compute_dtype)
        self.out_conv2 = Dense(64, 3)

    def forward(self, x: torch.Tensor, graph: Graph,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.conv1(x)
        out_set = self.setconv(x, graph, mask).to(out.dtype)
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
    plain version :func:`gru_math` under autograd, both at the compute
    dtype. The FlowHead stays unfused either way. ``seq_group``: the
    FlowHead's (the update itself is per point)."""

    def __init__(self, cfg: ModelConfig, seq_group: Any = None):
        super().__init__()
        self.cfg = cfg
        d = compute_dtype(cfg)
        self.motion_encoder = MotionEncoder(cfg.hidden_dim, compute_dtype=d)
        self.gru = ConvGRU(cfg.hidden_dim, cfg.context_dim + cfg.hidden_dim,
                           d)
        self.flow_head = FlowHead(cfg.hidden_dim, d, seq_group)

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
            net = update(net, inp, corr, pad_flow(flow), self.packed_weights(),
                         compute_dtype(self.cfg))
        else:
            motion = self.motion_encoder(flow, corr)
            net = self.gru(net, torch.cat([inp.to(motion.dtype), motion],
                                          dim=-1))
        delta = self.flow_head(net, graph, mask)
        return net, delta
