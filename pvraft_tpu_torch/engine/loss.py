"""Training losses (port of ``pvraft_tpu/engine/loss.py``).

For a mask m and error e of shape (B, N, 3), the reference's
``mean(|e|[m>0])`` is ``sum(|e| * m) / (3 * sum(m))``, computed with
static shapes.
"""

from __future__ import annotations

import torch


def point_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, N) or (B, N, 1) mask -> (B, N) 0/1 in ``like``'s dtype."""
    if mask.dim() == 3:
        mask = mask[..., 0]
    return (mask > 0).to(like.dtype)


def compute_loss(est_flow: torch.Tensor, mask: torch.Tensor,
                 gt_flow: torch.Tensor) -> torch.Tensor:
    """Masked mean-L1 flow loss. est_flow/gt_flow: (B, N, 3); mask: (B, N)
    or (B, N, 1)."""
    m = point_mask(mask, est_flow)
    err = torch.abs(est_flow - gt_flow) * m[..., None]
    return torch.sum(err) / (3.0 * torch.clamp(torch.sum(m), min=1.0))


def sequence_loss(flows: torch.Tensor, mask: torch.Tensor,
                  gt_flow: torch.Tensor, gamma: float = 0.8) -> torch.Tensor:
    """RAFT exponentially weighted sequence loss. flows: (T, B, N, 3);
    the weight of iteration i is gamma**(T-1-i)."""
    t = flows.shape[0]
    weights = gamma ** torch.arange(t - 1, -1, -1, dtype=flows.dtype,
                                    device=flows.device)
    per_iter = torch.stack([compute_loss(flows[i], mask, gt_flow)
                            for i in range(t)])
    return torch.sum(weights * per_iter)
