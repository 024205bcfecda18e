"""Training losses (port of ``pvraft_tpu/engine/loss.py``).

For a mask m and error e of shape (B, N, 3), the reference's
``mean(|e|[m>0])`` is ``sum(|e| * m) / (3 * sum(m))``, computed with
static shapes.

With a ``seq_group`` (sequence parallelism, ``parallel/``) each rank
holds its rows of the points: the numerator is this rank's and the
denominator the mask count summed over the group (:func:`mask_count`),
so the group's losses sum to the one-rank loss and so do their
gradients.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from pvraft_tpu_torch.parallel.collectives import reduce_sum_


def point_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, N) or (B, N, 1) mask -> (B, N) 0/1 in ``like``'s dtype."""
    if mask.dim() == 3:
        mask = mask[..., 0]
    return (mask > 0).to(like.dtype)


def mask_count(m: torch.Tensor, seq_group: Any = None) -> torch.Tensor:
    """The valid points of the 0/1 mask ``m``, at least 1: summed over
    ``seq_group``'s ranks where one is given (no gradient)."""
    n = torch.sum(m)
    if seq_group is not None:
        n = reduce_sum_(n.detach().clone(), seq_group)
    return torch.clamp(n, min=1.0)


def compute_loss(est_flow: torch.Tensor, mask: torch.Tensor,
                 gt_flow: torch.Tensor, seq_group: Any = None,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean-L1 flow loss. est_flow/gt_flow: (B, N, 3); mask: (B, N)
    or (B, N, 1). ``count``: the mask's :func:`mask_count`, where the
    caller has it."""
    m = point_mask(mask, est_flow)
    err = torch.abs(est_flow - gt_flow) * m[..., None]
    if count is None:
        count = mask_count(m, seq_group)
    return torch.sum(err) / (3.0 * count)


def sequence_loss(flows: torch.Tensor, mask: torch.Tensor,
                  gt_flow: torch.Tensor, gamma: float = 0.8,
                  seq_group: Any = None) -> torch.Tensor:
    """RAFT exponentially weighted sequence loss. flows: (T, B, N, 3);
    the weight of iteration i is gamma**(T-1-i)."""
    t = flows.shape[0]
    weights = gamma ** torch.arange(t - 1, -1, -1, dtype=flows.dtype,
                                    device=flows.device)
    count = mask_count(point_mask(mask, flows), seq_group)
    per_iter = torch.stack([compute_loss(flows[i], mask, gt_flow,
                                         count=count)
                            for i in range(t)])
    return torch.sum(weights * per_iter)
