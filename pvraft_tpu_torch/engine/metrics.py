"""Scene-flow metrics (port of ``pvraft_tpu/engine/metrics.py``).

  EPE3D    = mean ||pred - gt||
  Acc3DS   = mean[ ||err|| < 0.05  or  rel < 0.05 ]
  Acc3DR   = mean[ ||err|| < 0.1   or  rel < 0.1  ]
  Outliers = mean[ ||err|| > 0.3   or  rel > 0.1  ]
  rel      = ||err|| / (||gt|| + 1e-4)

All are masked means over the valid points, computed on the device.
"""

from __future__ import annotations

from typing import Dict

import torch

from pvraft_tpu_torch.engine.loss import point_mask


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def epe_train(est_flow: torch.Tensor, mask: torch.Tensor,
              gt_flow: torch.Tensor) -> torch.Tensor:
    """Masked mean end-point error."""
    m = point_mask(mask, est_flow)
    err = est_flow - gt_flow
    return _masked_mean(torch.sqrt(torch.sum(err * err, dim=-1)), m)


def flow_metrics(est_flow: torch.Tensor, mask: torch.Tensor,
                 gt_flow: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The full eval metric set."""
    m = point_mask(mask, est_flow)
    err = est_flow - gt_flow
    l2 = torch.sqrt(torch.sum(err * err, dim=-1))
    gt_norm = torch.sqrt(torch.sum(gt_flow * gt_flow, dim=-1))
    rel = l2 / (gt_norm + 1e-4)
    dt = est_flow.dtype
    return {
        "epe3d": _masked_mean(l2, m),
        "acc3d_strict": _masked_mean(((l2 < 0.05) | (rel < 0.05)).to(dt), m),
        "acc3d_relax": _masked_mean(((l2 < 0.1) | (rel < 0.1)).to(dt), m),
        "outlier": _masked_mean(((l2 > 0.3) | (rel > 0.1)).to(dt), m),
    }
