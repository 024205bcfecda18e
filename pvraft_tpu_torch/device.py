"""The port's device rule: its entry points run on the card unless the
caller asks for another device."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when no
    CUDA device is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)
