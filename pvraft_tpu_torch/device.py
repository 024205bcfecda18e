"""The port's device rule: its entry points run on the card unless the
caller asks for another device.

This module is also the one owner of the backend switches that change
numerics or kernel choice process-wide (detcheck GD004): TF32
(:func:`set_tf32`), the cuBLAS workspace (:func:`fix_cublas_workspace`)
and deterministic algorithms (:func:`deterministic_algorithms`). Every
entry point sets them through these helpers.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Union

import torch

# cuBLAS is deterministic only with a fixed workspace, set before its
# first call.
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


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


def set_tf32(enabled: bool) -> None:
    """TF32 for cuBLAS matmuls and cuDNN convolutions, both at once."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def fix_cublas_workspace() -> None:
    """Fix cuBLAS's workspace (:data:`CUBLAS_WORKSPACE_CONFIG`) unless the
    environment already names one; call it before cuBLAS's first call."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True) -> Iterator[None]:
    """``torch.use_deterministic_algorithms`` on for the block when ``on``
    (sorted scatter-adds instead of float atomics), the previous setting
    restored after it."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on or was)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
