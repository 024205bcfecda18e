"""PyTorch/CUDA port of pvraft_tpu for NVIDIA Hopper (H100).

The JAX package ``pvraft_tpu`` stays the reference; this package mirrors
its layout module for module. It imports ``torch`` and numpy only: never
JAX, flax, optax or anything of ``pvraft_tpu``.

It covers the stage-1 model's serving path (``serve.engine.InferenceEngine``)
and training path (``engine.trainer.Trainer``, ``python -m
pvraft_tpu_torch.train``), with hand-written CUDA kernels (``csrc/``) for
the fused correlation lookup, the fused MotionEncoder+ConvGRU update and
the voxel means, each behind an autograd Function (``ops/cuda/``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from pvraft_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig"]
