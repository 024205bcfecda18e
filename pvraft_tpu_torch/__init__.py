"""PyTorch/CUDA port of pvraft_tpu for NVIDIA Hopper (H100).

The JAX package ``pvraft_tpu`` stays the reference; this package mirrors
its layout module for module. It imports ``torch`` and numpy only: never
JAX, flax, optax or anything of ``pvraft_tpu``.

Slice 1 covers the stage-1 serving path: ``serve.engine.InferenceEngine``
over the stage-1 ``models.raft.PVRaft`` forward, with hand-written CUDA
kernels (``csrc/``) for the fused correlation lookup and the fused
MotionEncoder+ConvGRU update. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from pvraft_tpu_torch.config import ModelConfig

__all__ = ["ModelConfig"]
