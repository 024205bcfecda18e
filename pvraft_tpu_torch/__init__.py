"""PyTorch/CUDA port of pvraft_tpu for NVIDIA Hopper (H100).

The JAX package ``pvraft_tpu`` stays the reference; this package mirrors
its layout module for module. It imports ``torch`` and numpy only: never
JAX, flax, optax or anything of ``pvraft_tpu``.

It covers both stages of the model (stage 1, ``models.raft.PVRaft``, and
the stage-2 refine model, ``models.raft.PVRaftRefine``) on the serving
path (``serve.engine.InferenceEngine``),
training path (``engine.trainer.Trainer``, ``python -m
pvraft_tpu_torch.train``, with the JAX package's checkpoints and resume)
and standalone evaluation (``engine.evaluator.Evaluator``, ``python -m
pvraft_tpu_torch.test``) on synthetic scenes and on preprocessed
FlyingThings3D and KITTI trees (``data/``: readers, the serial, threaded
and native loaders, the offline preprocessors), with hand-written CUDA
kernels (``csrc/``) for
the fused correlation lookup, the fused MotionEncoder+ConvGRU update and
the voxel means, each behind an autograd Function (``ops/cuda/``): a
tuned kernel at the flagship's shapes and a general one for every other
shape.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

``ModelConfig`` is imported on first use, so that a tool that needs no
torch (the threadcheck CLI) does not import it.
"""

__all__ = ["ModelConfig"]


def __getattr__(name):
    if name == "ModelConfig":
        from pvraft_tpu_torch.config import ModelConfig

        return ModelConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
