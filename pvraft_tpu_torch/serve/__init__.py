"""The port's serving engine."""

from pvraft_tpu_torch.serve.engine import (
    InferenceEngine,
    RequestError,
    ServeConfig,
    pad_points,
)

__all__ = ["InferenceEngine", "RequestError", "ServeConfig", "pad_points"]
