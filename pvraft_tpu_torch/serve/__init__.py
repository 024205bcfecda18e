"""The port's scene-flow service (port of ``pvraft_tpu/serve``).

  * :mod:`~pvraft_tpu_torch.serve.engine`: :class:`InferenceEngine`, a
    pool of replicas that each capture the (bucket, batch size) table,
    with weight hot-swap without recapture;
  * :mod:`~pvraft_tpu_torch.serve.batcher`: :class:`MicroBatcher`,
    bounded per-bucket queues, grouping, backpressure, drain;
  * :mod:`~pvraft_tpu_torch.serve.supervisor`:
    :class:`ReplicaSupervisor`, per-replica health, probe revival,
    retry once, degraded admission;
  * :mod:`~pvraft_tpu_torch.serve.faults`: deterministic fault plans;
  * :mod:`~pvraft_tpu_torch.serve.metrics`: :class:`ServeMetrics`, JSON
    and Prometheus;
  * :mod:`~pvraft_tpu_torch.serve.events`: :class:`ServeTelemetry`, the
    ``pvraft_events/v1`` stream of the service;
  * :mod:`~pvraft_tpu_torch.serve.server`: :class:`ServeHTTPServer` and
    :func:`build_service`.

CLI: ``python -m pvraft_tpu_torch.serve serve --ckpt ...``.
"""

from pvraft_tpu_torch.serve.batcher import (
    BatcherConfig,
    MicroBatcher,
    PoolUnavailableError,
    QueueFullError,
    ShutdownError,
)
from pvraft_tpu_torch.serve.engine import (
    InferenceEngine,
    RequestError,
    ServeConfig,
    pad_points,
    params_digest,
)
from pvraft_tpu_torch.serve.events import ServeTelemetry
from pvraft_tpu_torch.serve.faults import (
    FaultPlan,
    FaultRule,
    InjectedFaultError,
)
from pvraft_tpu_torch.serve.metrics import ServeMetrics
from pvraft_tpu_torch.serve.server import ServeHTTPServer, build_service
from pvraft_tpu_torch.serve.supervisor import (
    ReplicaSupervisor,
    SupervisorConfig,
)

__all__ = ["BatcherConfig", "FaultPlan", "FaultRule", "InferenceEngine",
           "InjectedFaultError", "MicroBatcher", "PoolUnavailableError",
           "QueueFullError", "ReplicaSupervisor", "RequestError",
           "ServeConfig", "ServeHTTPServer", "ServeMetrics",
           "ServeTelemetry", "ShutdownError", "SupervisorConfig", "build_service",
           "pad_points", "params_digest"]
