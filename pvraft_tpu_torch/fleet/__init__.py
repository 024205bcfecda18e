"""The fleet tier of the port (port of ``pvraft_tpu/fleet``): a router
over N serve hosts, each a whole ``serve.build_service`` pool, with

- least-predicted-load routing per bucket (the polled backend queue
  plus the cost surface's predicted device-seconds), spillover on shed
  or unreachable backends, and the replica supervisor's health states
  one tier up, from polled ``/healthz`` (``router.py``, ``backend.py``);
- weight hot swaps fanned out one backend at a time with no recapture
  (``POST /admin/reload``);
- a live canary: a deterministic share of the traffic to the backend
  with the new weights, mirrored to the incumbent, promoted or rejected
  on the bf16 serving EPE bounds (``canary.py``);
- its ledger and Prometheus text (``metrics.py``) and the
  ``pvraft_fleet_chaos/v1`` evidence schema (``artifact.py``).

The tier talks HTTP, never tensors. CLI: ``python -m
pvraft_tpu_torch.fleet run|validate``.
"""

from pvraft_tpu_torch.fleet.artifact import (  # noqa: F401
    FLEET_CHAOS_SCHEMA,
    validate_fleet_artifact,
)
from pvraft_tpu_torch.fleet.backend import Backend, BackendClient  # noqa: F401
from pvraft_tpu_torch.fleet.canary import CanaryController, flow_epe  # noqa: F401
from pvraft_tpu_torch.fleet.metrics import FleetMetrics  # noqa: F401
from pvraft_tpu_torch.fleet.router import (  # noqa: F401
    FleetConfig,
    FleetRouter,
    build_fleet,
)

__all__ = ["FLEET_CHAOS_SCHEMA", "Backend", "BackendClient",
           "CanaryController", "FleetConfig", "FleetMetrics", "FleetRouter",
           "build_fleet", "flow_epe", "validate_fleet_artifact"]
