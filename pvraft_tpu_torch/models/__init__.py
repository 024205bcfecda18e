"""Stage-1 PV-RAFT modules of the port."""

from pvraft_tpu_torch.models.raft import PVRaft

__all__ = ["PVRaft"]
