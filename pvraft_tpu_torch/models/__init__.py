"""PV-RAFT modules of the port: stage 1 and the stage-2 refine model."""

from pvraft_tpu_torch.models.raft import PVRaft, PVRaftRefine

__all__ = ["PVRaft", "PVRaftRefine"]
