"""Observability of the port: the retrace guard of its captured steps."""

from pvraft_tpu_torch.obs.retrace import GraphCache, RetraceError, signature

__all__ = ["GraphCache", "RetraceError", "signature"]
