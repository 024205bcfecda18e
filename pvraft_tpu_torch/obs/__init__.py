"""Observability of the port: the retrace guards (``retrace.py``), the
``pvraft_events/v1`` stream and the run sink (``events.py``), request
tracing (``trace.py``), device-memory sampling (``device_memory.py``),
the in-step numerics monitors (``monitors.py``) and divergence
detection with its snapshots (``divergence.py``)."""

from pvraft_tpu_torch.obs.retrace import (
    GraphCache,
    RetraceError,
    RetraceWatchdog,
    compile_count,
    note_compile,
    signature,
)

__all__ = ["GraphCache", "RetraceError", "RetraceWatchdog", "compile_count",
           "note_compile", "signature"]
