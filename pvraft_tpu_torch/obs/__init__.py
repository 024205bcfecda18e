"""Observability of the port: the retrace guards (``retrace.py``), the
``pvraft_events/v1`` stream (``events.py``), request tracing
(``trace.py``) and device-memory sampling (``device_memory.py``)."""

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
