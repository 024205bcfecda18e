"""Profiling of the port (port of ``pvraft_tpu/profiling``): the step
timer and the ``torch.profiler`` window (``timers.py``) and the
per-stage train-step profiler (``step_profiler.py``, ``python -m
pvraft_tpu_torch.profiling``)."""

from pvraft_tpu_torch.profiling.step_profiler import (  # noqa: F401
    BREAKDOWN_STAGES,
    MEASUREMENTS,
    SCHEMA_VERSION,
    derive_breakdown,
    ladder_programs,
    profile_step,
    validate_step_profile,
)
from pvraft_tpu_torch.profiling.timers import (  # noqa: F401
    StepTimer,
    start_profiler,
    trace_context,
)
