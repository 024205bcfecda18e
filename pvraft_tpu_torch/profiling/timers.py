"""Step timing and profiler windows (port of
``pvraft_tpu/profiling/timers.py``, ``torch.profiler`` in place of
``jax.profiler``).

:func:`start_profiler` is the one way the port opens a profiler window
(the Trainer's ``profile_dir`` and the service's ``/debug/trace``): CPU
and, with a card, CUDA activity, the ranges of every thread, and a
refusal while another session runs, since two at once can take the
process down.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch

TRACE_FILE = "trace.json"
# Now and then the profiler drops the first device records of a window,
# as if it dated them before the window opened (on an H100, ``python -m
# pvraft_tpu_torch.profiling.windows``: the head of the window's activity
# sequence, in about 2% of windows). A window with CUDA activity therefore
# waits this long after it opens before the work it is to see.
PROFILER_LEAD_S = 0.05


def start_profiler():
    """A started ``torch.profiler.profile`` over CPU and (with a card)
    CUDA activity, after :data:`PROFILER_LEAD_S`, that records every
    thread's ranges. Raises
    RuntimeError while another profiler session runs in the process."""
    from torch.profiler import ProfilerActivity, profile

    if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        raise RuntimeError("another torch.profiler session is running in "
                           "this process; one profiler at a time")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))
    prof.start()
    if torch.cuda.is_available():
        time.sleep(PROFILER_LEAD_S)
    return prof


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[Optional[object]]:
    """A profiler window (:func:`start_profiler`) written to
    ``<log_dir>/trace.json`` as a Chrome trace when ``log_dir`` is given
    (yields the session); nothing otherwise (yields None)."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    prof = start_profiler()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StepTimer:
    """Wall-clock step times, each synchronised with the device of the
    tensors ``stop`` is given."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *sync_on: torch.Tensor) -> float:
        for device in {t.device for t in sync_on if t.is_cuda}:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))
