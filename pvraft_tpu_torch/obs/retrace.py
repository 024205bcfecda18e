"""The retrace guard of the port's captured steps (port of
``pvraft_tpu/obs/retrace.py``'s strict mode).

A ``jax.jit`` step compiles again when it meets a new input shape or
dtype: a retrace, which the JAX watchdog records and, under
``TrainConfig.strict_retrace``, turns into :class:`RetraceError`. The
port's counterpart: a graphed step keeps one captured program per input
signature (:class:`GraphCache`), and a signature it has not seen
captures a new graph. Every capture after the first is recorded in
``GraphCache.retraces``; under ``strict`` it raises instead.

:class:`RetraceWatchdog` is the service's guard (the JAX watchdog's
sealed serve mode). The port's counterpart of a backend compile is any
CUDA-graph capture (``serve/aot.py::capture``, which ``GraphCache``
reaches too) and any build or load of a kernel library
(``ops/cuda::build_all``, ``library``) in the process: each bumps one
process-wide counter (:func:`note_compile`) under a lock, in Python,
with no CUDA callback and no I/O. ``build_service`` seals a watchdog
after the engine has captured its table and loaded every library it
runs; a dispatch reads :meth:`RetraceWatchdog.global_compiles` before it
runs and passes it to :meth:`RetraceWatchdog.check` after, so only a
compile inside that window trips: a ``recompile`` event, the
``pvraft_serve_recompiles_total`` counter, and under ``strict`` a
:class:`RetraceError` that fails the batch.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock


class RetraceError(RuntimeError):
    """A graphed step met an input signature it had not captured, or a
    sealed service compiled during a dispatch, under strict mode."""


# The process's compile counter. A plain lock: note_compile is called
# from inside captures and library loads, under whatever locks their
# callers hold, and takes nothing else, so it is a leaf of every order.
_COMPILE_LOCK = threading.Lock()
_COMPILES = 0  # guarded-by: _COMPILE_LOCK


def note_compile(n: int = 1) -> None:
    """Count ``n`` compiles (captures, kernel-library builds or loads)."""
    global _COMPILES
    with _COMPILE_LOCK:
        _COMPILES += n


def compile_count() -> int:
    """The compiles this process has made so far."""
    with _COMPILE_LOCK:
        return _COMPILES


def signature(tensors: Sequence[torch.Tensor]) -> str:
    """``dtype[shape]`` of each input, the JAX watchdog's rendering."""
    return ", ".join(f"{str(t.dtype).replace('torch.', '')}"
                     f"[{','.join(map(str, t.shape))}]" for t in tensors)


class GraphCache:
    """Programs of one step, by input signature. ``capture(name, inputs)``
    makes the program of a new signature (``serve/aot.py::capture``)."""

    def __init__(self, name: str,
                 capture: Callable[[str, Sequence[torch.Tensor]], Any],
                 strict: bool = False):
        self.name = name
        self.strict = strict
        self._capture = capture
        self.programs: Dict[str, Any] = {}
        self.retraces: List[str] = []

    def program_for(self, inputs: Sequence[torch.Tensor]):
        """The program for ``inputs``' signature, captured on first sight.
        Raises :class:`RetraceError` under ``strict`` for a signature met
        after the first capture."""
        key = signature(inputs)
        program = self.programs.get(key)
        if program is None:
            if self.programs:
                if self.strict:
                    raise RetraceError(
                        f"{self.name}: input signature ({key}) was not "
                        f"captured; captured: {list(self.programs)} "
                        "(strict_retrace)")
                self.retraces.append(key)
            program = self._capture(f"{self.name}[{key}]", inputs)
            self.programs[key] = program
        return program

    def report(self) -> List[Dict[str, Any]]:
        return [p.report() for p in self.programs.values()]


def _program_count(watched) -> int:
    """Programs a watched object holds (a :class:`GraphCache`'s, or any
    ``programs`` mapping), or -1 when it has none to count."""
    programs = getattr(watched, "programs", None)
    return len(programs) if programs is not None else -1


class RetraceWatchdog:
    """Counts compiles after warm-up; emits ``recompile`` events and,
    when ``strict``, raises :class:`RetraceError` from :meth:`check`.

    ``emit`` is the event sink (``ServeTelemetry.emit_recompile``) or
    None. Watched programs (:meth:`watch`) trip when their program count
    grows past the count first seen after warm-up; a sealed watchdog
    (:meth:`seal`) trips on any compile in the process (:func:`
    note_compile`). Thread-safe: the executors check it concurrently."""

    def __init__(self, emit: Optional[Callable[..., Any]] = None,
                 strict: bool = False, context: str = "train"):
        self.emit = emit
        self.strict = strict
        self.context = context
        self._lock = ordered_lock("RetraceWatchdog._lock")
        self.trips = 0  # guarded-by: _lock
        # name -> [watched, baseline or None (warm-up not seen yet)].
        self._watched: Dict[str, List[Any]] = {}  # guarded-by: _lock
        self._sealed = False  # guarded-by: _lock
        self._injected = 0  # guarded-by: _lock
        self._global_baseline = 0  # guarded-by: _lock

    def watch(self, name: str, programs) -> None:
        """Track the program count of ``programs`` (a :class:`GraphCache`)
        by name; an object with nothing to count is skipped."""
        if _program_count(programs) < 0:
            return
        with self._lock:
            self._watched[name] = [programs, None]

    def _compiles(self) -> int:
        # The caller holds _lock.
        return compile_count() + self._injected

    def seal(self) -> bool:
        """Close the program set: from here any compile in the process is
        a trip. Always armed (the counter needs no runtime hook)."""
        with self._lock:
            self._sealed = True
            self._global_baseline = self._compiles()
        return True

    def close(self) -> None:
        """Stop watching the process's compiles."""
        with self._lock:
            self._sealed = False

    def inject_compile(self) -> None:
        """The ``compile_trip`` fault point's effect: one compile counted
        as a real one would be, so the trip runs the real path (window
        check, ``recompile`` event, strict failure)."""
        with self._lock:
            self._injected += 1

    def global_compiles(self) -> int:
        """The compile count a dispatch reads before it runs and passes
        to :meth:`check` as ``window_start``: a compile outside the
        window (another engine capturing its table between dispatches)
        does not trip this one."""
        with self._lock:
            return self._compiles()

    def check(self, signature: Any = None, program: Optional[str] = None,
              window_start: Optional[int] = None) -> List[Dict[str, Any]]:
        """One pass: every watched program's count against its baseline
        (learnt at first sight), and when sealed the process's compiles
        against ``window_start`` (else the previous check). Returns the
        trips after emitting them; raises :class:`RetraceError` under
        ``strict`` when any. ``signature`` is a string or a zero-argument
        callable, called only on a trip."""
        trips: List[Dict[str, Any]] = []
        with self._lock:
            for name, slot in self._watched.items():
                size = _program_count(slot[0])
                if slot[1] is None:
                    if size > 0:
                        slot[1] = size  # warm-up: the first program
                    continue
                if size > slot[1]:
                    trips.append({"program": name, "count": size,
                                  "baseline": slot[1]})
                    slot[1] = size  # one growth, one event
            if self._sealed:
                compiles = self._compiles()
                # The ratchet: two dispatches whose windows both opened
                # before one compile report it once.
                start = (max(window_start, self._global_baseline)
                         if window_start is not None
                         else self._global_baseline)
                if compiles > start:
                    trips.append({"program": program or "<sealed>",
                                  "count": compiles, "baseline": start})
                self._global_baseline = compiles
            self.trips += len(trips)
        if trips and callable(signature):
            signature = signature()
        for trip in trips:
            if self.emit is not None:
                self.emit(program=trip["program"], count=trip["count"],
                          baseline=trip["baseline"], signature=signature,
                          context=self.context)
        if trips and self.strict:
            worst = trips[0]
            raise RetraceError(
                f"program {worst['program']!r} recompiled after warmup "
                f"(compiles {worst['baseline']} -> {worst['count']}"
                + (f", args {signature}" if signature else "")
                + "): a capture or kernel build on the serving path "
                "stalls every request behind it; find what changed "
                "shape or drop --strict_retrace to observe only")
        return trips
