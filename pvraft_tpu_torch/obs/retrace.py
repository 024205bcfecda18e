"""The retrace guard of the port's captured steps (port of
``pvraft_tpu/obs/retrace.py``'s strict mode).

A ``jax.jit`` step compiles again when it meets a new input shape or
dtype: a retrace, which the JAX watchdog records and, under
``TrainConfig.strict_retrace``, turns into :class:`RetraceError`. The
port's counterpart: a graphed step keeps one captured program per input
signature (:class:`GraphCache`), and a signature it has not seen
captures a new graph. Every capture after the first is recorded in
``GraphCache.retraces``; under ``strict`` it raises instead.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch


class RetraceError(RuntimeError):
    """A graphed step met an input signature it had not captured, under
    strict mode."""


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
