"""The program registry of the port (its counterpart of
``pvraft_tpu/programs/spec.py``): every program the port runs, declared
once.

A :class:`ProgramSpec` is a name, a thunk, tags, the precision intent,
its determinism stance, a description and its declaration site. The
thunk builds the program on a given device at a given size:
``thunk(device, size) -> (fn, example_inputs)``, where ``fn(*example_inputs)`` runs it once and
``size`` is "flagship" (the shapes the port serves and trains) or "tiny"
(the same code at a few points, for tests on the CPU). ``fn`` may carry
``fn.state``, the tensors it reads besides its inputs (parameters, Adam's
state), which count among its arguments, and ``fn.module``, the model it
runs. ``kernels`` names the
``csrc/*.cu`` sources the program launches on the card and ``geometry``
the shapes it gives them (``tests/test_torch_launch_geometry.py`` checks
every launch plan over the catalog by it). ``determinism`` is the
detcheck GD003 stance: a short declared position on the program's
accumulation order (float-atomic scatter-adds, collective reductions),
required of any spec whose import closure reaches such an op.

The registry is what ``python -m pvraft_tpu_torch.programs`` lists and
counts (``programs/costs.py``: the ``pvraft_costs/v1`` inventory) and
what the bitwise replay harness rebuilds
(``analysis/determinism/replay.py``).

Import-light on purpose: no torch here; thunks import torch and the model
when they are built.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Tuple

SIZES = ("flagship", "tiny")


class DuplicateProgramError(ValueError):
    """Two ProgramSpecs claimed the same name: a program is declared
    exactly once."""


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One declared program: how to build it, and what it is."""

    name: str
    thunk: Callable
    tags: Tuple[str, ...] = ()
    precision: str = "f32"
    description: str = ""
    kernels: Tuple[str, ...] = ()
    geometry: Dict[str, Any] = dataclasses.field(default_factory=dict,
                                                 hash=False, compare=False)
    determinism: str = ""
    path: str = ""
    line: int = 0

    def build(self, device=None, size: str = "flagship"):
        """``(fn, example_inputs)`` on ``device`` (the card unless another
        device is named: ``device.resolve_device``) at ``size``."""
        from pvraft_tpu_torch.device import resolve_device

        if size not in SIZES:
            raise ValueError(f"size {size!r} is not one of {SIZES}")
        return self.thunk(resolve_device(device), size)


_REGISTRY: Dict[str, ProgramSpec] = {}


def register_spec(spec: ProgramSpec) -> ProgramSpec:
    """Add one spec; a duplicate name raises."""
    if spec.name in _REGISTRY:
        prev = _REGISTRY[spec.name]
        raise DuplicateProgramError(
            f"duplicate program spec {spec.name!r} "
            f"(already declared at {prev.path}:{prev.line})")
    _REGISTRY[spec.name] = spec
    return spec


def register(name: str, *, tags: Tuple[str, ...] = (),
             precision: str = "f32", description: str = "",
             kernels: Tuple[str, ...] = (),
             geometry: Dict[str, Any] = None, determinism: str = ""):
    """Decorator form: anchors path and line at the ``register(...)``
    call, so that loop-registered thunks each name their own loop call.
    The description defaults to the thunk's first docstring line."""
    caller = inspect.currentframe().f_back
    anchor_path = caller.f_code.co_filename if caller else ""
    anchor_line = caller.f_lineno if caller else 0

    def deco(thunk):
        doc = (thunk.__doc__ or "").strip()
        register_spec(ProgramSpec(
            name=name, thunk=thunk, tags=tuple(tags), precision=precision,
            description=description or (doc.splitlines()[0] if doc else ""),
            kernels=tuple(kernels), geometry=dict(geometry or {}),
            determinism=determinism, path=anchor_path, line=anchor_line))
        return thunk

    return deco


def specs() -> Dict[str, ProgramSpec]:
    """The registry in declaration order (a copy)."""
    return dict(_REGISTRY)


def get(name: str) -> ProgramSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no program spec named {name!r}; see "
            f"`python -m pvraft_tpu_torch.programs list`") from None


def by_tag(*tags: str) -> List[ProgramSpec]:
    """Specs carrying all the given tags, in declaration order."""
    want = set(tags)
    return [s for s in _REGISTRY.values() if want.issubset(s.tags)]
