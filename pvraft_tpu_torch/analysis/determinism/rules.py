"""detcheck rules GD001-GD005 of the port: the determinism and RNG
failure classes (the port's own copy of
``pvraft_tpu/analysis/determinism/rules.py``, with torch's shapes).

These rules make the seed-stream contract (:mod:`pvraft_tpu_torch.rng`),
the hazard-op stances (``determinism=`` on ProgramSpecs), the one owner
of backend determinism flags (``pvraft_tpu_torch/device.py``) and the
iteration-order conventions machine-checked. Suppress with
``# graftlint: disable=GDxxx -- reason`` (the shared pragma grammar).

Path scoping: inside the package ``pvraft_tpu_torch/rng.py`` is exempt
from GD002 (it owns the stream contract) and ``pvraft_tpu_torch/
device.py`` from GD004 (it owns the flags); outside the package
(fixtures, inline test sources) every rule applies.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Type

from pvraft_tpu_torch.analysis.engine import Diagnostic, LintContext, Rule
from pvraft_tpu_torch.analysis.determinism.model import (
    ModuleDetModel,
    StreamSite,
    build_module_det_model,
    stream_call,
)

_PKG = "pvraft_tpu_torch/"


@dataclasses.dataclass(frozen=True)
class HazardSpec:
    """One registered ProgramSpec whose static import closure reaches a
    nondeterminism-hazard op: the GD003 input, computed by
    :func:`~pvraft_tpu_torch.analysis.determinism.check.hazard_spec_records`
    (or passed explicitly by tests)."""

    name: str
    determinism: str
    path: str
    line: int
    via: str    # module (path suffix) holding the hazard
    kinds: Tuple[str, ...]


class DetContext(LintContext):
    """LintContext + the det model + the declared context.

    ``declared_streams=None`` means no stream vocabulary could be read
    (rng.py unreadable): GD002 then reports the gap on any file that
    calls a stream function. ``hazard_specs`` carries the registry's
    hazard closure; GD003 reports only the specs declared in this file,
    at their registration line."""

    def __init__(self, path: str, source: str, tree: ast.Module,
                 model: Optional[ModuleDetModel] = None,
                 declared_streams: Optional[Sequence[str]] = None,
                 hazard_specs: Optional[Sequence[HazardSpec]] = None):
        super().__init__(path, source, tree)
        self.model = model if model is not None \
            else build_module_det_model(tree)
        self.declared_streams = (None if declared_streams is None
                                 else tuple(declared_streams))
        self.hazard_specs = tuple(hazard_specs or ())

    def package_suffix(self) -> Optional[str]:
        """'pvraft_tpu_torch/...' relative suffix, or None for sources
        outside the package (those see every rule)."""
        if _PKG in self.norm_path:
            return _PKG + self.norm_path.rsplit("/" + _PKG, 1)[-1]
        return None

    def diag_at(self, line: int, col: int, rule_id: str,
                message: str) -> Diagnostic:
        return Diagnostic(self.path, line, col, rule_id, message)


class DetRule(Rule):
    def check(self, ctx: DetContext) -> Iterable[Diagnostic]:
        raise NotImplementedError


_GD_REGISTRY: List[Type[DetRule]] = []


def gd_register(cls: Type[DetRule]) -> Type[DetRule]:
    if not cls.id or not cls.title:
        raise ValueError(f"rule {cls.__name__} must set id and title")
    if any(r.id == cls.id for r in _GD_REGISTRY):
        raise ValueError(f"duplicate rule id {cls.id}")
    _GD_REGISTRY.append(cls)
    return cls


def all_determinism_rules() -> Tuple[Type[DetRule], ...]:
    return tuple(sorted(_GD_REGISTRY, key=lambda r: r.id))


def _exempt(ctx: DetContext, owner: str) -> bool:
    return ctx.package_suffix() == owner


# --- GD001 ----------------------------------------------------------------

def _own_calls(fn: ast.AST) -> Iterable[ast.AST]:
    """The nodes of ``fn``'s body outside its nested defs and classes
    (each nested def is a function of its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@gd_register
class StreamReuse(DetRule):
    """The same seed stream derived twice in one function.

    ``host_rng(seed, "data.shuffle")`` called twice in one function with
    the same seed and the same literal parts gives two generators that
    draw identical numbers: two "independent" noises that are one, two
    subsamples that agree. The port's form of the JAX package's key
    reuse (its keys are generators here). Fix: give each draw an index
    part, ``host_rng(seed, "data.shuffle", i)``, or draw both from one
    generator.
    """

    id = "GD001"
    title = "stream-reuse"

    def check(self, ctx: DetContext) -> Iterable[Diagnostic]:
        if not ctx.model.stream_calls:
            return
        aliases = ctx.model.aliases
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            sites = sorted(
                (s for s in (stream_call(n, aliases) for n in _own_calls(fn)
                             if isinstance(n, ast.Call)) if s is not None),
                key=lambda s: (s.line, s.col))
            first: Dict[Tuple[object, ...], StreamSite] = {}
            for s in sites:
                if not (s.literal_parts and s.stream_strs and s.seed):
                    continue
                key = (s.func, s.seed, s.parts)
                if key in first:
                    yield ctx.diag_at(
                        s.line, s.col, self.id,
                        f"stream {s.stream_strs[0]!r} derived again with "
                        f"the same seed and parts as at line "
                        f"{first[key].line} in `{fn.name}` — the two "
                        f"generators draw identical numbers; add an index "
                        f"part or draw both from one generator")
                else:
                    first[key] = s


# --- GD002 ----------------------------------------------------------------

@gd_register
class UndeclaredEntropy(DetRule):
    """Entropy minted outside the ``pvraft_tpu_torch.rng`` stream contract.

    Three shapes: (a) a raw RNG constructor or seeding call
    (``np.random.default_rng``/``RandomState``/``SeedSequence`` and the
    legacy globals, stdlib ``random``, ``torch.Generator(...)`` and its
    ``manual_seed``, ``torch.manual_seed``, ``torch.cuda.manual_seed
    [_all]``, ``torch.seed``) anywhere but ``rng.py`` invents a seed the
    config seed does not govern (two warm-up seeds ``bucket * 16 + bs``
    collide with other streams); (b) a time/pid/uuid-derived seed makes
    the run unreplayable by construction; (c) a ``host_rng``/
    ``host_entropy``/``torch_seed`` call whose stream name is missing or
    not declared in :data:`pvraft_tpu_torch.rng.STREAMS`. Fix: declare a
    stream and call ``host_rng(seed, "<stream>", *indices)``.
    """

    id = "GD002"
    title = "undeclared-entropy"

    def check(self, ctx: DetContext) -> Iterable[Diagnostic]:
        if _exempt(ctx, _PKG + "rng.py"):
            return
        for site in ctx.model.rng_constructors:
            yield ctx.diag_at(
                site.line, site.col, self.id,
                f"raw RNG constructor `{site.resolved}` outside "
                f"pvraft_tpu_torch/rng.py — derive entropy from the config "
                f"seed via a declared stream: rng.host_rng(seed, "
                f"'<stream>') / rng.torch_seed(seed, '<stream>')")
        for site in ctx.model.time_seeds:
            yield ctx.diag_at(
                site.line, site.col, self.id,
                f"time/entropy source `{site.via}` seeds `{site.seeding}` "
                f"— a wall-clock seed is unreplayable by construction; "
                f"thread the config seed through a declared stream")
        for site in ctx.model.stream_calls:
            if ctx.declared_streams is None:
                yield ctx.diag_at(
                    site.line, site.col, self.id,
                    f"`{site.func}` call but the STREAMS vocabulary "
                    f"could not be read from pvraft_tpu_torch/rng.py — "
                    f"the stream contract is unverifiable")
                continue
            if not site.stream_strs:
                yield ctx.diag_at(
                    site.line, site.col, self.id,
                    f"`{site.func}` call carries no stream name "
                    f"literal — name the stream: {site.func}(seed, "
                    f"'<stream>', ...)")
            for s in site.stream_strs:
                if s not in ctx.declared_streams:
                    yield ctx.diag_at(
                        site.line, site.col, self.id,
                        f"`{site.func}` uses undeclared stream {s!r} — "
                        f"declare it in pvraft_tpu_torch.rng.STREAMS "
                        f"(known: {', '.join(ctx.declared_streams)})")


# --- GD003 ----------------------------------------------------------------

@gd_register
class UndeclaredHazardProgram(DetRule):
    """Hazard-op program registered without a ``determinism=`` stance.

    Float scatter-adds (``index_add_``, ``scatter_add_``,
    ``scatter_reduce_``, ``index_put_(..., accumulate=True)``) run with
    atomics on the card, and ``torch.distributed`` reductions and ring
    exchanges sum in an order the group's layout decides: bitwise replay
    can hold on one card and break on another. A ProgramSpec whose
    static import closure reaches such an op must declare
    ``determinism="..."`` at its registration, so that the stance
    (sorted under ``use_deterministic_algorithms``, order fixed by the
    mesh, a tolerance accepted) is reviewable data. Findings anchor at
    the registration line in this file.
    """

    id = "GD003"
    title = "undeclared-hazard-program"

    def check(self, ctx: DetContext) -> Iterable[Diagnostic]:
        norm = ctx.norm_path
        for spec in ctx.hazard_specs:
            spec_norm = spec.path.replace("\\", "/")
            if not (spec_norm == norm or norm.endswith(spec_norm)
                    or spec_norm.endswith(norm)):
                continue
            if spec.determinism:
                continue
            yield ctx.diag_at(
                spec.line, 0, self.id,
                f"program spec `{spec.name}` reaches nondeterminism-"
                f"hazard ops ({', '.join(spec.kinds)} via {spec.via}) "
                f"but declares no determinism= stance — state it at the "
                f"registration (e.g. determinism='float-atomic "
                f"scatter_add; sorted under use_deterministic_algorithms')")


# --- GD004 ----------------------------------------------------------------

@gd_register
class UnroutedDeterminismFlag(DetRule):
    """Backend determinism flag written outside ``device.py``.

    TF32 (``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.backends.cudnn.allow_tf32``), cuDNN's ``deterministic`` and
    ``benchmark``, ``torch.use_deterministic_algorithms``,
    ``torch.set_float32_matmul_precision`` and the environment's
    ``CUBLAS_WORKSPACE_CONFIG`` and ``PYTHONHASHSEED`` change numerics or
    kernel choice process-wide; scattered writes make "which flags was
    this run under?" unanswerable and let two entry points disagree.
    Route the write through the owner's helpers in
    ``pvraft_tpu_torch/device.py`` (``set_tf32``,
    ``deterministic_algorithms``).
    """

    id = "GD004"
    title = "unrouted-determinism-flag"

    def check(self, ctx: DetContext) -> Iterable[Diagnostic]:
        if _exempt(ctx, _PKG + "device.py"):
            return
        for site in ctx.model.flag_writes:
            yield ctx.diag_at(
                site.line, site.col, self.id,
                f"determinism flag `{site.key}` written via {site.how} "
                f"outside pvraft_tpu_torch/device.py — route it through "
                f"a device.py helper so every entry point shares one "
                f"declaration")


# --- GD005 ----------------------------------------------------------------

@gd_register
class IterationOrderHazard(DetRule):
    """Unordered iteration feeding data, trace or selection order.

    ``glob``/``listdir`` order is filesystem-dependent: feeding it to
    dataset indexing or checkpoint selection makes sample order (and
    every downstream draw) differ across machines; wrap the enumeration
    in ``sorted(...)`` at the call. Set iteration order is salted per
    process: iterate ``sorted(...)`` of the set instead. (Dicts are
    insertion-ordered and fine.)
    """

    id = "GD005"
    title = "iteration-order-hazard"

    def check(self, ctx: DetContext) -> Iterable[Diagnostic]:
        for site in ctx.model.unsorted_globs:
            yield ctx.diag_at(
                site.line, site.col, self.id,
                f"filesystem enumeration `{site.callee}` is not wrapped "
                f"in sorted() — listing order is filesystem-dependent; "
                f"sort at the call site")
        for site in ctx.model.set_iters:
            yield ctx.diag_at(
                site.line, site.col, self.id,
                f"{site.detail} — set order is salted per process; "
                f"iterate sorted(...) instead")
