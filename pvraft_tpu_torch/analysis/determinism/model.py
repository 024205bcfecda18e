"""detcheck model of the port: one AST walk -> the determinism-relevant
sites (the port's own copy of ``pvraft_tpu/analysis/determinism/
model.py``, with torch's shapes in place of JAX's).

A record per site class, extracted in one pass with an import-alias map,
so that ``random.random`` resolves to the stdlib in a file that did
``import random`` and ``dist.all_reduce`` to ``torch.distributed`` in one
that did ``import torch.distributed as dist``. Rules read these records
and never re-walk the tree.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple


def _dotted(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain, or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def build_alias_map(tree: ast.Module) -> Dict[str, str]:
    """Local name -> fully qualified module/symbol, from every import
    statement in the module (function-level imports included)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".", 1)[0]] = (
                    a.name if a.asname else a.name.split(".", 1)[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def resolve_dotted(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted name with its first segment resolved through the alias
    map: ``np.random.default_rng`` -> ``numpy.random.default_rng``.
    Unresolved names pass through unchanged."""
    dotted = _dotted(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    full = aliases.get(head, head)
    return f"{full}.{rest}" if rest else full


@dataclasses.dataclass(frozen=True)
class RngConstructorSite:
    """A raw RNG constructor or seeding call (GD002)."""

    line: int
    col: int
    resolved: str  # fully resolved dotted callee


@dataclasses.dataclass(frozen=True)
class StreamSite:
    """A ``host_rng``/``host_entropy``/``torch_seed`` call (GD001 and
    GD002's streams)."""

    line: int
    col: int
    func: str
    stream_strs: Tuple[str, ...]   # string-constant args, in order
    seed: str                      # the seed argument's source text
    literal_parts: bool            # every part after the seed a constant
    parts: Tuple[object, ...]      # those constants


@dataclasses.dataclass(frozen=True)
class TimeSeedSite:
    """A time/entropy call inside an RNG-seeding expression (GD002)."""

    line: int
    col: int
    via: str      # the time/entropy callee
    seeding: str  # the rng call it feeds


@dataclasses.dataclass(frozen=True)
class FlagWriteSite:
    """A watched determinism flag written (GD004)."""

    line: int
    col: int
    key: str
    how: str  # "os.environ[...]", "attribute assignment", ...


@dataclasses.dataclass(frozen=True)
class UnsortedGlobSite:
    """A filesystem enumeration not wrapped in sorted() (GD005)."""

    line: int
    col: int
    callee: str


@dataclasses.dataclass(frozen=True)
class SetIterSite:
    """Direct iteration over a set expression (GD005)."""

    line: int
    col: int
    detail: str


@dataclasses.dataclass(frozen=True)
class HazardOpSite:
    """A nondeterminism-hazard op (GD003's module-level evidence)."""

    line: int
    col: int
    kind: str   # "scatter-accumulate" | "collective-reduction" | "ring-fold"


# GD002: numpy's Generator constructors and legacy global API, the
# stdlib random module, and torch's generators and global seeding.
# torch's samplers (rand, randn, ...) consume a generator; they mint no
# entropy.
_TORCH_RNG = ("torch.Generator", "torch.manual_seed", "torch.seed",
              "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
              "torch.cuda.seed", "torch.cuda.seed_all",
              "torch.random.manual_seed", "torch.random.seed")
_TIME_ENTROPY = ("time.time", "time.time_ns", "time.monotonic",
                 "time.monotonic_ns", "time.perf_counter",
                 "time.perf_counter_ns", "os.urandom", "os.getpid",
                 "uuid.uuid1", "uuid.uuid4", "datetime.datetime.now",
                 "datetime.datetime.utcnow", "secrets.token_bytes")
# The stream calls of pvraft_tpu_torch/rng.py.
STREAM_FUNCS = ("host_rng", "host_entropy", "torch_seed")

# GD003 hazard vocabularies: float accumulations whose order is the
# device's choice (exact callee tails), and torch.distributed calls that
# reduce across ranks or fold values around a ring.
_SCATTER_OPS = ("index_add", "index_add_", "scatter_add", "scatter_add_",
                "scatter_reduce", "scatter_reduce_")
_DIST_REDUCTIONS = ("all_reduce", "reduce", "reduce_scatter",
                    "reduce_scatter_tensor", "all_reduce_coalesced")
_DIST_RING = ("send", "recv", "isend", "irecv", "batch_isend_irecv")

# GD004 watched surfaces: the switches that change numerics or the
# choice of deterministic kernels process-wide.
WATCHED_ENV_KEYS = ("CUBLAS_WORKSPACE_CONFIG", "PYTHONHASHSEED")
WATCHED_ATTRS = ("torch.backends.cuda.matmul.allow_tf32",
                 "torch.backends.cudnn.allow_tf32",
                 "torch.backends.cudnn.deterministic",
                 "torch.backends.cudnn.benchmark")
WATCHED_CALLS = ("torch.use_deterministic_algorithms",
                 "torch.set_float32_matmul_precision")

_FS_ENUM = {"glob.glob": "glob.glob", "glob.iglob": "glob.iglob",
            "os.listdir": "os.listdir", "os.scandir": "os.scandir"}
_FS_ENUM_METHODS = ("glob", "rglob", "iterdir")


def _is_rng_constructor(resolved: str) -> bool:
    if resolved.startswith("numpy.random."):
        return True
    if resolved == "random" or resolved.startswith("random."):
        return True
    return resolved in _TORCH_RNG


def _generator_seeding(call: ast.Call,
                       aliases: Dict[str, str]) -> Optional[str]:
    """For ``<generator>.manual_seed(...)``: "site" when it seeds a
    generator made elsewhere, "seed" when the generator is a
    ``torch.Generator(...)`` call of the same expression (that call is the
    site; only its seed is read here); None for any other call."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "manual_seed"):
        return None
    recv = fn.value
    if isinstance(recv, ast.Call) and \
            resolve_dotted(recv.func, aliases) == "torch.Generator":
        return "seed"
    return None if resolve_dotted(fn, aliases) in _TORCH_RNG else "site"


def stream_call(call: ast.Call,
                aliases: Dict[str, str]) -> Optional["StreamSite"]:
    """The :class:`StreamSite` of a ``host_rng``/``host_entropy``/
    ``torch_seed`` call of ``pvraft_tpu_torch.rng``, or None."""
    tail = _tail(call.func)
    resolved = resolve_dotted(call.func, aliases)
    if tail not in STREAM_FUNCS or not (
            resolved in STREAM_FUNCS
            or (resolved or "").startswith("pvraft_tpu_torch.rng.")):
        return None
    seed = ast.unparse(call.args[0]) if call.args else ""
    rest = call.args[1:]
    return StreamSite(
        call.lineno, call.col_offset, tail,
        tuple(a.value for a in call.args
              if isinstance(a, ast.Constant) and isinstance(a.value, str)),
        seed, all(isinstance(a, ast.Constant) for a in rest)
        and not call.keywords,
        tuple(a.value for a in rest if isinstance(a, ast.Constant)))


@dataclasses.dataclass
class ModuleDetModel:
    """Everything the GD rules read about one module."""

    aliases: Dict[str, str]
    rng_constructors: List[RngConstructorSite]
    stream_calls: List[StreamSite]
    time_seeds: List[TimeSeedSite]
    flag_writes: List[FlagWriteSite]
    unsorted_globs: List[UnsortedGlobSite]
    set_iters: List[SetIterSite]
    hazard_ops: List[HazardOpSite]


def _hazard(call: ast.Call, resolved: Optional[str],
            tail: Optional[str]) -> Optional[str]:
    """The hazard kind of a call, or None."""
    if tail in _SCATTER_OPS:
        return "scatter-accumulate"
    if tail in ("index_put_", "index_put") and any(
            kw.arg == "accumulate" and not (
                isinstance(kw.value, ast.Constant) and not kw.value.value)
            for kw in call.keywords):
        return "scatter-accumulate"
    if (resolved or "").startswith("torch.distributed."):
        if tail in _DIST_REDUCTIONS:
            return "collective-reduction"
        if tail in _DIST_RING:
            return "ring-fold"
    return None


def build_module_det_model(tree: ast.Module) -> ModuleDetModel:
    aliases = build_alias_map(tree)
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node

    model = ModuleDetModel(aliases, [], [], [], [], [], [], [])

    def seed_expr_taint(call: ast.Call, seeding: str) -> None:
        for sub in ast.walk(call):
            if isinstance(sub, ast.Call) and sub is not call:
                r = resolve_dotted(sub.func, aliases)
                if r in _TIME_ENTROPY:
                    model.time_seeds.append(TimeSeedSite(
                        sub.lineno, sub.col_offset, r, seeding))

    for node in ast.walk(tree):
        # -- iteration-order hazards (GD005) --------------------------------
        if isinstance(node, (ast.For, ast.comprehension)):
            it = node.iter
            line = getattr(node, "lineno", None) or \
                getattr(it, "lineno", 0)
            col = getattr(node, "col_offset", None)
            if col is None:
                col = getattr(it, "col_offset", 0)
            if isinstance(it, ast.Set):
                model.set_iters.append(SetIterSite(
                    line, col, "iterates a set literal"))
            elif isinstance(it, ast.Call) and \
                    _tail(it.func) in ("set", "frozenset") and \
                    resolve_dotted(it.func, aliases) in ("set", "frozenset"):
                model.set_iters.append(SetIterSite(
                    line, col, f"iterates a {_tail(it.func)}() result"))

        if not isinstance(node, ast.Call):
            continue

        resolved = resolve_dotted(node.func, aliases)
        tail = _tail(node.func)

        # -- raw RNG constructors + time-derived seeds (GD002) --------------
        if resolved is not None and _is_rng_constructor(resolved):
            model.rng_constructors.append(RngConstructorSite(
                node.lineno, node.col_offset, resolved))
            seed_expr_taint(node, resolved)
        elif (seeding := _generator_seeding(node, aliases)) is not None:
            if seeding == "site":
                model.rng_constructors.append(RngConstructorSite(
                    node.lineno, node.col_offset,
                    "torch.Generator.manual_seed"))
            seed_expr_taint(node, "torch.Generator.manual_seed")
        elif (stream := stream_call(node, aliases)) is not None:
            model.stream_calls.append(stream)
            seed_expr_taint(node, f"{tail}(...)")

        # -- watched flag writes (GD004): call shapes ----------------------
        if resolved in ("os.environ.setdefault", "os.putenv",
                        "os.environ.update"):
            key = None
            if node.args and isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                key = node.args[0].value
            elif resolved == "os.environ.update" and node.args and \
                    isinstance(node.args[0], ast.Dict):
                for k in node.args[0].keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str) and \
                            k.value in WATCHED_ENV_KEYS:
                        key = k.value
                        break
            if key in WATCHED_ENV_KEYS:
                model.flag_writes.append(FlagWriteSite(
                    node.lineno, node.col_offset, key, resolved))
        elif resolved in WATCHED_CALLS:
            model.flag_writes.append(FlagWriteSite(
                node.lineno, node.col_offset, resolved, "a call"))

        # -- filesystem enumeration (GD005) ---------------------------------
        fs_callee = None
        if resolved in _FS_ENUM:
            fs_callee = _FS_ENUM[resolved]
        elif tail in _FS_ENUM_METHODS and isinstance(node.func,
                                                     ast.Attribute):
            head = resolve_dotted(node.func.value, aliases) or ""
            # The method form covers Path objects (p.glob/rglob/iterdir).
            if head not in ("glob",):
                fs_callee = f".{tail}()"
        if fs_callee is not None:
            parent = parents.get(id(node))
            wrapped = (isinstance(parent, ast.Call)
                       and _tail(parent.func) == "sorted")
            if not wrapped:
                model.unsorted_globs.append(UnsortedGlobSite(
                    node.lineno, node.col_offset, fs_callee))

        # -- nondeterminism-hazard ops (GD003 evidence) ---------------------
        kind = _hazard(node, resolved, tail)
        if kind is not None:
            model.hazard_ops.append(HazardOpSite(
                node.lineno, node.col_offset, kind))

    # -- watched flag writes (GD004): subscript/attribute assignment -------
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Subscript):
                base = resolve_dotted(t.value, aliases)
                key = None
                sl = t.slice
                if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                    key = sl.value
                if base == "os.environ" and key in WATCHED_ENV_KEYS:
                    model.flag_writes.append(FlagWriteSite(
                        node.lineno, node.col_offset, key,
                        "os.environ[...]"))
            elif isinstance(t, ast.Attribute):
                dotted = resolve_dotted(t, aliases) or ""
                if dotted in WATCHED_ATTRS:
                    model.flag_writes.append(FlagWriteSite(
                        node.lineno, node.col_offset, dotted,
                        "attribute assignment"))

    for bucket in (model.rng_constructors, model.stream_calls,
                   model.time_seeds, model.flag_writes,
                   model.unsorted_globs, model.set_iters,
                   model.hazard_ops):
        bucket.sort(key=lambda s: (s.line, s.col))
    return model
