"""Static model of one module's filesystem writes and the process-0
guards over them: the facts GS004 consumes (the port's own copy of the
GS004 half of ``pvraft_tpu/analysis/sharding/model.py``).

Pure stdlib ``ast``. One walk extracts the module's **write sites**:
filesystem mutations (``WRITE_APIS``, ``torch.save``, a write-mode
``open``), each with a guard analysis:

* lexical rank-0 ``if`` bodies (``if process_index() == 0:``,
  ``if self.mesh.process_index == 0:``), and single-process proofs
  (``process_count() == 1``, ``<= 1``, ``< 2``);
* terminating guard clauses (``if process_index() != 0: return``,
  ``if process_count() > 1: raise``);
* process-0 locals and flag fields: a name or ``self.X`` assigned from a
  rank-0 compare (``lead = process_index() == 0``, the
  ``EventLog.enabled`` pattern);
* module-local writer helpers whose every in-module call site is
  guarded (the ``checkpoint.py`` ``_write`` shape).

The port's spellings of the rank: ``process_index()``/``process_count()``
of ``parallel/distributed.py`` and the ``Mesh`` fields of those names;
the analysis matches the name wherever it appears in the compare.

The analysis is syntactic and local, as the JAX one: a write it cannot
prove guarded is a finding (fail closed).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from pvraft_tpu_torch.analysis.engine import dotted_name as _dotted

# Filesystem mutations GS004 watches: the JAX package's set and
# ``torch.save``. ``os.makedirs``/``os.mkdir`` with ``exist_ok=True`` are
# exempt (an idempotent ensure is safe on every rank at once).
WRITE_APIS = frozenset({
    "os.makedirs", "os.mkdir", "os.replace", "os.rename", "os.unlink",
    "os.remove", "os.rmdir", "np.save", "np.savez", "np.savez_compressed",
    "numpy.save", "numpy.savez", "numpy.savez_compressed",
    "shutil.rmtree", "shutil.copytree", "shutil.copy", "shutil.copy2",
    "shutil.move", "torch.save",
})


def _tail(node: ast.AST) -> str:
    d = _dotted(node)
    return d.rsplit(".", 1)[-1] if d else ""


def _contains_text(node: ast.AST, text: str) -> bool:
    """Does any Name/Attribute in the subtree spell ``text``?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr == text:
            return True
        if isinstance(n, ast.Name) and n.id == text:
            return True
    return False


@dataclasses.dataclass(frozen=True)
class WriteSite:
    line: int
    col: int
    call: str
    func: str           # enclosing function name ("<module>": module body)
    owner: str          # enclosing class name ("" outside a class)
    guarded: bool


@dataclasses.dataclass
class ModuleShardModel:
    write_sites: List[WriteSite]


# --- guard grammar ---------------------------------------------------------

def _is_rank_compare(node: ast.AST, api: str, values: Sequence[int],
                     ops) -> bool:
    """``<...api...> OP <int in values>`` (either side)."""
    if not isinstance(node, ast.Compare) or len(node.ops) != 1:
        return False
    left, op, right = node.left, node.ops[0], node.comparators[0]
    if not isinstance(op, ops):
        return False
    for a, b in ((left, right), (right, left)):
        if (_contains_text(a, api) and isinstance(b, ast.Constant)
                and b.value in values):
            return True
    return False


class _GuardLattice:
    """Per-class taint of process-0 flags, and the guard-test classifier."""

    def __init__(self):
        self.rank0_fields: Set[str] = set()   # self.<field> is a p0 flag
        self.rank0_locals: Set[str] = set()   # per function

    def is_rank0_true(self, test: ast.AST) -> bool:
        """Inside ``if test:`` the process is provably 0 (or provably the
        only process)."""
        if _is_rank_compare(test, "process_index", (0,), (ast.Eq,)):
            return True
        if _is_rank_compare(test, "process_count", (1,), (ast.Eq,)) or \
                _is_rank_compare(test, "process_count", (1, 2),
                                 (ast.Lt, ast.LtE)):
            return True
        if isinstance(test, ast.Name) and test.id in self.rank0_locals:
            return True
        if isinstance(test, ast.Attribute) and \
                isinstance(test.value, ast.Name) and \
                test.value.id == "self" and test.attr in self.rank0_fields:
            return True
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.is_rank0_exit(test.operand)
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            return any(self.is_rank0_true(v) for v in test.values)
        return False

    def is_rank0_exit(self, test: ast.AST) -> bool:
        """``if test: return/raise`` leaves only process 0 (or a single
        process) on the fall-through path."""
        if _is_rank_compare(test, "process_index", (0,), (ast.NotEq,)) or \
                _is_rank_compare(test, "process_index", (0,), (ast.Gt,)):
            return True
        if _is_rank_compare(test, "process_count", (1,), (ast.NotEq,)) or \
                _is_rank_compare(test, "process_count", (1, 2),
                                 (ast.Gt, ast.GtE)):
            return True
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.is_rank0_true(test.operand)
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            # `if flag and count > 1: raise`: the fall-through is
            # single-process where the flag holds, and the write is gated
            # on the same flag (the JAX evaluator's dump_dir guard).
            return any(self.is_rank0_exit(v) for v in test.values)
        return False

    def taint_function(self, fn: ast.AST) -> None:
        """Rank-0 locals: names assigned (anywhere in ``fn``) from an
        expression holding a process_index-vs-0 compare."""
        self.rank0_locals = set()
        if not _contains_text(fn, "process_index"):
            return
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and n.targets:
                if self._rank0_expr(n.value):
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            self.rank0_locals.add(t.id)

    def _rank0_expr(self, expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            if _is_rank_compare(n, "process_index", (0,), (ast.Eq,)):
                return True
            if isinstance(n, ast.Name) and n.id in self.rank0_locals:
                return True
        return False

    def taint_class(self, cls: ast.ClassDef) -> None:
        """Two passes: function-local flags, then ``self.X = <flag>``."""
        self.rank0_fields = set()
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            self.taint_function(item)
            for n in ast.walk(item):
                if isinstance(n, ast.Assign) and self._rank0_expr(n.value):
                    for t in n.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            self.rank0_fields.add(t.attr)


def _body_terminates(body: Sequence[ast.stmt]) -> bool:
    return any(isinstance(s, (ast.Return, ast.Raise, ast.Continue, ast.Break))
               for s in body)


# --- write sites -----------------------------------------------------------

def _write_call(node: ast.Call) -> Optional[str]:
    """The WRITE_APIS spelling of a call, 'open' for a write-mode open,
    or None."""
    dotted = _dotted(node.func)
    if dotted in WRITE_APIS:
        if dotted in ("os.makedirs", "os.mkdir"):
            for kw in node.keywords:
                if kw.arg == "exist_ok" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value is True:
                    return None
        return dotted
    if isinstance(node.func, ast.Name) and node.func.id == "open":
        mode = None
        if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
            mode = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        if isinstance(mode, str) and any(c in mode for c in "wax+"):
            return "open"
    return None


class _FunctionWrites:
    """Write sites, and writer-helper call sites, of one function with
    their lexical guard state."""

    def __init__(self, lattice: _GuardLattice):
        self.lattice = lattice
        self.writes: List[Tuple[int, int, str, bool]] = []
        self.calls: List[Tuple[str, bool]] = []   # (callee name, guarded)

    def scan(self, fn) -> None:
        self.lattice.taint_function(fn)
        self._block(fn.body, False)

    def _expr(self, node: ast.AST, guarded: bool) -> None:
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue  # nested scopes: the module pass scans them
            if isinstance(n, ast.Call):
                w = _write_call(n)
                if w:
                    self.writes.append(
                        (n.lineno, n.col_offset, w, guarded))
                callee = _tail(n.func)
                if callee:
                    self.calls.append((callee, guarded))

    def _block(self, body: Sequence[ast.stmt], guarded: bool) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                self._expr(stmt.test, guarded)
                if self.lattice.is_rank0_true(stmt.test):
                    self._block(stmt.body, True)
                    self._block(stmt.orelse, guarded)
                elif self.lattice.is_rank0_exit(stmt.test) and \
                        _body_terminates(stmt.body):
                    self._block(stmt.body, guarded)
                    self._block(stmt.orelse, guarded)
                    guarded = True  # the fall-through is process 0
                else:
                    self._block(stmt.body, guarded)
                    self._block(stmt.orelse, guarded)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._expr(stmt.iter, guarded)
                self._block(stmt.body, guarded)
                self._block(stmt.orelse, guarded)
                continue
            if isinstance(stmt, ast.While):
                self._expr(stmt.test, guarded)
                self._block(stmt.body, guarded)
                self._block(stmt.orelse, guarded)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._expr(item.context_expr, guarded)
                self._block(stmt.body, guarded)
                continue
            if isinstance(stmt, ast.Try):
                self._block(stmt.body, guarded)
                for h in stmt.handlers:
                    self._block(h.body, guarded)
                self._block(stmt.orelse, guarded)
                self._block(stmt.finalbody, guarded)
                continue
            self._expr(stmt, guarded)


def _collect_write_sites(tree: ast.Module) -> List[WriteSite]:
    """Per-function lexical analysis (the module body is the
    ``<module>`` scope: an import-time write runs on every rank too),
    then the writer-helper dominance fixpoint: a helper whose every
    in-module call site is guarded inherits the guard."""
    functions: List[Tuple[str, str, ast.AST]] = [("", "<module>", tree)]

    def discover(body, owner: str) -> None:
        """Every def and class, wherever nested (under if/try/with too)."""
        for item in body:
            if isinstance(item, ast.ClassDef):
                discover(item.body, item.name)
            elif isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                functions.append((owner, item.name, item))
                discover(item.body, owner)
            else:
                for sub in (getattr(item, "body", ()),
                            getattr(item, "orelse", ()),
                            getattr(item, "finalbody", ())):
                    discover(sub, owner)
                for h in getattr(item, "handlers", ()):
                    discover(h.body, owner)

    discover(tree.body, "")

    lattice = _GuardLattice()
    class_nodes = {n.name: n for n in ast.walk(tree)
                   if isinstance(n, ast.ClassDef)}
    field_cache: Dict[str, Set[str]] = {}
    per_fn: Dict[Tuple[str, str], _FunctionWrites] = {}
    order: List[Tuple[str, str]] = []
    for owner, name, fn in functions:
        if owner and owner in class_nodes:
            if owner not in field_cache:
                lattice.taint_class(class_nodes[owner])
                field_cache[owner] = set(lattice.rank0_fields)
            lattice.rank0_fields = field_cache[owner]
        else:
            lattice.rank0_fields = set()
        fw = _FunctionWrites(lattice)
        fw.scan(fn)
        key = (owner, name)
        if key not in per_fn:       # the first def wins on a repeated name
            per_fn[key] = fw
            order.append(key)

    # Least fixpoint, grown from lexically guarded call sites: a function
    # is guard-dominated iff it has in-module call sites and every one is
    # guarded or inside a dominated function. (A greatest fixpoint would
    # prove a mutually recursive writer pair with no outside caller
    # guarded: fail closed.)
    name_to_keys: Dict[str, List[Tuple[str, str]]] = {}
    for k in per_fn:
        name_to_keys.setdefault(k[1], []).append(k)
    call_sites: Dict[Tuple[str, str], List[Tuple[Tuple[str, str], bool]]] = \
        {k: [] for k in per_fn}
    for caller, fw in per_fn.items():
        for callee, guarded in fw.calls:
            for key in name_to_keys.get(callee, ()):
                if key != caller:
                    call_sites[key].append((caller, guarded))
    dominated: Set[Tuple[str, str]] = set()
    changed = True
    while changed:
        changed = False
        for key, sites in call_sites.items():
            if key in dominated or not sites:
                continue
            if all(guarded or caller in dominated
                   for caller, guarded in sites):
                dominated.add(key)
                changed = True

    out: List[WriteSite] = []
    for key in order:
        owner, name = key
        for line, col, call, guarded in per_fn[key].writes:
            out.append(WriteSite(
                line=line, col=col, call=call, func=name, owner=owner,
                guarded=guarded or key in dominated))
    out.sort(key=lambda w: (w.line, w.col))
    return out


def build_module_shard_model(tree: ast.Module) -> ModuleShardModel:
    return ModuleShardModel(write_sites=_collect_write_sites(tree))
