"""The port's threading model: what the GC rules reason over (the port's
own copy of ``pvraft_tpu/analysis/concurrency/model.py``).

Pure stdlib ``ast``: it runs in milliseconds on a host with no
accelerator stack. Per class the model extracts:

  * **lock fields**: ``self.X = threading.Lock()/RLock()/Condition()``
    and the sanitizer's ``ordered_lock(...)`` factory, plus
    ``threading.Event()`` and ``queue.Queue()`` fields (thread-safe
    objects the check-then-act rule cares about);
  * **guarded-by declarations**: a ``# guarded-by: <lock>`` comment on
    (or directly above) a field's assignment line declares which lock
    must be held at every access of that field outside ``__init__``;
  * **inferred guards**: a field written under ``with self.L:`` at two
    or more sites (and never annotated) is inferred guarded-by ``L``;
  * **attribute accesses**: every ``self.X`` read/write with the set
    of class/module locks lexically held at that point (``with``
    nesting; nested ``def``s start with an empty held set, because a
    closure body runs after the enclosing ``with`` exits);
  * **thread spawns**: ``threading.Thread(...)`` calls with their
    ``daemon=`` flag and ``target=``;
  * **lock-order edges**: lock B acquired while A is held, from
    lexically nested ``with`` blocks and through intra-class
    ``self.method()`` calls under a lock (transitive, depth-bounded),
    plus cross-class edges where a field's class is known from a
    constructor call in the same module.

Everything here is deliberately under-approximate (no cross-module call
graph, no alias analysis): a check that only flags certainties gets
kept.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from pvraft_tpu_torch.analysis.engine import _comment_tokens

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# Constructor spellings that make a field a lock / event / queue. Names
# are matched on the callee's dotted tail so `threading.Lock`, a bare
# `Lock` import, and the sanitizer factory all count.
_LOCK_CTORS = {"Lock", "RLock", "Condition", "ordered_lock", "OrderedLock"}
_EVENT_CTORS = {"Event"}
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")


def _dotted_tail(expr: ast.AST) -> str:
    """Last component of a dotted callee (``threading.Lock`` -> "Lock")."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return ""


def _self_attr(expr: ast.AST) -> Optional[str]:
    """``X`` when ``expr`` is exactly ``self.X``, else None."""
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return expr.attr
    return None


def _is_thread_join(node: ast.Call) -> bool:
    """Does this call look like ``thread.join([timeout])``? String and
    path joins (``", ".join(parts)``, ``os.path.join(a, b)``) must NOT
    count — one of those anywhere in a class would silence GC004 for
    every spawn in it. Thread joins take no argument, a single numeric
    timeout, or ``timeout=``: anything else (an iterable positional, a
    ``.path.`` receiver, a string-literal receiver) is treated as a
    non-thread join. Deliberately under-approximate in the direction
    that keeps GC004 ARMED."""
    func = node.func
    if not (isinstance(func, ast.Attribute) and func.attr == "join"):
        return False
    recv = func.value
    if isinstance(recv, ast.Constant):
        return False  # "sep".join(...)
    if isinstance(recv, ast.Attribute) and recv.attr == "path":
        return False  # os.path.join(...)
    if len(node.args) > 1:
        return False
    if node.args:
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, (int, float))):
            return False
    if any(kw.arg != "timeout" for kw in node.keywords):
        return False
    return True


@dataclasses.dataclass(frozen=True)
class Access:
    """One ``self.X`` touch: where, from which method, read or write,
    and which locks were lexically held."""

    attr: str
    line: int
    col: int
    method: str
    write: bool
    held: FrozenSet[str]


@dataclasses.dataclass(frozen=True)
class ThreadSpawn:
    """One ``threading.Thread(...)`` call site."""

    line: int
    col: int
    method: str            # "" for module level
    daemon: Optional[bool]  # None = keyword absent
    target: Optional[str]   # "X" for target=self.X, bare name otherwise


@dataclasses.dataclass(frozen=True)
class OrderEdge:
    """Lock ``a`` held while lock ``b`` is acquired (names are
    class-qualified: ``MicroBatcher._count_lock``)."""

    a: str
    b: str
    line: int
    col: int
    via: str  # "nested-with" | "call:<method chain>"


@dataclasses.dataclass
class ClassModel:
    name: str
    node: ast.ClassDef
    locks: Dict[str, int] = dataclasses.field(default_factory=dict)
    events: Dict[str, int] = dataclasses.field(default_factory=dict)
    queues: Dict[str, int] = dataclasses.field(default_factory=dict)
    # attr -> (lock attr, declaration line) from `# guarded-by:` comments.
    guards: Dict[str, Tuple[str, int]] = dataclasses.field(
        default_factory=dict)
    accesses: List[Access] = dataclasses.field(default_factory=list)
    spawns: List[ThreadSpawn] = dataclasses.field(default_factory=list)
    joins: int = 0  # thread-join call sites (see _is_thread_join)
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    # method -> locks it acquires anywhere in its own body (not callees).
    method_locks: Dict[str, Set[str]] = dataclasses.field(
        default_factory=dict)
    # method -> self-methods it calls (intra-class call graph).
    calls: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    # (held lock, called self-method, line, col) — call made under a lock.
    calls_under: List[Tuple[str, str, int, int]] = dataclasses.field(
        default_factory=list)
    # Lexically nested with-acquisitions: (outer, inner, line, col).
    nested_withs: List[Tuple[str, str, int, int]] = dataclasses.field(
        default_factory=list)
    # field -> class name, from `self.Y = ClassName(...)`.
    field_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    # (held lock, field, method-called-on-field, line, col).
    field_calls_under: List[Tuple[str, str, str, int, int]] = \
        dataclasses.field(default_factory=list)

    @property
    def concurrent(self) -> bool:
        """Does this class intend concurrency? Owning a lock or spawning
        a thread is the evidence; classes with neither are skipped by
        every GC rule (a single-threaded class cannot race)."""
        return bool(self.locks) or bool(self.spawns)

    def guard_of(self, attr: str) -> Optional[str]:
        """Declared guard lock of ``attr`` (annotations only)."""
        entry = self.guards.get(attr)
        return entry[0] if entry else None

    def inferred_guards(self) -> Dict[str, str]:
        """attr -> lock for UNANNOTATED fields the class itself treats
        as lock-guarded: >= 2 non-``__init__`` access sites hold the
        same class lock and at least one of them is a write. The rule
        layer flags the *outlier* unlocked writes of such fields (an
        unlocked read of a flag is a benign-racy idiom; an unlocked
        write to a field that is elsewhere lock-disciplined is almost
        always the bug). Fields disciplined under two different locks
        are ambiguous and skipped — annotate those explicitly."""
        per_attr: Dict[str, List[Access]] = {}
        for acc in self.accesses:
            if acc.method.split(".")[0] == "__init__":
                continue
            if acc.attr in self.guards or acc.attr in self.locks \
                    or acc.attr in self.events or acc.attr in self.queues:
                continue
            per_attr.setdefault(acc.attr, []).append(acc)
        out: Dict[str, str] = {}
        for attr, accs in per_attr.items():
            by_lock: Dict[str, List[Access]] = {}
            for a in accs:
                for lock in a.held & set(self.locks):
                    by_lock.setdefault(lock, []).append(a)
            candidates = {
                lock: under for lock, under in by_lock.items()
                if len(under) >= 2 and any(a.write for a in under)
            }
            if len(candidates) == 1:
                out[attr] = next(iter(candidates))
        return out

    def transitive_locks(self, method: str, depth: int = 4) -> Set[str]:
        """Locks ``method`` may acquire through intra-class calls."""
        seen: Set[str] = set()
        frontier = {method}
        for _ in range(depth):
            nxt: Set[str] = set()
            for m in frontier:
                if m in seen:
                    continue
                seen.add(m)
                nxt |= self.calls.get(m, set())
            frontier = nxt - seen
            if not frontier:
                break
        locks: Set[str] = set()
        for m in seen:
            locks |= self.method_locks.get(m, set())
        return locks

    def thread_entry_methods(self) -> Set[str]:
        """Methods that run on a spawned thread (``target=self.X``),
        expanded transitively through intra-class calls."""
        entries = {s.target for s in self.spawns
                   if s.target and s.target in self.methods}
        seen: Set[str] = set()
        frontier = set(entries)
        while frontier:
            m = frontier.pop()
            if m in seen:
                continue
            seen.add(m)
            frontier |= self.calls.get(m, set()) - seen
        return seen


@dataclasses.dataclass
class ModuleModel:
    path: str
    classes: List[ClassModel] = dataclasses.field(default_factory=list)
    module_locks: Set[str] = dataclasses.field(default_factory=set)
    module_spawns: List[ThreadSpawn] = dataclasses.field(
        default_factory=list)
    module_joins: int = 0

    def class_named(self, name: str) -> Optional[ClassModel]:
        for c in self.classes:
            if c.name == name:
                return c
        return None


def _guard_comments(source: str) -> Dict[int, Tuple[str, bool]]:
    """line -> (lock name, own_line) for every real ``# guarded-by:``
    comment token (docstring examples must not declare anything — same
    discipline as the suppression pragmas). ``own_line`` is True for a
    comment-only line: only those may annotate the assignment BELOW
    them — a trailing comment binds to its own line exclusively, so it
    cannot leak onto the next field."""
    lines = source.splitlines()
    out: Dict[int, Tuple[str, bool]] = {}
    for lineno, text in _comment_tokens(source):
        m = _GUARD_RE.search(text)
        if m:
            own = (0 < lineno <= len(lines)
                   and lines[lineno - 1].lstrip().startswith("#"))
            out[lineno] = (m.group(1), own)
    return out


class _MethodWalker:
    """Walks one method body tracking the lexically held lock set."""

    def __init__(self, cls: ClassModel, module: "ModuleModel",
                 method: str):
        self.cls = cls
        self.module = module
        self.method = method
        self.own_locks: Set[str] = set()

    # -- classification helpers --------------------------------------------

    def _lock_name(self, expr: ast.AST) -> Optional[str]:
        """Held-set name for a with-item context expr: a class lock
        field (``self.L``) or a module-level lock (bare name)."""
        attr = _self_attr(expr)
        if attr is not None and attr in self.cls.locks:
            return attr
        if isinstance(expr, ast.Name) and expr.id in self.module.module_locks:
            return expr.id
        return None

    def _is_write(self, node: ast.Attribute) -> bool:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            return True
        parent = getattr(node, "_gc_parent", None)
        # `self.X[i] = v` / `self.X[i] += v`: the attribute loads but the
        # object mutates — counts as a write for guard purposes.
        if isinstance(parent, ast.Subscript) and isinstance(
                parent.ctx, (ast.Store, ast.Del)):
            return True
        if isinstance(parent, ast.AugAssign) and parent.target is node:
            return True
        return False

    # -- the walk -----------------------------------------------------------

    def walk(self, stmts, held: FrozenSet[str]) -> None:
        for stmt in stmts:
            self._stmt(stmt, held)

    def _stmt(self, node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, _FUNC_NODES):
            # A nested def's body runs AFTER the enclosing with exits:
            # it starts with nothing held, under a qualified name.
            sub = _MethodWalker(self.cls, self.module,
                                f"{self.method}.{node.name}")
            sub.walk(node.body, frozenset())
            self.own_locks |= sub.own_locks
            # Nested closures fold into the enclosing method's call/lock
            # book-keeping (they are reachable from it).
            self.cls.method_locks.setdefault(self.method, set()).update(
                sub.own_locks)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[str] = []
            for item in node.items:
                self._expr(item.context_expr, held)
                name = self._lock_name(item.context_expr)
                if name is not None:
                    acquired.append(name)
            if acquired:
                self.own_locks.update(acquired)
                self.cls.method_locks.setdefault(
                    self.method, set()).update(acquired)
                for h in held:
                    for a in acquired:
                        if h != a:
                            self.cls.nested_withs.append(
                                (h, a, node.lineno, node.col_offset))
                # `with self.a, self.b:` acquires left-to-right — a real
                # a-before-b constraint, same as lexical nesting.
                for i, a in enumerate(acquired):
                    for b in acquired[i + 1:]:
                        if a != b:
                            self.cls.nested_withs.append(
                                (a, b, node.lineno, node.col_offset))
            self.walk(node.body, held | frozenset(acquired))
            return
        # Generic statement: record expressions at this held set, then
        # recurse into child statements with the same held set.
        for field_name, value in ast.iter_fields(node):
            if field_name in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.AST):
                self._expr(value, held)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.AST) and not isinstance(
                            v, ast.stmt):
                        self._expr(v, held)
        for child_field in ("body", "orelse", "finalbody"):
            self.walk(getattr(node, child_field, []) or [], held)
        for handler in getattr(node, "handlers", []) or []:
            self.walk(handler.body, held)

    def _expr(self, expr: ast.AST, held: FrozenSet[str]) -> None:
        for node in ast.walk(expr):
            for child in ast.iter_child_nodes(node):
                child._gc_parent = node  # type: ignore[attr-defined]
        # ast.walk descends into lambda bodies with the current held set
        # — over-approximate for code that runs later, which can only
        # hide a finding, never invent one. Real nested defs are handled
        # statement-side with a fresh empty held set.
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute):
                attr = _self_attr(node)
                if attr is not None:
                    self.cls.accesses.append(Access(
                        attr=attr, line=node.lineno, col=node.col_offset,
                        method=self.method, write=self._is_write(node),
                        held=held))
            if isinstance(node, ast.Call):
                if _is_thread_join(node):
                    self.cls.joins += 1
                self._call(node, held)

    def _call(self, node: ast.Call, held: FrozenSet[str]) -> None:
        tail = _dotted_tail(node.func)
        if tail == "Thread":
            daemon: Optional[bool] = None
            target: Optional[str] = None
            for kw in node.keywords:
                if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                    daemon = bool(kw.value.value)
                elif kw.arg == "target":
                    t = _self_attr(kw.value)
                    if t is None and isinstance(kw.value, ast.Name):
                        t = kw.value.id
                    elif t is None and isinstance(kw.value, ast.Attribute):
                        # self.httpd.serve_forever -> outermost attr name
                        t = kw.value.attr
                    target = t
            self.cls.spawns.append(ThreadSpawn(
                line=node.lineno, col=node.col_offset, method=self.method,
                daemon=daemon, target=target))
            return
        func = node.func
        if isinstance(func, ast.Attribute):
            # Call-graph/lock bookkeeping keys on the ROOT method name:
            # a closure defined inside `seal` is reachable from `seal`.
            root = self.method.split(".", 1)[0]
            owner = _self_attr(func.value)
            if owner is not None:
                # self.<owner>.<method>(...) — a call on a field.
                self.cls.field_calls_under.extend(
                    (h, owner, func.attr, node.lineno, node.col_offset)
                    for h in held)
                return
            callee = _self_attr(func)
            if callee is not None:
                # self.<callee>(...) — intra-class call.
                self.cls.calls.setdefault(root, set()).add(callee)
                for h in held:
                    self.cls.calls_under.append(
                        (h, callee, node.lineno, node.col_offset))


def build_module_model(tree: ast.Module, source: str,
                       path: str) -> ModuleModel:
    """Extract the concurrency model of one parsed module."""
    module = ModuleModel(path=path)
    guards_by_line = _guard_comments(source)

    # Module-level locks/spawns/joins (outside any class body).
    class_node_ids: Set[int] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef):
            for n in ast.walk(stmt):
                class_node_ids.add(id(n))
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call):
            tail = _dotted_tail(stmt.value.func)
            if tail in _LOCK_CTORS:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        module.module_locks.add(t.id)
    for node in ast.walk(tree):
        if id(node) in class_node_ids:
            continue
        if isinstance(node, ast.Call) and _dotted_tail(node.func) == "Thread":
            daemon = None
            target = None
            for kw in node.keywords:
                if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                    daemon = bool(kw.value.value)
                elif kw.arg == "target" and isinstance(kw.value, ast.Name):
                    target = kw.value.id
            module.module_spawns.append(ThreadSpawn(
                line=node.lineno, col=node.col_offset, method="",
                daemon=daemon, target=target))
        if isinstance(node, ast.Call) and _is_thread_join(node):
            module.module_joins += 1

    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef):
            module.classes.append(
                _build_class(stmt, module, guards_by_line))
    return module


def _build_class(node: ast.ClassDef, module: ModuleModel,
                 guards_by_line: Dict[int, Tuple[str, bool]]) -> ClassModel:
    cls = ClassModel(name=node.name, node=node)

    # Pass 1: field classification + guarded-by declarations, from every
    # `self.X = <ctor>()` in every method (locks are almost always born
    # in __init__, but lazily created fields count too). AnnAssign covers
    # the `self.rejected: Dict[str, int] = {}` spelling.
    for fn in ast.walk(node):
        if isinstance(fn, ast.Assign):
            targets = fn.targets
            value = fn.value
        elif isinstance(fn, ast.AnnAssign) and fn.value is not None:
            targets = [fn.target]
            value = fn.value
        else:
            continue
        for target in targets:
            attr = _self_attr(target)
            if attr is None:
                continue
            if isinstance(value, ast.Call):
                tail = _dotted_tail(value.func)
                if tail in _LOCK_CTORS:
                    cls.locks.setdefault(attr, fn.lineno)
                elif tail in _EVENT_CTORS:
                    cls.events.setdefault(attr, fn.lineno)
                elif tail in _QUEUE_CTORS:
                    cls.queues.setdefault(attr, fn.lineno)
                elif tail and tail[0].isupper():
                    cls.field_types.setdefault(attr, tail)
            entry = guards_by_line.get(fn.lineno)
            if entry is None:
                above = guards_by_line.get(fn.lineno - 1)
                if above is not None and above[1]:
                    entry = above  # comment-only line annotating below
            if entry is not None:
                cls.guards.setdefault(attr, (entry[0], fn.lineno))

    # Pass 2: per-method held-lock walk.
    for stmt in node.body:
        if isinstance(stmt, _FUNC_NODES):
            cls.methods[stmt.name] = stmt
            walker = _MethodWalker(cls, module, stmt.name)
            walker.walk(stmt.body, frozenset())
            cls.method_locks.setdefault(stmt.name, set()).update(
                walker.own_locks)
    return cls
