"""threadcheck rules GC001-GC004 of the port: the race shapes of
hand-threaded serving code (the port's own copy of
``pvraft_tpu/analysis/concurrency/rules.py``, with the same ids, titles
and messages).

Each rule has a red and a green example in the JAX package's corpus
``tests/fixtures/threadcheck/``, which both checkers are held to.
Suppress with ``# graftlint: disable=GCxxx -- reason`` (the shared pragma
grammar; a pragma without a reason counts as debt).

Scope discipline: rules only fire inside classes the model can prove
intend concurrency (owning a lock or spawning a thread), and only on
``self.X`` fields it can resolve. No cross-module call graph, no alias
analysis: flag certainties.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Type

from pvraft_tpu_torch.analysis.engine import Diagnostic, LintContext, Rule
from pvraft_tpu_torch.analysis.concurrency.model import (
    ClassModel,
    ModuleModel,
    _self_attr,
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


class ConcurrencyContext(LintContext):
    """LintContext + the extracted concurrency model."""

    def __init__(self, path: str, source: str, tree: ast.Module,
                 model: ModuleModel):
        super().__init__(path, source, tree)
        self.model = model


class ConcurrencyRule(Rule):
    """Base for GC rules: sees one file's :class:`ConcurrencyContext`."""

    def check(self, ctx: ConcurrencyContext) -> Iterable[Diagnostic]:
        raise NotImplementedError


_GC_REGISTRY: List[Type[ConcurrencyRule]] = []


def gc_register(cls: Type[ConcurrencyRule]) -> Type[ConcurrencyRule]:
    if not cls.id or not cls.title:
        raise ValueError(f"rule {cls.__name__} must set id and title")
    if any(r.id == cls.id for r in _GC_REGISTRY):
        raise ValueError(f"duplicate rule id {cls.id}")
    _GC_REGISTRY.append(cls)
    return cls


def all_concurrency_rules() -> Tuple[Type[ConcurrencyRule], ...]:
    return tuple(sorted(_GC_REGISTRY, key=lambda r: r.id))


# --- GC001 ----------------------------------------------------------------

@gc_register
class GuardedFieldOutsideLock(ConcurrencyRule):
    """Guarded field accessed without its lock.

    A field declared ``# guarded-by: <lock>`` on its assignment line must
    be read AND written with that lock held everywhere outside
    ``__init__`` (construction happens-before thread start). Fields never
    annotated but written under exactly one ``with self.L:`` at 2+ sites
    get the guard INFERRED — for those, only unlocked *writes* are
    flagged (an unlocked read of a flag is a benign-racy idiom; an
    unlocked write to a field that is elsewhere lock-disciplined is
    almost always the bug: the ``in_flight`` identity and
    ``record_submit`` races of the serving tier had exactly this shape).
    """

    id = "GC001"
    title = "guarded-field-outside-lock"

    def check(self, ctx: ConcurrencyContext) -> Iterable[Diagnostic]:
        for cls in ctx.model.classes:
            if not cls.concurrent:
                continue
            inferred = cls.inferred_guards()
            for acc in cls.accesses:
                if acc.method.split(".")[0] == "__init__":
                    continue
                declared = cls.guard_of(acc.attr)
                if declared is not None:
                    if declared not in acc.held:
                        yield Diagnostic(
                            ctx.path, acc.line, acc.col, self.id,
                            f"`self.{acc.attr}` is declared guarded-by "
                            f"`{declared}` but accessed in "
                            f"`{cls.name}.{acc.method}` without holding "
                            f"it; wrap the access in `with self."
                            f"{declared}:` (or fix the annotation)")
                    continue
                lock = inferred.get(acc.attr)
                if lock is not None and acc.write and lock not in acc.held:
                    yield Diagnostic(
                        ctx.path, acc.line, acc.col, self.id,
                        f"`self.{acc.attr}` is written under `with self."
                        f"{lock}:` everywhere else in `{cls.name}` but "
                        f"written here ({acc.method}) without it — either "
                        f"take the lock or annotate the field's intent "
                        f"with `# guarded-by:`")


# --- GC002 ----------------------------------------------------------------

def _lock_order_edges(model: ModuleModel,
                      classes_by_name: Dict[str, ClassModel],
                      ) -> List[Tuple[str, str, int, int, str]]:
    """(a, b, line, col, via) edges of the acquisition-order graph for
    one module, lock names class-qualified."""
    edges: List[Tuple[str, str, int, int, str]] = []
    for cls in model.classes:
        q = f"{cls.name}."
        for a, b, line, col in cls.nested_withs:
            edges.append((q + a, q + b, line, col, "nested with"))
        for held, callee, line, col in cls.calls_under:
            for lock in cls.transitive_locks(callee):
                if lock != held:
                    edges.append((q + held, q + lock, line, col,
                                  f"call self.{callee}()"))
        for held, field, meth, line, col in cls.field_calls_under:
            target_cls = classes_by_name.get(cls.field_types.get(field, ""))
            if target_cls is None:
                continue
            locks = target_cls.method_locks.get(meth, set()) | \
                target_cls.transitive_locks(meth)
            for lock in locks:
                edges.append((q + held, f"{target_cls.name}.{lock}",
                              line, col,
                              f"call self.{field}.{meth}()"))
    return edges


def _find_cycle(graph: Dict[str, Set[str]]) -> Optional[List[str]]:
    """One cycle as a node list [a, b, ..., a], or None."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    stack: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GREY
        stack.append(n)
        for m in sorted(graph.get(n, ())):
            if color.get(m, WHITE) == GREY:
                return stack[stack.index(m):] + [m]
            if color.get(m, WHITE) == WHITE:
                found = dfs(m)
                if found:
                    return found
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(graph):
        if color[n] == WHITE:
            found = dfs(n)
            if found:
                return found
    return None


@gc_register
class LockOrderCycle(ConcurrencyRule):
    """Cycle in the lock-acquisition-order graph.

    Two code paths taking the same pair of locks in opposite orders
    deadlock under the right interleaving. The graph covers lexically
    nested ``with`` blocks, intra-class ``self.method()`` calls made
    under a lock (transitive), and calls on fields whose class is known
    from a constructor in the scanned set. The runtime complement is the
    ``OrderedLock`` sanitizer (``analysis/concurrency/sanitizer.py``),
    which sees the orders the AST cannot (cross-object, cross-module).
    """

    id = "GC002"
    title = "lock-order-cycle"

    def check(self, ctx: ConcurrencyContext) -> Iterable[Diagnostic]:
        classes_by_name = {c.name: c for c in ctx.model.classes}
        edges = _lock_order_edges(ctx.model, classes_by_name)
        graph: Dict[str, Set[str]] = {}
        sites: Dict[Tuple[str, str], Tuple[int, int, str]] = {}
        for a, b, line, col, via in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
            sites.setdefault((a, b), (line, col, via))
        cycle = _find_cycle(graph)
        if cycle is None:
            return
        line, col, via = sites[(cycle[0], cycle[1])]
        yield Diagnostic(
            ctx.path, line, col, self.id,
            "lock-order cycle: " + " -> ".join(cycle) +
            f" (this edge via {via}); two threads walking opposite arcs "
            "of this cycle deadlock — pick one global order and take "
            "the locks in it everywhere")


# --- GC003 ----------------------------------------------------------------

_QUEUE_CHECKS = {"full", "empty", "qsize"}
_QUEUE_ACTS = {"put", "put_nowait", "get", "get_nowait"}
# After an event check only the PRODUCER side is a race: `if not
# stopped: q.put(...)` accepts work a concurrent shutdown never drains.
# `while not stopped: q.get(timeout=...)` is the benign consumer idiom —
# the get is atomic and an extra consumed item is the drain sweep's job.
_EVENT_GATED_ACTS = {"put", "put_nowait"}
_EVENT_CHECKS = {"is_set"}
_EVENT_ACTS = {"set", "clear"}


def _method_attr_call(expr: ast.AST, attrs: Dict[str, int],
                      names: Iterable[str]) -> Optional[Tuple[str, str]]:
    """(field, method) when ``expr`` contains ``self.<field>.<m>()`` with
    field in ``attrs`` and m in ``names``."""
    for node in ast.walk(expr):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in names):
            field = _self_attr(node.func.value)
            if field is not None and field in attrs:
                return field, node.func.attr
    return None


def _plain_attr_test(expr: ast.AST) -> Optional[str]:
    """Field X when the test is (or contains, via and/or/not) a
    None-compare or truth-test of a bare ``self.X`` (``self.X is
    None``, ``not self.X``, ``if self.X``, ``if a or self.X is not
    None``)."""
    node = expr
    while isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        node = node.operand
    if isinstance(node, ast.BoolOp):
        for value in node.values:
            attr = _plain_attr_test(value)
            if attr is not None:
                return attr
        return None
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        for cand in [node.left, *node.comparators]:
            attr = _self_attr(cand)
            if attr is not None:
                return attr
        return None
    return _self_attr(node)


@gc_register
class CheckThenAct(ConcurrencyRule):
    """Check-then-act (TOCTOU) on shared state without a lock.

    Between an unlocked check and the action it gates, another thread
    can invalidate the check: ``if not stopping.is_set(): q.put(...)``
    accepts work a concurrent shutdown will never drain (the
    submit/shutdown race); ``if self._thread is None: self._thread =
    Thread(...)`` double-starts under concurrent callers (the
    monitor-restart cousin); ``if q.full()`` followed by ``put`` sheds
    the wrong request. Make the check and the act one critical section
    (the ``full()`` admission check under ``_intake_lock`` is the
    in-tree exemplar), or use the atomic form
    (``try: put_nowait/except Full``, ``acquire(blocking=False)``).
    """

    id = "GC003"
    title = "check-then-act"

    def check(self, ctx: ConcurrencyContext) -> Iterable[Diagnostic]:
        for cls in ctx.model.classes:
            if not cls.concurrent:
                continue
            guarded = set(cls.guards) | set(cls.inferred_guards())
            for mname, fn in cls.methods.items():
                if mname == "__init__":
                    continue  # construction happens-before thread start
                yield from self._method(ctx, cls, mname, fn, guarded)

    def _method(self, ctx: ConcurrencyContext, cls: ClassModel,
                mname: str, fn: ast.AST,
                guarded: Set[str]) -> Iterable[Diagnostic]:
        held_by_line = self._held_lines(cls, mname)
        for node in ast.walk(fn):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            if held_by_line.get(node.lineno):
                continue  # the check runs under a class lock
            test = node.test
            # (a) lifecycle/lazy-init: test self.X, assign self.X later.
            attr = _plain_attr_test(test)
            if attr is not None and attr not in cls.locks \
                    and attr not in cls.events and attr not in cls.queues:
                assign = self._later_assign(fn, attr, node.lineno)
                if assign is not None:
                    yield Diagnostic(
                        ctx.path, node.lineno, node.col_offset, self.id,
                        f"`{cls.name}.{mname}` tests `self.{attr}` here "
                        f"and assigns it at line {assign} with no lock "
                        f"held — concurrent callers both pass the check "
                        f"(lazy-init/lifecycle race); guard both with "
                        f"one lock")
                continue
            # (b) queue TOCTOU: full()/empty()/qsize() then put/get.
            q = _method_attr_call(test, cls.queues, _QUEUE_CHECKS)
            if q is not None:
                act = self._later_queue_act(fn, cls, q[0], node.lineno)
                if act is not None:
                    yield Diagnostic(
                        ctx.path, node.lineno, node.col_offset, self.id,
                        f"`self.{q[0]}.{q[1]}()` checked here, then "
                        f"`{act[1]}` at line {act[0]} with no lock held "
                        f"— the queue state can change between them; "
                        f"serialize check+act under one lock (the "
                        f"admission-check pattern) or use the atomic "
                        f"try/except form")
                continue
            # (c) event TOCTOU: is_set() then a shared-state mutation.
            e = _method_attr_call(test, cls.events, _EVENT_CHECKS)
            if e is not None:
                act = self._later_mutation(fn, cls, guarded, node.lineno,
                                           held_by_line)
                if act is not None:
                    yield Diagnostic(
                        ctx.path, node.lineno, node.col_offset, self.id,
                        f"`self.{e[0]}.is_set()` checked here, then "
                        f"shared state mutated at line {act} with no "
                        f"lock held — the flag can flip between check "
                        f"and act (the submit/shutdown TOCTOU shape); "
                        f"make the check and the mutation one critical "
                        f"section")

    def _held_lines(self, cls: ClassModel, mname: str) -> Dict[int, bool]:
        """line -> "some class lock held" from the access model (an
        approximation good enough to ask 'was anything held at the
        test line')."""
        out: Dict[int, bool] = {}
        root = mname
        for acc in cls.accesses:
            if acc.method.split(".")[0] != root:
                continue
            if acc.held & set(cls.locks):
                out[acc.line] = True
        # With-blocks with no self-attr access inside still hold: derive
        # from nested_withs? The access map covers every flagged pattern
        # (the test itself reads a self attr, so its line is in the map).
        return out

    def _later_assign(self, fn: ast.AST, attr: str,
                      after_line: int) -> Optional[int]:
        for node in ast.walk(fn):
            if node is fn or getattr(node, "lineno", 0) < after_line:
                continue
            targets: Sequence[ast.AST] = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = (node.target,)
            for t in targets:
                if _self_attr(t) == attr:
                    return node.lineno
        return None

    def _later_queue_act(self, fn: ast.AST, cls: ClassModel, queue_attr: str,
                         after_line: int) -> Optional[Tuple[int, str]]:
        for node in ast.walk(fn):
            if getattr(node, "lineno", 0) < after_line:
                continue
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _QUEUE_ACTS
                    and _self_attr(node.func.value) == queue_attr):
                return node.lineno, f"self.{queue_attr}.{node.func.attr}()"
        return None

    def _later_mutation(self, fn: ast.AST, cls: ClassModel,
                        guarded: Set[str], after_line: int,
                        held_by_line: Dict[int, bool]) -> Optional[int]:
        for node in ast.walk(fn):
            line = getattr(node, "lineno", 0)
            if line < after_line or held_by_line.get(line):
                continue
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                field = _self_attr(node.func.value)
                if field in cls.queues \
                        and node.func.attr in _EVENT_GATED_ACTS:
                    return line
                if field in cls.events and node.func.attr in _EVENT_ACTS:
                    return line
            targets: Sequence[ast.AST] = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = (node.target,)
            for t in targets:
                if _self_attr(t) in guarded:
                    return line
        return None


# --- GC004 ----------------------------------------------------------------

@gc_register
class UnjoinedThread(ConcurrencyRule):
    """Non-daemon thread spawned with no ``join`` in sight.

    A non-daemon thread keeps the interpreter alive until it exits: with
    no ``join()`` anywhere in its owning class (or module, for
    module-level spawns), shutdown depends on the thread deciding to
    stop — the process hangs instead of exiting on the first missed
    sentinel. Either pass ``daemon=True`` (and provide an explicit
    drain/stop, like the batcher's ``shutdown``) or join the thread on
    the shutdown path.
    """

    id = "GC004"
    title = "unjoined-nondaemon-thread"

    def check(self, ctx: ConcurrencyContext) -> Iterable[Diagnostic]:
        for cls in ctx.model.classes:
            for spawn in cls.spawns:
                if spawn.daemon is not True and cls.joins == 0:
                    yield Diagnostic(
                        ctx.path, spawn.line, spawn.col, self.id,
                        f"`{cls.name}` spawns a non-daemon thread and "
                        f"never joins any thread — the process cannot "
                        f"exit until it stops on its own; pass "
                        f"daemon=True with an explicit drain, or join "
                        f"it on shutdown")
        for spawn in ctx.model.module_spawns:
            if spawn.daemon is not True and ctx.model.module_joins == 0:
                yield Diagnostic(
                    ctx.path, spawn.line, spawn.col, self.id,
                    "module-level non-daemon thread with no join in the "
                    "module — the process cannot exit until it stops on "
                    "its own; pass daemon=True or join it")
