"""The port's analysis engine: what its static checkers share (the
port's own copy of the rule-agnostic parts of
``pvraft_tpu/analysis/engine.py``).

A checker is a set of :class:`Rule` subclasses over one parsed module;
:func:`run_rules` parses a source, hands each rule its context and drops
the findings a pragma suppresses. The pragma grammar is the JAX
package's, one for every rule family:

    x = something()          # graftlint: disable=GC001 -- reason
    # graftlint: disable-next=GD002 -- reason
    # graftlint: disable-file=GD005 -- reason

``disable=...`` silences the named rules on that source line,
``disable-next=...`` (a comment on its own line) on the line below it,
``disable-file=...`` in the whole file. Text after ``--`` is the reason;
a pragma without one still suppresses but counts as reason-less
(:func:`collect_suppressions`).

Only stdlib ``ast``/``re``/``tokenize`` here.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Callable, Iterable, Iterator, List, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: ``path:line:col: rule_id message``."""

    path: str
    line: int
    col: int
    rule_id: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule_id} {self.message}"


def dotted_name(node: ast.AST) -> str:
    """'os.path.join'-style spelling of a Name/Attribute chain ('' when
    the chain bottoms out in a call or subscript)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class LintContext:
    """Per-file state handed to every rule."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        # Absolute, forward-slash path, so that rules scoping by package
        # file behave the same for a directory, a relative path or a bare
        # filename.
        if path == "<string>":
            self.norm_path = path
        else:
            self.norm_path = os.path.abspath(path).replace(os.sep, "/")

    def diag(self, node: ast.AST, rule_id: str, message: str) -> Diagnostic:
        """A finding anchored at ``node``'s line and column."""
        return Diagnostic(self.path, getattr(node, "lineno", 1),
                          getattr(node, "col_offset", 0), rule_id, message)


class Rule:
    """Base class: subclasses set ``id``/``title`` and implement ``check``.

    ``id`` is the stable suppression key (``GCxxx``, ``GDxxx``,
    ``GSxxx``, ``GLxxx``); ``title`` a short slug; the class docstring is
    the explanation ``--list-rules`` prints."""

    id: str = ""
    title: str = ""

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        raise NotImplementedError


# --- suppression comments -------------------------------------------------

# One pragma grammar, shared by the suppression engine and the debt
# report: what is honoured is what is counted. Trailing text without the
# `-- ` marker still suppresses but does not count as a reason.
_PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*disable(?P<kind>-next|-file)?="
    r"(?P<ids>[A-Za-z0-9_,]+)(?P<tail>[^\n]*)"
)
_REASON_RE = re.compile(r"^\s*--\s*(?P<reason>\S.*?)\s*$")


def _parse_pragma(text: str):
    """``(kind, ids, reason)`` of the suppression pragma in a comment,
    or None. kind is "line" | "next" | "file"; reason is "" when the
    pragma gives none."""
    m = _PRAGMA_RE.search(text)
    if not m:
        return None
    kind = {None: "line", "-next": "next", "-file": "file"}[m.group("kind")]
    ids = tuple(i for i in m.group("ids").split(",") if i)
    rm = _REASON_RE.match(m.group("tail") or "")
    return kind, ids, rm.group("reason") if rm else ""


def _comment_tokens(source: str) -> List[Tuple[int, str]]:
    """(lineno, text) of real comment tokens: a pragma shown inside a
    docstring or string literal never disables anything."""
    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # the comments before the fault were still yielded
    return out


def _suppressions(source: str):
    """(per-line {lineno: ids}, file-level ids) from suppression comments."""
    per_line: dict = {}
    file_ids: set = set()
    for i, text in _comment_tokens(source):
        parsed = _parse_pragma(text)
        if parsed is None:
            continue
        kind, ids, _reason = parsed
        if kind == "file":
            file_ids.update(ids)
        elif kind == "next":
            per_line.setdefault(i + 1, set()).update(ids)
        else:
            per_line.setdefault(i, set()).update(ids)
    return per_line, file_ids


def _suppressed(d: Diagnostic, per_line, file_ids) -> bool:
    if "all" in file_ids or d.rule_id in file_ids:
        return True
    ids = per_line.get(d.line, ())
    return "all" in ids or d.rule_id in ids


def _expand_decorated_regions(tree: ast.Module, per_line: dict) -> None:
    """A finding on a decorated def anchors at the ``def`` line, while a
    ``disable-next`` above the decorator targets the decorator's line:
    treat the whole header (first decorator through the signature) as
    one region, where a pragma on any line covers all of it."""
    for node in ast.walk(tree):
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        if not node.decorator_list:
            continue
        start = min(d.lineno for d in node.decorator_list)
        end = node.body[0].lineno - 1 if node.body else node.lineno
        end = max(end, node.lineno)
        ids: set = set()
        for line in range(start, end + 1):
            ids |= set(per_line.get(line, ()))
        if ids:
            for line in range(start, end + 1):
                per_line.setdefault(line, set()).update(ids)


# --- the entry points ------------------------------------------------------

def run_rules(source: str, path: str, rules: Sequence[type],
              make_context: Callable[[str, str, ast.Module], LintContext],
              syntax_id: str,
              rule_ids: Sequence[str] = ()) -> List[Diagnostic]:
    """Parse ``source``, run ``rules`` (those of ``rule_ids`` when given)
    over ``make_context(path, source, tree)`` and return the findings no
    pragma suppresses, in a stable order. A syntax error is one
    ``syntax_id`` finding."""
    source = source.lstrip("\ufeff")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Diagnostic(path, e.lineno or 1, e.offset or 0, syntax_id,
                           f"syntax error: {e.msg}")]
    ctx = make_context(path, source, tree)
    per_line, file_ids = _suppressions(source)
    _expand_decorated_regions(tree, per_line)
    out: List[Diagnostic] = []
    for rule_cls in rules:
        if rule_ids and rule_cls.id not in rule_ids:
            continue
        for d in rule_cls().check(ctx):
            if not _suppressed(d, per_line, file_ids):
                out.append(d)
    out.sort(key=lambda d: (d.path, d.line, d.col, d.rule_id))
    return out


def iter_py_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".pytest_cache")
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        else:
            raise FileNotFoundError(p)


def check_files(paths: Sequence[str],
                check_source: Callable[[str, str], List[Diagnostic]]
                ) -> Tuple[List[Diagnostic], int]:
    """``check_source(source, path)`` over every file under ``paths``.
    Returns (diagnostics, files_checked)."""
    out: List[Diagnostic] = []
    n = 0
    for f in iter_py_files(paths):
        n += 1
        # utf-8-sig drops a BOM; text mode gives universal newlines.
        with open(f, "r", encoding="utf-8-sig") as fh:
            out.extend(check_source(fh.read(), f))
    out.sort(key=lambda d: (d.path, d.line, d.col, d.rule_id))
    return out, n


# --- the suppression-debt report ------------------------------------------

@dataclasses.dataclass(frozen=True)
class Pragma:
    """One active suppression comment found in a source file."""

    path: str
    line: int
    kind: str           # "line" | "next" | "file"
    ids: Tuple[str, ...]
    reason: str         # "" when the pragma gives none


def collect_suppressions(paths: Sequence[str]) -> List[Pragma]:
    """Every active suppression pragma under ``paths`` (real comment
    tokens only, as the suppression engine reads them)."""
    out: List[Pragma] = []
    for f in iter_py_files(paths):
        with open(f, "r", encoding="utf-8-sig") as fh:
            source = fh.read()
        for lineno, text in _comment_tokens(source):
            parsed = _parse_pragma(text)
            if parsed is None:
                continue
            kind, ids, reason = parsed
            out.append(Pragma(path=f, line=lineno, kind=kind, ids=ids,
                              reason=reason))
    out.sort(key=lambda p: (p.path, p.line))
    return out


def known_rule_ids() -> Set[str]:
    """Ids of every rule of the port's checkers, threading (GC),
    determinism (GD), sharding (GS) and graftlint (GL), with each
    family's syntax-error id: one namespace for the shared pragma
    grammar."""
    from pvraft_tpu_torch.analysis.concurrency.rules import (
        all_concurrency_rules,
    )
    from pvraft_tpu_torch.analysis.determinism.rules import (
        all_determinism_rules,
    )
    from pvraft_tpu_torch.analysis.rules import all_lint_rules
    from pvraft_tpu_torch.analysis.sharding.rules import all_sharding_rules

    ids = {r.id for r in all_concurrency_rules()}
    ids |= {r.id for r in all_determinism_rules()}
    ids |= {r.id for r in all_sharding_rules()}
    ids |= {r.id for r in all_lint_rules()}
    return ids | {"GC000", "GD000", "GS000", "GL000"}
