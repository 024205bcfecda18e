"""graftlint rules GL006 and GL007 of the port: the JAX package's two
plain-Python rules (the port's own copy of ``MutableDefaultArg`` and
``FStringDebugPrint`` in ``pvraft_tpu/analysis/rules.py``, with their
ids, titles, messages, anchors and docstrings).

Each rule's class docstring is its user-facing documentation (printed by
``python -m pvraft_tpu_torch.analysis lint --list-rules``). Suppress any
rule on a line with ``# graftlint: disable=GLxxx -- reason`` (the shared
pragma grammar of ``analysis/engine.py``).

GL007 keeps JAX's matcher as it is: the port never calls
``jax.debug.print``, and the rule is here so that the two checkers agree
on one corpus. The JAX package's other graftlint rules (GL001-GL005,
GL008, GL009) read ``jax.jit`` scopes and JAX imports and keep their
recorded dispositions (``ROADMAP.md``).
"""

from __future__ import annotations

import ast
from typing import Iterable, Tuple, Type

from pvraft_tpu_torch.analysis.engine import (
    Diagnostic,
    LintContext,
    Rule,
    dotted_name,
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


# --- GL006 ----------------------------------------------------------------

class MutableDefaultArg(Rule):
    """Mutable default argument.

    A ``[]``/``{}``/``set()`` default is created once at def time and
    shared across calls — in a codebase full of cached/jitted function
    factories this turns into cross-call state that survives retraces.
    Default to ``None`` and create inside.
    """

    id = "GL006"
    title = "mutable-default-arg"

    def _is_mutable(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set)):
            return True
        return (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("list", "dict", "set")
            and not node.args
            and not node.keywords
        )

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, _FUNC_NODES + (ast.Lambda,)):
                continue
            for default in list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None
            ]:
                if self._is_mutable(default):
                    name = getattr(fn, "name", "<lambda>")
                    yield ctx.diag(
                        default, self.id,
                        f"mutable default argument in `{name}` is shared "
                        "across calls; use None and create inside",
                    )


# --- GL007 ----------------------------------------------------------------

class FStringDebugPrint(Rule):
    """f-string passed to ``jax.debug.print``.

    An f-string formats at TRACE time: the printed text shows
    ``Traced<ShapedArray...>`` instead of runtime values (and bakes one
    formatting into the program). ``jax.debug.print`` takes a format
    string with ``{}`` placeholders filled at run time:
    ``jax.debug.print("loss={l}", l=loss)``.
    """

    id = "GL007"
    title = "fstring-debug-print"

    def check(self, ctx: LintContext) -> Iterable[Diagnostic]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if not dotted.endswith("debug.print"):
                continue
            if node.args and isinstance(node.args[0], ast.JoinedStr):
                yield ctx.diag(
                    node, self.id,
                    "f-string formats tracers at trace time; pass a "
                    'format string: jax.debug.print("x={x}", x=x)',
                )


def all_lint_rules() -> Tuple[Type[Rule], ...]:
    return (MutableDefaultArg, FStringDebugPrint)
