"""graftlint of the port, its entry points: files -> GL rules ->
diagnostics (the port's own copy of ``lint_source``/``lint_paths`` in
``pvraft_tpu/analysis/engine.py``, over GL006 and GL007).

Scope defaults to the port's own Python: the ``pvraft_tpu_torch``
package, ``chip_smoke.py`` and the port's tests, ``tests/test_torch_*.py``
(``DEFAULT_SCOPE``), resolved relative to the installed package so that
``python -m pvraft_tpu_torch.analysis lint`` works from any directory.
The JAX package's ``lint`` requires paths. Pure stdlib ``ast``.
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence, Tuple

from pvraft_tpu_torch.analysis.engine import (
    Diagnostic,
    LintContext,
    check_files,
    run_rules,
)
from pvraft_tpu_torch.analysis.rules import all_lint_rules

# The scope relative to the repository root (docs and tests);
# default_scope() resolves it in this checkout.
DEFAULT_SCOPE = ("pvraft_tpu_torch", "chip_smoke.py", "tests/test_torch_*.py")


def default_scope() -> Tuple[str, ...]:
    """``DEFAULT_SCOPE`` as absolute paths of this checkout, the tests'
    pattern expanded in sorted order (entries absent from the checkout,
    as the tests in an installed copy, are left out)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out: List[str] = []
    for p in DEFAULT_SCOPE:
        out.extend(sorted(glob.glob(os.path.join(root, *p.split("/")))))
    return tuple(out)


def lint_source(source: str, path: str = "<string>",
                rule_ids: Sequence[str] = ()) -> List[Diagnostic]:
    """Lint one source string (suppressions applied). ``rule_ids``
    restricts to those rules."""
    return run_rules(source, path, all_lint_rules(), LintContext, "GL000",
                     rule_ids)


def lint_paths(paths: Sequence[str], rule_ids: Sequence[str] = ()
               ) -> Tuple[List[Diagnostic], int]:
    """Lint files/directories. Returns (diagnostics, files_checked)."""
    return check_files(
        paths, lambda source, path: lint_source(source, path, rule_ids))
