"""threadcheck of the port, its entry points: files -> model -> GC rules ->
diagnostics (the port's own copy of
``pvraft_tpu/analysis/concurrency/check.py``).

Scope defaults to the port's hand-threaded planes: ``serve/``,
``fleet/``, ``obs/`` and ``data/loader.py`` (``DEFAULT_SCOPE``),
resolved relative to the installed package so that ``python -m
pvraft_tpu_torch.analysis concurrency`` works from any directory.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

from pvraft_tpu_torch.analysis.engine import (
    Diagnostic,
    check_files,
    run_rules,
)
from pvraft_tpu_torch.analysis.concurrency.model import build_module_model
from pvraft_tpu_torch.analysis.concurrency.rules import (
    ConcurrencyContext,
    all_concurrency_rules,
)

# The scope relative to the repository root (docs and tests);
# default_scope() resolves it in this checkout.
DEFAULT_SCOPE = ("pvraft_tpu_torch/serve", "pvraft_tpu_torch/fleet",
                 "pvraft_tpu_torch/obs", "pvraft_tpu_torch/data/loader.py")


def default_scope() -> Tuple[str, ...]:
    """``DEFAULT_SCOPE`` as absolute paths of this checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return tuple(os.path.join(root, *p.split("/")) for p in DEFAULT_SCOPE)


def _context(path, source, tree) -> ConcurrencyContext:
    return ConcurrencyContext(path, source, tree,
                              build_module_model(tree, source, path))


def check_source(source: str, path: str = "<string>",
                 rule_ids: Sequence[str] = ()) -> List[Diagnostic]:
    """Run the GC rules over one source string (suppressions applied)."""
    return run_rules(source, path, all_concurrency_rules(), _context,
                     "GC000", rule_ids)


def check_paths(paths: Sequence[str], rule_ids: Sequence[str] = ()
                ) -> Tuple[List[Diagnostic], int]:
    """Check files/directories. Returns (diagnostics, files_checked)."""
    return check_files(
        paths, lambda source, path: check_source(source, path, rule_ids))
