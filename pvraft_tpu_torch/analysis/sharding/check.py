"""shardcheck of the port, its entry points: files -> shard models ->
GS rules -> diagnostics (the port's own copy of
``pvraft_tpu/analysis/sharding/check.py``, GS004 alone).

Scope defaults to the port's every-rank planes, ``engine/``, ``obs/``
and ``parallel/`` (``DEFAULT_SCOPE``), resolved relative to the
installed package so that ``python -m pvraft_tpu_torch.analysis
sharding`` works from any directory. Pure stdlib ``ast``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

from pvraft_tpu_torch.analysis.engine import (
    Diagnostic,
    check_files,
    run_rules,
)
from pvraft_tpu_torch.analysis.sharding.model import build_module_shard_model
from pvraft_tpu_torch.analysis.sharding.rules import (
    ShardContext,
    all_sharding_rules,
)

# The scope relative to the repository root (docs and tests);
# default_scope() resolves it in this checkout.
DEFAULT_SCOPE = ("pvraft_tpu_torch/engine", "pvraft_tpu_torch/obs",
                 "pvraft_tpu_torch/parallel")


def default_scope() -> Tuple[str, ...]:
    """``DEFAULT_SCOPE`` as absolute paths of this checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return tuple(os.path.join(root, *p.split("/")) for p in DEFAULT_SCOPE)


def _context(path, source, tree) -> ShardContext:
    return ShardContext(path, source, tree, build_module_shard_model(tree))


def check_source(source: str, path: str = "<string>",
                 rule_ids: Sequence[str] = ()) -> List[Diagnostic]:
    """Run the GS rules over one source string (suppressions applied)."""
    return run_rules(source, path, all_sharding_rules(), _context,
                     "GS000", rule_ids)


def check_paths(paths: Sequence[str], rule_ids: Sequence[str] = ()
                ) -> Tuple[List[Diagnostic], int]:
    """Check files/directories. Returns (diagnostics, files_checked)."""
    return check_files(
        paths, lambda source, path: check_source(source, path, rule_ids))
