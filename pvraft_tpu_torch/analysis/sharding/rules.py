"""shardcheck rule GS004 of the port: a filesystem write that no
process-0 test dominates (the port's own copy of GS004 in
``pvraft_tpu/analysis/sharding/rules.py``, with its id, title and
message; ``process_index()`` is ``parallel/distributed.py``'s).

``engine/``, ``obs/`` and ``parallel/`` run on every rank of a
``torchrun`` group, so a write there runs once per rank unless a rank-0
test guards it. Suppress with ``# graftlint: disable=GS004 -- reason``
(the shared pragma grammar).

Path scoping: inside the package the rule applies to its scope only;
outside it (fixtures, inline test sources) it applies unconditionally,
so red and green corpora stay honest.

The JAX package's other shardcheck rules keep their recorded
dispositions (``ROADMAP.md``): GS001-GS003 read JAX shardings, jaxpr
idioms and ``lax`` spellings; GS005 names JAX placement calls and a
contract the port keeps in one function.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple, Type

from pvraft_tpu_torch.analysis.engine import Diagnostic, LintContext, Rule
from pvraft_tpu_torch.analysis.sharding.model import (
    ModuleShardModel,
    build_module_shard_model,
)

_PKG = "pvraft_tpu_torch/"


class ShardContext(LintContext):
    """LintContext + the extracted shard model."""

    def __init__(self, path: str, source: str, tree: ast.Module,
                 model: Optional[ModuleShardModel] = None):
        super().__init__(path, source, tree)
        self.model = model if model is not None \
            else build_module_shard_model(tree)

    def package_suffix(self) -> Optional[str]:
        """'pvraft_tpu_torch/...' relative suffix, or None for sources
        outside the package (those see every rule)."""
        if _PKG in self.norm_path:
            return _PKG + self.norm_path.rsplit("/" + _PKG, 1)[-1]
        return None

    def diag_at(self, line: int, col: int, rule_id: str,
                message: str) -> Diagnostic:
        return Diagnostic(self.path, line, col, rule_id, message)


class ShardRule(Rule):
    def check(self, ctx: ShardContext) -> Iterable[Diagnostic]:
        raise NotImplementedError


_GS_REGISTRY: List[Type[ShardRule]] = []


def gs_register(cls: Type[ShardRule]) -> Type[ShardRule]:
    if not cls.id or not cls.title:
        raise ValueError(f"rule {cls.__name__} must set id and title")
    if any(r.id == cls.id for r in _GS_REGISTRY):
        raise ValueError(f"duplicate rule id {cls.id}")
    _GS_REGISTRY.append(cls)
    return cls


def all_sharding_rules() -> Tuple[Type[ShardRule], ...]:
    return tuple(sorted(_GS_REGISTRY, key=lambda r: r.id))


def _in_scope(ctx: ShardContext, prefixes: Tuple[str, ...]) -> bool:
    suffix = ctx.package_suffix()
    if suffix is None:
        return True
    return any(suffix.startswith(p) for p in prefixes)


# --- GS004 ----------------------------------------------------------------

@gs_register
class UnguardedProcessZeroIO(ShardRule):
    """Filesystem write reachable without a process-0 dominator.

    ``engine/``, ``obs/`` and ``parallel/`` run on every rank of a
    process group; a write no ``process_index() == 0`` test dominates
    runs once per rank — concurrent truncations, interleaved JSONL,
    corrupt checkpoints. Recognized guard shapes: lexical rank-0 ``if``
    bodies (``process_index() == 0``, ``self.mesh.process_index == 0``),
    terminating guard clauses (``if process_index() != 0: return``),
    process-0 locals and flag fields (``lead = process_index() == 0``,
    the ``EventLog.enabled`` pattern), single-process proofs (``if
    process_count() > 1: raise``), and module-local helpers whose every
    call site is guarded (the ``checkpoint.py`` ``_write`` shape).
    ``os.makedirs(..., exist_ok=True)`` is exempt (idempotent ensure).
    """

    id = "GS004"
    title = "unguarded-process0-io"

    _SCOPE = ("pvraft_tpu_torch/engine/", "pvraft_tpu_torch/obs/",
              "pvraft_tpu_torch/parallel/")

    def check(self, ctx: ShardContext) -> Iterable[Diagnostic]:
        if not _in_scope(ctx, self._SCOPE):
            return
        for site in ctx.model.write_sites:
            if site.guarded:
                continue
            where = (f"{site.owner}.{site.func}" if site.owner
                     else site.func or "<module>")
            yield ctx.diag_at(
                site.line, site.col, self.id,
                f"{site.call}(...) in {where} is reachable without a "
                f"dominating process_index() == 0 test — on a "
                f"multi-process mesh every host runs it; guard the "
                f"write (early return, rank-0 if, or a process-0 flag "
                f"field)")
