"""detcheck of the port, its entry points: files -> det models -> GD rules ->
diagnostics (the port's own copy of
``pvraft_tpu/analysis/determinism/check.py``).

Scope is the whole package: entropy leaks anywhere, so detcheck walks
``pvraft_tpu_torch/`` end to end (``rng.py`` and ``device.py`` are
per-rule exemptions as the owners, not holes in the scan).

The declared context comes from the port's own declarations: the stream
vocabulary is parsed from ``pvraft_tpu_torch/rng.py``'s ``STREAMS`` (by
AST, no import), and the GD003 hazard set from the program registry.
Each spec's thunk source gives its package imports (the thunk is read,
never run), the package's import graph closes them, and any spec whose
closure reaches a module with a hazard op must carry a ``determinism=``
stance.
"""

from __future__ import annotations

import ast
import inspect
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from pvraft_tpu_torch.analysis.engine import (
    Diagnostic,
    check_files,
    run_rules,
)
from pvraft_tpu_torch.analysis.determinism.model import build_module_det_model
from pvraft_tpu_torch.analysis.determinism.rules import (
    DetContext,
    HazardSpec,
    all_determinism_rules,
)

_PKG = "pvraft_tpu_torch"

# The scope relative to the repository root (docs and tests).
DEFAULT_SCOPE = (_PKG,)


def _pkg_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_scope() -> Tuple[str, ...]:
    """The scan scope, as absolute paths of this checkout."""
    return (_pkg_root(),)


def declared_streams() -> Optional[Tuple[str, ...]]:
    """The stream vocabulary: first elements of the ``STREAMS`` tuple at
    module level of ``pvraft_tpu_torch/rng.py``, parsed from the AST so
    that the checker cannot drift from the runtime contract. None when
    unreadable: GD002 then reports the gap."""
    path = os.path.join(_pkg_root(), "rng.py")
    try:
        with open(path, "r", encoding="utf-8-sig") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == "STREAMS"
                   for t in targets):
            continue
        value = node.value
        if not isinstance(value, (ast.Tuple, ast.List)):
            return None
        names: List[str] = []
        for entry in value.elts:
            if isinstance(entry, (ast.Tuple, ast.List)) and entry.elts \
                    and isinstance(entry.elts[0], ast.Constant) \
                    and isinstance(entry.elts[0].value, str):
                names.append(entry.elts[0].value)
        return tuple(names)
    return None


# --- the GD003 registry inspection -----------------------------------------

_PKG_IMPORT_RE = re.compile(r"(?:from|import)\s+(pvraft_tpu_torch(?:\.\w+)*)")


def _module_files() -> Dict[str, str]:
    """Dotted module name -> absolute path, for every module of the
    package (``analysis/`` left out: the checker's own sources name
    hazard ops as data, not as programs)."""
    root = _pkg_root()
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames
            if d != "__pycache__"
            and not (dirpath == root and d == "analysis"))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, os.path.dirname(root))
            dotted = rel[:-3].replace(os.sep, ".")
            if dotted.endswith(".__init__"):
                dotted = dotted[: -len(".__init__")]
            out[dotted] = full
    return out


def _package_imports(tree: ast.AST, files: Dict[str, str]) -> Set[str]:
    """The package modules any import statement in ``tree`` names (lazy
    function-level imports included: a config-gated path is still
    reachable code)."""
    mods: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names
                        if a.name.split(".")[0] == _PKG)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == _PKG:
            mods.add(node.module)
            # `from pvraft_tpu_torch.ops import cuda` names a submodule;
            # symbol imports just miss the lookup.
            mods.update(f"{node.module}.{a.name}" for a in node.names
                        if f"{node.module}.{a.name}" in files)
    return {m for m in mods if m in files}


def _module_graph(files: Dict[str, str]
                  ) -> Tuple[Dict[str, Set[str]], Dict[str, List[str]]]:
    """(imports, hazards): per module, the package modules it imports,
    and the hazard-op kinds its AST contains."""
    imports: Dict[str, Set[str]] = {}
    hazards: Dict[str, List[str]] = {}
    for dotted, path in files.items():
        try:
            with open(path, "r", encoding="utf-8-sig") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            imports[dotted] = set()
            continue
        imports[dotted] = _package_imports(tree, files)
        kinds = sorted({h.kind for h in build_module_det_model(tree)
                        .hazard_ops})
        if kinds:
            hazards[dotted] = kinds
    return imports, hazards


def _thunk_roots(spec, module_tree: Optional[ast.Module],
                 files: Dict[str, str]) -> Set[str]:
    """Package modules the spec's thunk source imports, plus those of
    the same-module functions it references by name (the catalog's
    ``_model``-style helpers), to a fixpoint."""
    try:
        source = inspect.getsource(spec.thunk)
    except (OSError, TypeError):
        return set()
    helper_imports: Dict[str, Set[str]] = {}
    helper_names: Dict[str, Set[str]] = {}
    if module_tree is not None:
        for node in module_tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                helper_names[node.name] = {
                    n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
                helper_imports[node.name] = _package_imports(node, files)

    roots = set(_PKG_IMPORT_RE.findall(source))
    pulled: Set[str] = set()
    frontier = [source]
    while frontier:
        text = frontier.pop()
        for name, mods in helper_imports.items():
            if name in pulled:
                continue
            if re.search(rf"\b{re.escape(name)}\b", text):
                pulled.add(name)
                roots.update(mods)
                frontier.append(" ".join(sorted(helper_names[name])))
    return {r for r in roots if r in files}


def hazard_spec_records() -> List[HazardSpec]:
    """Every registered ProgramSpec whose static import closure reaches
    a nondeterminism-hazard op, with its declared stance. Registering
    the catalog builds nothing (thunks stay lazy); the rest is AST over
    the package's sources."""
    from pvraft_tpu_torch.programs import load_catalog
    from pvraft_tpu_torch.programs.spec import specs

    load_catalog()
    files = _module_files()
    imports, hazards = _module_graph(files)

    reach_memo: Dict[str, Set[str]] = {}

    def reach(mod: str) -> Set[str]:
        """Hazard modules in ``mod``'s import closure (a whole walk per
        root: the graph has cycles, so partial results are not kept)."""
        if mod not in reach_memo:
            seen, stack = {mod}, [mod]
            while stack:
                for dep in imports.get(stack.pop(), ()):
                    if dep not in seen:
                        seen.add(dep)
                        stack.append(dep)
            reach_memo[mod] = {m for m in seen if m in hazards}
        return reach_memo[mod]

    trees: Dict[str, Optional[ast.Module]] = {}

    def tree_of(path: str) -> Optional[ast.Module]:
        if path not in trees:
            try:
                with open(path, "r", encoding="utf-8-sig") as f:
                    trees[path] = ast.parse(f.read(), filename=path)
            except (OSError, SyntaxError):
                trees[path] = None
        return trees[path]

    records: List[HazardSpec] = []
    for spec in specs().values():
        roots = _thunk_roots(spec, tree_of(spec.path) if spec.path else None,
                             files)
        hit: Dict[str, List[str]] = {}
        for r in sorted(roots):
            for hmod in sorted(reach(r)):
                hit.setdefault(hmod, hazards[hmod])
        if not hit:
            continue
        kinds = sorted({k for ks in hit.values() for k in ks})
        records.append(HazardSpec(
            name=spec.name, determinism=spec.determinism,
            path=spec.path.replace("\\", "/"), line=spec.line,
            via=sorted(hit)[0].replace(".", "/") + ".py",
            kinds=tuple(kinds)))
    records.sort(key=lambda r: (r.path, r.line, r.name))
    return records


# --- the entry points ------------------------------------------------------

def check_source(source: str, path: str = "<string>",
                 rule_ids: Sequence[str] = (),
                 streams: Optional[Sequence[str]] = None,
                 hazard_specs: Optional[Sequence[HazardSpec]] = None,
                 ) -> List[Diagnostic]:
    """Run the GD rules over one source string (suppressions applied)."""
    def context(path, source, tree):
        return DetContext(path, source, tree, build_module_det_model(tree),
                          declared_streams=streams, hazard_specs=hazard_specs)

    return run_rules(source, path, all_determinism_rules(), context,
                     "GD000", rule_ids)


def check_paths(paths: Sequence[str], rule_ids: Sequence[str] = (),
                streams: Optional[Sequence[str]] = None,
                hazard_specs: Optional[Sequence[HazardSpec]] = None,
                ) -> Tuple[List[Diagnostic], int]:
    """Check files/directories. Returns (findings, files_checked).

    ``streams``/``hazard_specs`` default to the live declarations
    (rng.py's STREAMS, the registry's hazard closure), so that the
    clean-tree check always arms GD002/GD003 with real data."""
    if streams is None:
        streams = declared_streams()
    if hazard_specs is None:
        hazard_specs = hazard_spec_records()
    return check_files(paths, lambda source, path: check_source(
        source, path, rule_ids, streams, hazard_specs))
