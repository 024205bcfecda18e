"""Parameter partitioning rules (the port's copy of
``pvraft_tpu/programs/partitioning.py``'s rules and matching).

A rule is ``(regex, spec)``: ``re.search`` over a leaf's ``/``-joined
flax path (``params/feature_extractor/conv1/fc1/kernel``), ``spec`` a
tuple of mesh axis names (or None) per dimension; ``()`` replicates.
Every leaf must match exactly one rule: a leaf no rule names, or one two
rules fight over, raises. Every leaf replicates (the model is ~0.8 MB):
data parallelism replicates the parameters, and sequence parallelism
shards the points of each scene, never a parameter. The Trainer holds
every leaf's spec to ``()`` (:func:`check_replicated`), and a leaf that
would shard raises: the port's Trainer places no parameter shard.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]

# The mesh axes a spec may name (parallel/mesh.py's (data, seq)).
MESH_AXES = ("data", "seq")

# Batch arrays (B, N, ...): batch over data, points over seq.
BATCH_PARTITION = ("data", "seq")

# The exactly-once ladder over PVRaft's 95 leaves: the three anchored
# prefixes partition the module tree.
PARTITION_RULES: Tuple[Tuple[str, Spec], ...] = (
    # The twin SetConv encoders (feature + context): replicate.
    (r"^params/(feature|context)_extractor/", ()),
    # The correlation lookup's head (voxel + knn branches): replicate.
    (r"^params/update_iter/corr_lookup/", ()),
    # MotionEncoder + ConvGRU + FlowHead: replicate.
    (r"^params/update_iter/update_block/", ()),
)


def match_report(rules: Rules, leaf_paths: Sequence[str]
                 ) -> Tuple[Dict[str, Spec], List[str],
                            List[Tuple[str, List[str]]], List[str]]:
    """``(mapping, unmatched, multi, unused)``: leaf path -> spec for the
    leaves one rule matches, the leaves none matches, the leaves several
    match (with their regexes), and the rules that match no leaf."""
    compiled = [(pat, re.compile(pat), spec) for pat, spec in rules]
    mapping: Dict[str, Spec] = {}
    unmatched: List[str] = []
    multi: List[Tuple[str, List[str]]] = []
    used = set()
    for path in leaf_paths:
        hits = [(pat, spec) for pat, rx, spec in compiled if rx.search(path)]
        used.update(pat for pat, _ in hits)
        if not hits:
            unmatched.append(path)
        elif len(hits) > 1:
            multi.append((path, [pat for pat, _ in hits]))
        else:
            mapping[path] = hits[0][1]
    unused = [pat for pat, _, _ in compiled if pat not in used]
    return mapping, unmatched, multi, unused


def match_partition_rules(rules: Rules, leaf_paths: Sequence[str]
                          ) -> Dict[str, Spec]:
    """Leaf path -> spec, or raise on any leaf that matches no rule or
    more than one."""
    mapping, unmatched, multi, _unused = match_report(rules, leaf_paths)
    problems = [f"no partition rule matches leaf {path!r}"
                for path in unmatched]
    problems += [f"leaf {path!r} matched {len(pats)} rules ({pats}); rules "
                 f"must be disjoint (exactly-once discipline)"
                 for path, pats in multi]
    if problems:
        raise ValueError("partition-rule coverage: " + "; ".join(problems))
    return mapping


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
                "int8": 1, "uint8": 1, "bool": 1, "float64": 8}


def leaf_bytes(leaf: Mapping[str, Any]) -> int:
    """Bytes of one leaf record (``{"path", "shape", "dtype"}``)."""
    return (math.prod(leaf["shape"])
            * _DTYPE_BYTES.get(leaf.get("dtype", "float32"), 4))


def shard_factor(spec: Sequence[Optional[str]],
                 mesh_shape: Mapping[str, int]) -> int:
    """How many ways a leaf with ``spec`` splits on a mesh: the product
    of the named axes' sizes (``()`` or all-None: 1, replicated)."""
    factor = 1
    for axis in spec:
        if axis is not None:
            factor *= int(mesh_shape.get(axis, 1))
    return factor


def flax_leaf_paths(state: Mapping[str, torch.Tensor]) -> List[str]:
    """A state_dict's leaves under their flax paths (``weights.
    params_to_jax``'s names, ``params/...``), sorted."""
    from pvraft_tpu_torch.weights import params_to_jax

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}"
            if isinstance(value, Mapping):
                yield from walk(value, path)
            else:
                yield path

    return sorted(walk(params_to_jax(state)["params"], "params"))


def check_replicated(model: torch.nn.Module,
                     rules: Rules = PARTITION_RULES) -> Dict[str, Spec]:
    """The specs of ``model``'s leaves under ``rules``, by flax path,
    every one ``()``; a leaf the rules would shard raises: data and
    sequence parallelism replicate every parameter."""
    specs = match_partition_rules(rules, flax_leaf_paths(model.state_dict()))
    sharded = {p: s for p, s in specs.items() if any(a is not None for a in s)}
    if sharded:
        raise NotImplementedError(
            f"{len(sharded)} parameter leaves would shard "
            f"({sorted(sharded)[:3]} ...): the port's Trainer replicates "
            f"every parameter over the data and seq axes and places no "
            f"parameter shard")
    return specs
