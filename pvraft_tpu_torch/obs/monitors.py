"""In-step numerics monitors (port of ``pvraft_tpu/obs/monitors.py``).

The instrument behind ``TrainConfig.telemetry``: tensor functions of a
train step's intermediates (the parameters before the update, the
gradients, the update, the per-iteration flows, the loss) that give the
step's ``metrics["telemetry"]`` leaves. Everything stays on the device:
no ``.item()``, no host sync, no branch on a value, so a captured step
(``engine/steps.py``) holds them as static outputs of its graph. The
norms over many tensors are one multi-tensor reduction
(``torch._foreach_norm``) and the non-finite count one pass over the
concatenated tensors, not one reduction a leaf.

The leaves (:data:`TELEMETRY_LEAVES`) and what they show:

* ``grad_norm``, ``param_norm``, ``update_ratio``: the learning-rate
  health triple; an update/parameter ratio drifting above ~1e-2 shows a
  learning-rate spike before the loss moves;
* ``grad_norm_by_group``: the gradient's l2 norm per top-level group of
  parameters, the first component of the parameter's name
  (``feature_extractor``, ``context_extractor``, ``update_iter``; of a
  PVRaftRefine ``backbone``, ``ref_conv1`` ... ``fc``), which are the
  JAX model's top-level flax children; a parameter without a gradient
  (the refine model's frozen backbone) counts as zeros, as JAX's
  ``stop_gradient`` gradients do;
* ``delta_flow_norm``: the RMS norm of each GRU iteration's flow update,
  shape ``(T,)``; healthy runs contract;
* ``nonfinite``: the count of non-finite elements in the loss, the
  gradients and the flows (int32), which the divergence detector trips
  on.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, \
    Tuple

import torch

TELEMETRY_LEAVES = (
    "grad_norm", "param_norm", "update_ratio", "grad_norm_by_group",
    "delta_flow_norm", "nonfinite",
)

_EPS = 1e-12


def _leaves(trees: Iterable[Any]) -> List[torch.Tensor]:
    """The tensors of tensors, mappings, lists and tuples (None skipped)."""
    out: List[torch.Tensor] = []
    for tree in trees:
        if tree is None:
            continue
        if torch.is_tensor(tree):
            out.append(tree)
        elif isinstance(tree, Mapping):
            out += _leaves(tree.values())
        else:
            out += _leaves(tree)
    return out


def _norms(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's l2 norm in float32, in one multi-tensor kernel."""
    if not tensors:
        return []
    return list(torch._foreach_norm([t.detach().float() for t in tensors]))


def _root_sum_sq(norms: Sequence[torch.Tensor],
                 like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt of the sum of squares of 0-d norms (0 for none)."""
    if not norms:
        return torch.zeros((), dtype=torch.float32,
                           device=None if like is None else like.device)
    return torch.linalg.vector_norm(torch.stack(list(norms)))


def global_norm(tree: Any) -> torch.Tensor:
    """The l2 norm over every tensor of ``tree``, accumulated in float32
    (bf16 leaves must not overflow their squares)."""
    return _root_sum_sq(_norms(_leaves([tree])))


def nonfinite_count(*trees: Any) -> torch.Tensor:
    """The count of non-finite elements of every floating tensor of
    ``trees`` (int32; 0 on a healthy step)."""
    leaves = [t for t in _leaves(trees) if t.is_floating_point()]
    if not leaves:
        return torch.zeros((), dtype=torch.int32)
    flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
    return (~torch.isfinite(flat)).sum(dtype=torch.int32)


def param_group(name: str) -> str:
    """A parameter's group: the first component of its name."""
    return name.split(".", 1)[0]


def delta_flow_norms(flows: torch.Tensor) -> torch.Tensor:
    """Per-GRU-iteration RMS update norm, shape ``(T,)``, of the stacked
    ``(T, B, N, 3)`` flows: iteration t's update is ``flows[t] -
    flows[t-1]``, the first from zero flow."""
    flows = flows.detach()
    prev = torch.cat([torch.zeros_like(flows[:1]), flows[:-1]])
    delta = (flows - prev).float()
    return delta.square().mean(dim=(1, 2, 3)).sqrt()


def telemetry_leaves(params: Mapping[str, torch.Tensor],
                     grads: Mapping[str, Optional[torch.Tensor]],
                     updates: Sequence[torch.Tensor], loss: torch.Tensor,
                     flows: Optional[torch.Tensor] = None
                     ) -> Dict[str, Any]:
    """The telemetry leaves (see the module docstring). ``params``: every
    parameter of the model by name, BEFORE the update; ``grads``: the
    gradient of each parameter by name, None where it has none (counted
    as zeros); ``updates``: what the optimizer added to the parameters
    it trains; ``flows``: the stacked stage-1 flows, or None where the
    step has no iteration trajectory to monitor (the refine and packed
    steps)."""
    pnorm = global_norm(params)
    named = [(n, g) for n, g in grads.items() if g is not None]
    gnorms = _norms([g for _, g in named])
    by_group = {}
    for group in sorted({param_group(n) for n in grads}):
        by_group[group] = _root_sum_sq(
            [x for (n, _), x in zip(named, gnorms)
             if param_group(n) == group], like=loss)
    out: Dict[str, Any] = {
        "grad_norm": _root_sum_sq(gnorms, like=loss),
        "param_norm": pnorm,
        "update_ratio": global_norm(updates) / (pnorm + _EPS),
        "grad_norm_by_group": by_group,
    }
    if flows is not None:
        out["delta_flow_norm"] = delta_flow_norms(flows)
    out["nonfinite"] = nonfinite_count(loss, [g for _, g in named], flows)
    return out


# A leaf's path in the telemetry dict: ("grad_norm",) or
# ("grad_norm_by_group", group).
Path = Tuple[str, ...]


def leaf_paths(tel: Mapping[str, Any]) -> List[Path]:
    """The paths of a telemetry dict's tensors, in its order."""
    return [(k, g) if isinstance(v, Mapping) else (k,)
            for k, v in tel.items()
            for g in (v if isinstance(v, Mapping) else (None,))]


def flatten(tel: Mapping[str, Any]) -> Tuple[torch.Tensor, ...]:
    """The tensors of a telemetry dict in :func:`leaf_paths` order: the
    static outputs of a captured step."""
    return tuple(tel[p[0]][p[1]] if len(p) == 2 else tel[p[0]]
                 for p in leaf_paths(tel))


def unflatten(paths: Sequence[Path], tensors: Sequence[Any]
              ) -> Dict[str, Any]:
    """The telemetry dict of :func:`flatten`'s tensors (or of any values
    in that order)."""
    out: Dict[str, Any] = {}
    for path, value in zip(paths, tensors):
        if len(path) == 2:
            out.setdefault(path[0], {})[path[1]] = value
        else:
            out[path[0]] = value
    return out


def step_rows(tel: Mapping[str, Any], steps: int) -> torch.Tensor:
    """One float32 row per optimizer step of a telemetry dict whose
    leaves carry a leading axis of ``steps`` (a K-step call's) or none
    (``steps`` 1): every leaf's values side by side, on the device, so
    that an epoch's telemetry reaches the host in one read."""
    return torch.cat([t.detach().float().reshape(steps, -1)
                      for t in flatten(tel)], dim=1)


def host_records(tel: Mapping[str, Any], steps: int,
                 rows: Sequence[Sequence[float]]) -> List[Dict[str, Any]]:
    """The JSON-ready telemetry of each step from :func:`step_rows`'s
    rows, read to the host, and the telemetry dict (of ``steps`` steps)
    they were made from: scalars as floats, ``delta_flow_norm`` as a
    list, ``nonfinite`` as an int."""
    paths = leaf_paths(tel)
    widths = [t.numel() // steps for t in flatten(tel)]
    records = []
    for row in rows:
        values, i = [], 0
        for path, w in zip(paths, widths):
            chunk = [float(v) for v in row[i:i + w]]
            i += w
            values.append(int(chunk[0]) if path == ("nonfinite",) else
                          chunk if path == ("delta_flow_norm",) else chunk[0])
        records.append(unflatten(paths, values))
    return records
