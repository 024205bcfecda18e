"""Weights of the port: the JAX package's flax params mapped onto the
port's state_dict, and a seeded initialisation of its own.

The port's submodules are named after the flax param paths, so the
mapping is by name: a Dense ``kernel (in, out)`` becomes a
``Linear.weight (out, in)``, a GroupNorm ``scale`` becomes ``weight``,
``bias`` and the PReLU ``alpha (1,)`` keep their names. The flax tree is
identical for both ``fused_gru`` settings, so one mapping serves both.
:func:`opt_state_from_jax` carries optax's Adam state over with the same
names and transposes, so a JAX run's parameters and optimizer state both
resume in the port. :func:`params_to_jax` and :func:`opt_state_to_jax`
are their exact inverses (the transposes and renames undone, bit for
bit), so the port writes checkpoints that the JAX package loads.

Stage 2 (``PVRaftRefine``) trains its head only: the JAX package wraps
Adam in ``optax.masked`` (``_refine_mask``: every leaf outside
``backbone``), whose state is ``{"inner_state": <the adam chain's>}``
with an empty ``MaskedNode`` (``{}`` in state-dict form) for every
backbone leaf of ``mu`` and ``nu``. :func:`trained_parameters` names the
parameters Adam covers, and the two optimizer-state mappings read and
write that layout for a refine model.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import (Any, Collection, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from pvraft_tpu_torch.config import ModelConfig

_RENAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "alpha": "alpha"}


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    """(path, leaf) of a nested mapping, sorted by key. optax's
    ``MaskedNode`` (an empty NamedTuple, ``{}`` in state-dict form: a leaf
    a masked optimizer does not cover) yields nothing."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        elif not (isinstance(val, tuple) and not val):
            yield path, val


def trained_parameters(model: torch.nn.Module
                       ) -> List[Tuple[str, torch.nn.Parameter]]:
    """(name, parameter) of what Adam trains, in ``named_parameters``
    order: every parameter of a PVRaft, and of a PVRaftRefine those
    outside ``backbone`` (the JAX Trainer's ``_refine_mask``)."""
    return [(n, p) for n, p in model.named_parameters()
            if not n.startswith("backbone.")]


def params_from_jax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax params tree (nested dicts of arrays; the ``{"params":
    ...}`` variables wrapper is accepted) onto a PVRaft state_dict of
    fp32 CPU tensors, to load with ``strict=True``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, leaf in _flatten(tree):
        module, _, name = path.rpartition(".")
        if name not in _RENAME:
            raise KeyError(f"unexpected flax leaf {path!r}")
        arr = np.array(leaf, dtype=np.float32)
        if name == "kernel":
            arr = arr.T
        out[f"{module}.{_RENAME[name]}"] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor],
                  masked: Collection[str] = ()) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a PVRaft or PVRaftRefine
    state_dict (or any name -> tensor mapping of its parameters: Adam's
    moments) as the flax variables dict ``{"params": tree}`` of float32
    numpy arrays. A 2-D ``weight`` becomes the (in, out) Dense
    ``kernel``, a 1-D ``weight`` the GroupNorm ``scale``. The leaves
    named in ``masked`` are written as ``{}``, optax's ``MaskedNode``."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        module, _, leaf = name.rpartition(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        elif leaf not in ("bias", "alpha"):
            raise KeyError(f"unexpected parameter {name!r}")
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[leaf] = ({} if name in masked
                      else np.ascontiguousarray(arr, dtype=np.float32))
    return {"params": tree}


def seeded_state_dict(cfg: ModelConfig, seed: int, refine: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """A PVRaft (``refine``: PVRaftRefine) state_dict initialised from
    ``seed`` the way flax initialises the JAX model: Linear weights
    LeCun-normal truncated at two standard deviations, biases 0, GroupNorm
    weight 1 and bias 0, PReLU slope 0.25. The draws come from an explicit
    ``torch.Generator`` (not flax's numbers)."""
    from pvraft_tpu_torch.models.raft import PVRaft, PVRaftRefine

    # The caller derives the seed (torch_seed(seed, "model.init") on the
    # Trainer's, Evaluator's and catalog's paths); another draw would
    # change every seeded weight that tests and the card hold bitwise.
    # graftlint: disable-next=GD002 -- seeded weights, held bitwise
    gen = torch.Generator().manual_seed(seed)
    state = (PVRaftRefine if refine else PVRaft)(cfg).state_dict()
    for key in sorted(state):
        t = state[key]
        if key.endswith(".weight") and t.dim() == 2:
            # flax's variance_scaling(1, fan_in, "truncated_normal").
            std = math.sqrt(1.0 / t.shape[1]) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=gen)
        elif key.endswith(".bias"):
            t.zero_()
    return state


def _adam_state(opt_state: Any) -> Any:
    """The node of an optax state that holds Adam's ``count``, ``mu`` and
    ``nu``: a ``ScaleByAdamState`` inside the chain's tuple, or its
    ``flax.serialization.to_state_dict`` form (nested dicts)."""
    if isinstance(opt_state, Mapping):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        children = [opt_state[k] for k in sorted(opt_state)]
    elif all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return {"count": opt_state.count, "mu": opt_state.mu,
                "nu": opt_state.nu}
    elif isinstance(opt_state, Sequence) and not isinstance(opt_state, str):
        children = list(opt_state)
    else:
        children = []
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def opt_state_from_jax(opt_state: Any, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Adam] = None
                       ) -> Dict[str, Any]:
    """Map optax's Adam state (``optax.adam``: ``mu``, ``nu``, ``count``;
    for a refine model ``optax.masked`` around it) onto a
    ``torch.optim.Adam`` state_dict over :func:`trained_parameters`, to
    load with ``optimizer.load_state_dict``. ``mu``/``nu`` become
    ``exp_avg``/``exp_avg_sq`` under the names and transposes of
    :func:`params_from_jax`; ``count`` becomes every parameter's ``step``.
    ``optimizer``, where given, supplies the param groups (its learning
    rate tensor, ``capturable``): loaded into it, a capturable Adam's
    ``step`` lands on the parameters' device, where a captured step
    reads it. Raises if a trained parameter has no moment, a moment no
    trained parameter, or a moment another shape than its parameter."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise KeyError("no Adam state (count, mu, nu) in the optax state")
    mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
    trained = trained_parameters(model)
    names = [n for n, _ in trained]
    if set(mu) != set(names) or set(nu) != set(names):
        raise KeyError(
            f"Adam moments do not match the model's trained parameters: "
            f"{sorted(set(mu) ^ set(names))[:5]}")
    for n, p in trained:
        if mu[n].shape != p.shape or nu[n].shape != p.shape:
            raise ValueError(f"Adam moments of {n!r} have shape "
                             f"{tuple(mu[n].shape)}, the parameter "
                             f"{tuple(p.shape)}")
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    if optimizer is None:
        optimizer = torch.optim.Adam([p for _, p in trained])
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    return sd


def opt_state_to_jax(optimizer: torch.optim.Adam, model: torch.nn.Module,
                     schedule_count: Optional[int] = None) -> Dict[str, Any]:
    """The inverse of :func:`opt_state_from_jax`: a ``torch.optim.Adam``
    over :func:`trained_parameters` as the optax state of ``optax.adam(
    schedule)`` in its ``flax.serialization.to_state_dict`` form,
    ``{"0": {"count", "mu", "nu"}, "1": {"count"}}``: ``exp_avg`` and
    ``exp_avg_sq`` under the flax names and transposes, Adam's ``step``
    as int32 ``count``; ``"1"`` is the schedule's count
    (``schedule_count``, default Adam's). Before the first step the
    moments are zeros and both counts 0 (``tx.init``). For a refine model
    it is ``optax.masked``'s: ``{"inner_state": ...}``, every backbone
    leaf of ``mu`` and ``nu`` ``{}``."""
    trained = dict(trained_parameters(model))
    params = dict(model.named_parameters())
    masked = {n for n in params if n not in trained}
    mu, nu, steps = {}, {}, set()
    for name, p in params.items():
        if name in masked:
            mu[name] = nu[name] = p          # written as {}
            continue
        state = optimizer.state.get(p, {})
        mu[name] = state.get("exp_avg", torch.zeros_like(p))
        nu[name] = state.get("exp_avg_sq", torch.zeros_like(p))
        steps.add(int(state["step"]) if "step" in state else 0)
    if len(steps) != 1:
        raise ValueError(f"Adam's parameters are at different steps: "
                         f"{sorted(steps)}")
    count = steps.pop()
    sched = count if schedule_count is None else schedule_count
    chain = {"0": {"count": np.asarray(count, np.int32),
                   "mu": params_to_jax(mu, masked),
                   "nu": params_to_jax(nu, masked)},
             "1": {"count": np.asarray(sched, np.int32)}}
    return {"inner_state": chain} if masked else chain


def schedule_count(opt_state: Mapping[str, Any]) -> Optional[int]:
    """The schedule's count (``"1"``) of an optax state dict written by
    :func:`opt_state_to_jax` or the JAX Trainer, masked or not; None where
    it has none."""
    chain = opt_state.get("inner_state", opt_state)
    count = chain.get("1", {}).get("count") if isinstance(chain, Mapping) \
        else None
    return None if count is None else int(np.asarray(count))
