"""Weights of the port: the JAX package's flax params mapped onto the
port's state_dict, and a seeded initialisation of its own.

The port's submodules are named after the flax param paths, so the
mapping is by name: a Dense ``kernel (in, out)`` becomes a
``Linear.weight (out, in)``, a GroupNorm ``scale`` becomes ``weight``,
``bias`` and the PReLU ``alpha (1,)`` keep their names. The flax tree is
identical for both ``fused_gru`` settings, so one mapping serves both.
:func:`opt_state_from_jax` carries optax's Adam state over with the same
names and transposes, so a JAX run's parameters and optimizer state both
resume in the port.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from pvraft_tpu_torch.config import ModelConfig

_RENAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "alpha": "alpha"}


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, val


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


def seeded_state_dict(cfg: ModelConfig, seed: int) -> Dict[str, torch.Tensor]:
    """A PVRaft state_dict initialised from ``seed`` the way flax
    initialises the JAX model: Linear weights LeCun-normal truncated at
    two standard deviations, biases 0, GroupNorm weight 1 and bias 0,
    PReLU slope 0.25. The draws come from an explicit ``torch.Generator``
    (not flax's numbers)."""
    from pvraft_tpu_torch.models.raft import PVRaft

    gen = torch.Generator().manual_seed(seed)
    state = PVRaft(cfg).state_dict()
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


def opt_state_from_jax(opt_state: Any, model: torch.nn.Module
                       ) -> Dict[str, Any]:
    """Map optax's Adam state (``optax.adam``: ``mu``, ``nu``, ``count``)
    onto a ``torch.optim.Adam(model.parameters())`` state_dict, to load
    with ``optimizer.load_state_dict``. ``mu``/``nu`` become
    ``exp_avg``/``exp_avg_sq`` under the names and transposes of
    :func:`params_from_jax`; ``count`` becomes every parameter's ``step``.
    Raises if a parameter of ``model`` has no moment, a moment no
    parameter, or a moment another shape than its parameter."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise KeyError("no Adam state (count, mu, nu) in the optax state")
    mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
    names = [n for n, _ in model.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise KeyError(
            f"Adam moments do not match the model's parameters: "
            f"{sorted(set(mu) ^ set(names))[:5]}")
    for n, p in model.named_parameters():
        if mu[n].shape != p.shape or nu[n].shape != p.shape:
            raise ValueError(f"Adam moments of {n!r} have shape "
                             f"{tuple(mu[n].shape)}, the parameter "
                             f"{tuple(p.shape)}")
    step = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    sd = torch.optim.Adam(model.parameters()).state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    return sd
