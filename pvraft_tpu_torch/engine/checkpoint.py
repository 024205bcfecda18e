"""Checkpoint save and load (port of ``pvraft_tpu/engine/checkpoint.py``).

The same files as the JAX package's ``msgpack`` backend, so a checkpoint
crosses between the two packages in both directions: one
``flax.serialization``-format msgpack file per checkpoint (written by the
port's own codec, ``engine/msgpack.py``), atomically by a tmp file and
``os.replace``, under the reference's three names: ``last_checkpoint``
after every epoch, ``{epoch:03d}`` every ``checkpoint_interval`` epochs,
``best_checkpoint`` on a validation improvement. The payload is the JAX
Trainer's, ``{"epoch": int, "params": {"params": <flax tree>},
"opt_state": <optax state dict>}`` (``weights.py::params_to_jax``,
``opt_state_to_jax``), its maps in sorted key order as flax writes them.

``ckpt_backend="orbax"``, or an ``.orbax`` directory, raises: Orbax is not
installed where the port runs, and the port records that disposition
(ROADMAP queue 1 item 2) rather than dropping the knob.

:func:`load_torch_checkpoint` reads a reference-published ``.params``
file (a torch pickle of ``{'epoch', 'state_dict'}`` with the reference's
key names) into the port's state_dict, through the port's own copy of the
JAX package's reference-name mapping (``import_torch_state_dict``,
``pvraft_tpu/engine/checkpoint.py:549-672``), stage 1 and stage 2.
:func:`export_torch_state_dict` is the way back, the port's copy of the
JAX package's exporter (``checkpoint.py:670-755``): a flax tree as the
reference's state_dict, which ``python -m pvraft_tpu_torch.export``
writes as a ``.params`` file. As the JAX docstring demands, the two
directions are written out separately, so that a round trip catches a
drift on either side.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from pvraft_tpu_torch.engine import msgpack
from pvraft_tpu_torch.parallel.distributed import process_index
from pvraft_tpu_torch.weights import params_from_jax, params_to_jax

SUFFIX = ".msgpack"
ORBAX_SUFFIX = ".orbax"
BACKENDS = ("msgpack",)


def _no_orbax(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: Orbax checkpoints are not ported (its recorded "
        f"disposition, ROADMAP queue 1 item 2: Orbax is not installed where "
        f"the port runs); the port writes and reads msgpack checkpoints")


def _sorted(tree: Any) -> Any:
    """Maps in sorted key order, as ``flax.serialization`` writes them."""
    if isinstance(tree, Mapping):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _write(path: str, payload: Mapping[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(_sorted(payload)))
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, params: Mapping[str, Any],
                    opt_state: Mapping[str, Any], epoch: int,
                    checkpoint_interval: int = 5, best: bool = False,
                    backend: str = "msgpack") -> Tuple[str, ...]:
    """Write ``last_checkpoint``, then ``{epoch:03d}`` every
    ``checkpoint_interval`` epochs, then ``best_checkpoint`` when
    ``best`` (the naming of the reference's ``tools/utils.py:7-17``).
    ``params``: the flax variables dict (``params_to_jax``);
    ``opt_state``: the optax state dict (``opt_state_to_jax``). Returns
    the paths; process 0 alone writes them, as in the JAX package (the
    ranks hold the same state, and concurrent writes to one ``.tmp``
    could interleave a truncation with a rename): a caller with several
    processes waits for it before reading them (``Trainer.save``)."""
    if backend == "orbax":
        raise _no_orbax("save_checkpoint")
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"epoch": int(epoch), "params": params, "opt_state": opt_state}
    paths = checkpoint_paths(ckpt_dir, epoch, checkpoint_interval, best)
    if process_index() == 0:
        for p in paths:
            _write(p, payload)
    return paths


def checkpoint_paths(ckpt_dir: str, epoch: int, checkpoint_interval: int,
                     best: bool = False) -> Tuple[str, ...]:
    """The files :func:`save_checkpoint` writes for these arguments."""
    names = ["last_checkpoint"]
    if checkpoint_interval and (epoch + 1) % checkpoint_interval == 0:
        names.append(f"{epoch:03d}")
    if best:
        names.append("best_checkpoint")
    return tuple(os.path.join(ckpt_dir, n + SUFFIX) for n in names)


def load_payload(path: str) -> Dict[str, Any]:
    """A checkpoint's payload, ``{"epoch", "params", "opt_state"}`` with
    numpy leaves."""
    if path.endswith(ORBAX_SUFFIX) or os.path.isdir(path):
        raise _no_orbax(path)
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def load_checkpoint(path: str, with_opt_state: bool = True
                    ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], int]:
    """(params, opt_state, epoch) of a checkpoint: the flax variables dict
    and the optax state dict as written, numpy leaves.
    ``with_opt_state=False`` skips the optimizer state (the reference's
    eval-only load)."""
    payload = load_payload(path)
    params = payload["params"]
    if set(params) != {"params"}:
        params = {"params": params}
    opt_state = payload.get("opt_state") if with_opt_state else None
    return params, opt_state, int(payload["epoch"])


def load_params(path: str) -> Tuple[Dict[str, Any], int]:
    """Parameters only: ``(variables, epoch)``, the variables dict
    ``{"params": tree}`` whichever payload shape the file holds, and
    epoch -1 when the payload has none."""
    payload = load_payload(path)
    tree = payload["params"]
    if set(tree) != {"params"}:
        tree = {"params": tree}
    return tree, int(payload.get("epoch", -1))


def find_checkpoint(ckpt_dir: str, name: str) -> Optional[str]:
    """Path of checkpoint ``name`` (e.g. ``best_checkpoint``), or None.
    Raises where only an Orbax checkpoint of that name exists."""
    path = os.path.join(ckpt_dir, name + SUFFIX)
    if os.path.exists(path):
        return path
    if os.path.exists(os.path.join(ckpt_dir, name + ORBAX_SUFFIX)):
        raise _no_orbax(os.path.join(ckpt_dir, name + ORBAX_SUFFIX))
    return None


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    return find_checkpoint(ckpt_dir, "last_checkpoint")


# ---------------------------------------------------------------------------
# Reference-published torch checkpoints.
# ---------------------------------------------------------------------------


_REFINE_HEAD_KEYS = ("ref_conv1", "ref_conv2", "ref_conv3", "fc")


def load_torch_checkpoint(path: str, refine: bool = False
                          ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Read a reference ``.params`` file (a torch pickle of ``{'epoch',
    'state_dict'}``, ``tools/utils.py:14-17``) with
    ``torch.load(weights_only=True)``; DataParallel ``module.`` prefixes
    are accepted. ``refine`` reads an ``RSF_refine`` file into the
    PVRaftRefine layout: the stage-1 modules under ``backbone``, the head
    at the top. Returns (the port's state_dict, to load with
    ``strict=True``; epoch, -1 when absent)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = payload.get("state_dict", payload)
    epoch = int(payload.get("epoch", -1)) if isinstance(payload, dict) else -1
    as_numpy = {
        (k[len("module."):] if k.startswith("module.") else k):
            v.detach().numpy()
        for k, v in state_dict.items()
    }
    tree = import_torch_state_dict(as_numpy)
    if refine:
        head = {k: v for k, v in tree.items() if k in _REFINE_HEAD_KEYS}
        tree = {"backbone": {k: v for k, v in tree.items()
                             if k not in _REFINE_HEAD_KEYS}, **head}
    return params_from_jax(tree), epoch


_ENCODER_CONV = {"feat_conv1": "conv1", "feat_conv2": "conv2",
                 "feat_conv3": "conv3"}
_SEQ_MAPS = {
    "out_conv": {"0": ("out_conv1", "dense"), "1": ("out_gn", "gn"),
                 "2": ("out_prelu", "prelu"), "3": ("out_conv2", "dense")},
    "knn_conv": {"0": ("knn_conv", "dense"), "1": ("knn_gn", "gn"),
                 "2": ("knn_prelu", "prelu")},
    "out_conv_head": {"0": ("out_conv1", "dense"),
                      "2": ("out_conv2", "dense")},
}


def _convert_tensor(parts, t: np.ndarray) -> Tuple[str, np.ndarray]:
    """One reference parameter as (flax leaf name, array): 1x1 conv and
    Linear weights (out, in[, 1[, 1]]) become (in, out) Dense kernels,
    GroupNorm weights scales, biases stay."""
    leaf = parts[-1]
    if leaf == "weight":
        if t.ndim >= 3:
            return "kernel", t.reshape(t.shape[0], t.shape[1]).T
        if t.ndim == 2:
            return "kernel", t.T
        return "scale", t
    if leaf == "bias":
        return "bias", t
    raise ValueError(f"unhandled torch param {'.'.join(parts)}")


def import_torch_state_dict(state_dict: Mapping[str, np.ndarray]
                            ) -> Dict[str, Any]:
    """A reference ``RSF`` or ``RSF_refine`` state_dict (numpy values) as
    the flax params tree of the JAX package (then :func:`params_from_jax`
    names it for the port). The reference's module tree maps as:
      feature_extractor.feat_convN.*   -> feature_extractor.convN.*
      context_extractor.feat_convN.*   -> context_extractor.convN.*
      corr_block.out_conv.{0,1,2,3}    -> update_iter.corr_lookup.{out_conv1,out_gn,out_prelu,out_conv2}
      corr_block.knn_conv.{0,1,2}      -> update_iter.corr_lookup.{knn_conv,knn_gn,knn_prelu}
      corr_block.knn_out               -> update_iter.corr_lookup.knn_out
      update_block.*                   -> update_iter.update_block.*
      refine_block.ref_convN.*, .fc.*  -> ref_convN.*, fc.* (stage 2)
    A PReLU weight becomes ``alpha``."""
    out: Dict[str, Any] = {}

    def put(path, name, value):
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[name] = value

    for key, t in state_dict.items():
        t = np.asarray(t)
        parts = key.split(".")
        top = parts[0]
        if top in ("feature_extractor", "context_extractor"):
            name, arr = _convert_tensor(parts, t)
            put([top, _ENCODER_CONV[parts[1]], parts[2]], name, arr)
        elif top == "corr_block":
            block = parts[1]
            if block in ("out_conv", "knn_conv"):
                tgt, kind = _SEQ_MAPS[block][parts[2]]
                if kind == "prelu":
                    put(["update_iter", "corr_lookup", tgt], "alpha",
                        t.reshape(-1))
                else:
                    name, arr = _convert_tensor(parts, t)
                    put(["update_iter", "corr_lookup", tgt], name, arr)
            elif block == "knn_out":
                name, arr = _convert_tensor(parts, t)
                put(["update_iter", "corr_lookup", "knn_out"], name, arr)
            else:
                raise ValueError(f"unknown corr_block child {key}")
        elif top == "update_block":
            sub = parts[1]
            ub = ["update_iter", "update_block"]
            if sub in ("motion_encoder", "gru"):
                name, arr = _convert_tensor(parts, t)
                put(ub + [sub, parts[2]], name, arr)
            elif sub == "flow_head":
                tail = parts[2]
                name, arr = _convert_tensor(parts, t)
                if tail == "conv1":
                    put(ub + ["flow_head", "conv1"], name, arr)
                elif tail == "setconv":
                    put(ub + ["flow_head", "setconv", parts[3]], name, arr)
                elif tail == "out_conv":
                    tgt, _ = _SEQ_MAPS["out_conv_head"][parts[3]]
                    put(ub + ["flow_head", tgt], name, arr)
                else:
                    raise ValueError(f"unknown flow_head child {key}")
            else:
                raise ValueError(f"unknown update_block child {key}")
        elif top == "refine_block":
            if parts[1] not in _REFINE_HEAD_KEYS:
                raise ValueError(f"unknown refine_block child {key}")
            name, arr = _convert_tensor(parts, t)
            put(parts[1:-1], name, arr)
        else:
            raise ValueError(f"unknown top-level module {key}")
    return out


# ---------------------------------------------------------------------------
# Export to the reference's key names.
# ---------------------------------------------------------------------------

# The reference's module of each SetConv leaf: fc1 a Conv2d
# (model/flot/gconv.py:26), fc2 and fc3 1x1 Conv1ds, gn1-3 GroupNorms.
_SETCONV_KIND = {"fc1": "conv2d", "fc2": "conv1d", "fc3": "conv1d",
                 "gn1": "gn", "gn2": "gn", "gn3": "gn"}
_REFINE_CONV = ("ref_conv1", "ref_conv2", "ref_conv3")


def _to_torch_leaves(kind: str, leaves: Mapping[str, Any]
                     ) -> Dict[str, np.ndarray]:
    """One reference module of ``kind`` from its flax leaves (the inverse
    of :func:`_convert_tensor`): a Dense ``kernel (in, out)`` becomes the
    ``(out, in[, 1[, 1]])`` conv or Linear weight, a GroupNorm ``scale``
    its weight, a PReLU ``alpha`` its weight."""
    out: Dict[str, np.ndarray] = {}
    if kind in ("conv1d", "conv2d", "linear"):
        k = np.asarray(leaves["kernel"]).T
        out["weight"] = {"conv1d": lambda w: w[:, :, None],
                         "conv2d": lambda w: w[:, :, None, None],
                         "linear": lambda w: w}[kind](k)
        if "bias" in leaves:
            out["bias"] = np.asarray(leaves["bias"])
    elif kind == "gn":
        out["weight"] = np.asarray(leaves["scale"])
        out["bias"] = np.asarray(leaves["bias"])
    elif kind == "prelu":
        out["weight"] = np.asarray(leaves["alpha"]).reshape(-1)
    else:
        raise ValueError(f"unknown module kind {kind}")
    return out


def export_torch_state_dict(tree: Mapping[str, Any], refine: bool = False
                            ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`import_torch_state_dict`: a flax params tree
    (the ``{"params": ...}`` inner dict, as ``weights.params_to_jax``
    gives it; the wrapper is accepted) as a state dict the reference's
    models load with ``strict=True`` (``model/RAFTSceneFlow.py``,
    ``RAFTSceneFlowRefine.py``). ``refine`` expects the PVRaftRefine
    layout (stage 1 under ``backbone``, the head at the top) and emits
    ``refine_block.*``. ``SetConv.fc1`` and ``corr_block.knn_conv.0``
    are Conv2d, ``refine_block.fc`` a Linear, every other conv a 1x1
    Conv1d."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    sd: Dict[str, np.ndarray] = {}

    def emit(prefix, kind, leaves):
        for name, v in _to_torch_leaves(kind, leaves).items():
            sd[f"{prefix}.{name}"] = v

    def emit_setconv(prefix, node):
        for sub, leaves in node.items():
            emit(f"{prefix}.{sub}", _SETCONV_KIND[sub], leaves)

    backbone = tree["backbone"] if refine else tree
    for enc in ("feature_extractor", "context_extractor"):
        for theirs, ours in _ENCODER_CONV.items():
            emit_setconv(f"{enc}.{theirs}", backbone[enc][ours])
    cl = backbone["update_iter"]["corr_lookup"]
    for theirs, ours, kind in (
            ("out_conv.0", "out_conv1", "conv1d"), ("out_conv.1", "out_gn", "gn"),
            ("out_conv.2", "out_prelu", "prelu"),
            ("out_conv.3", "out_conv2", "conv1d"),
            ("knn_conv.0", "knn_conv", "conv2d"), ("knn_conv.1", "knn_gn", "gn"),
            ("knn_conv.2", "knn_prelu", "prelu"),
            ("knn_out", "knn_out", "conv1d")):
        emit(f"corr_block.{theirs}", kind, cl[ours])
    ub = backbone["update_iter"]["update_block"]
    for sub, names in (("motion_encoder", ("conv_corr", "conv_flow", "conv")),
                       ("gru", ("convz", "convr", "convq"))):
        for name in names:
            emit(f"update_block.{sub}.{name}", "conv1d", ub[sub][name])
    fh = ub["flow_head"]
    emit("update_block.flow_head.conv1", "conv1d", fh["conv1"])
    emit_setconv("update_block.flow_head.setconv", fh["setconv"])
    emit("update_block.flow_head.out_conv.0", "conv1d", fh["out_conv1"])
    emit("update_block.flow_head.out_conv.2", "conv1d", fh["out_conv2"])
    if refine:
        for name in _REFINE_CONV:
            emit_setconv(f"refine_block.{name}", tree[name])
        emit("refine_block.fc", "linear", tree["fc"])
    return sd


def export_state_dict(state: Mapping[str, torch.Tensor]
                      ) -> Dict[str, np.ndarray]:
    """:func:`export_torch_state_dict` of a port state_dict (a PVRaft's,
    or a PVRaftRefine's: its ``backbone.`` keys say so)."""
    refine = any(k.startswith("backbone.") for k in state)
    return export_torch_state_dict(params_to_jax(state)["params"], refine)
