"""Divergence detection and crash snapshots (port of
``pvraft_tpu/obs/divergence.py``).

Two triggers, checked by the Trainer once per optimizer step under
``TrainConfig.telemetry``:

* ``nonfinite``: the in-step sentinel (``obs/monitors.py``) counted a
  non-finite element in the loss, the gradients or the flows;
* ``zscore``: the loss sits more than ``zscore`` trailing standard
  deviations above the trailing window's mean (a learning-rate spike
  shows here steps before anything overflows).

On a trip the Trainer writes the offending step's batch and the train
state as it was BEFORE that step's update to
``<exp_path>/snapshots/step_<n>/``; ``python -m pvraft_tpu_torch.doctor``
(or the JAX package's ``scripts/run_doctor.py``) replays that step and
names the first non-finite stage.

Snapshot layout (``pvraft_snapshot/v1``, the JAX package's):

    step_<n>/meta.json      schema, step, epoch, reason, loss, config
    step_<n>/batch.npz      pc1, pc2, flow, mask
    step_<n>/state.msgpack  {"params", "opt_state"} in flax's state-dict
                            form (``weights.params_to_jax``,
                            ``opt_state_to_jax``), written with the
                            port's msgpack codec (``engine/msgpack.py``)

so that either package reads the other's snapshots.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from pvraft_tpu_torch.engine import msgpack
from pvraft_tpu_torch.obs.events import sanitize
from pvraft_tpu_torch.parallel.distributed import process_index

SNAPSHOT_SCHEMA = "pvraft_snapshot/v1"


class DivergenceHalt(RuntimeError):
    """Raised by the Trainer under ``halt_on_divergence`` when the
    detector trips, after the epoch's step events are written."""


@dataclasses.dataclass
class Trip:
    """One firing of the detector."""

    reason: str                  # "nonfinite" | "zscore"
    loss: float
    zscore: Optional[float] = None


class DivergenceDetector:
    """Trailing-window loss monitor on the host.

    ``update(loss, nonfinite)`` takes one optimizer step's host scalars
    and returns a :class:`Trip` when the run looks unhealthy, else None.
    Only healthy steps enter the window, so one spike does not widen the
    trailing spread and hide the next. ``min_steps`` is clamped to
    ``[2, window]``: a minimum the window cannot reach would disarm the
    z-score for the whole run."""

    def __init__(self, window: int = 64, zscore: float = 6.0,
                 min_steps: int = 8):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = window
        self.zscore = zscore
        self.min_steps = min(max(2, min_steps), window)
        self.losses: deque = deque(maxlen=window)

    def update(self, loss: float, nonfinite: int = 0) -> Optional[Trip]:
        if nonfinite > 0 or not np.isfinite(loss):
            return Trip(reason="nonfinite", loss=float(loss))
        if self.zscore > 0 and len(self.losses) >= self.min_steps:
            mean = float(np.mean(self.losses))
            std = float(np.std(self.losses))
            # A flat window (std ~ 0) would make any wiggle an infinite
            # z-score: the scale is floored at 1e-6 of the mean.
            scale = max(std, 1e-6 * max(abs(mean), 1.0))
            z = (float(loss) - mean) / scale
            if z > self.zscore:
                return Trip(reason="zscore", loss=float(loss),
                            zscore=round(z, 2))
        self.losses.append(float(loss))
        return None


def dump_snapshot(snap_dir: str, batch: Mapping[str, np.ndarray],
                  params: Mapping[str, Any], opt_state: Mapping[str, Any], *,
                  step: int, epoch: int, reason: str, loss: float, cfg=None,
                  extra_meta: Optional[Dict[str, Any]] = None
                  ) -> Optional[str]:
    """Write one ``pvraft_snapshot/v1`` directory and return its path;
    on a rank other than 0 write nothing and return None (a snapshot is
    process-0 filesystem state, as in the JAX package; the Trainer takes
    none with several processes). ``params`` and ``opt_state`` are the
    flax state-dict trees of numpy arrays (``params_to_jax``,
    ``opt_state_to_jax``) of the state BEFORE the offending update;
    ``batch`` is that step's host batch."""
    if process_index() != 0:
        return None
    out = os.path.join(snap_dir, f"step_{step:07d}")
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "batch.npz"),
             **{k: np.asarray(v) for k, v in batch.items()})
    tmp = os.path.join(out, "state.msgpack.tmp")
    with open(tmp, "wb") as f:
        f.write(msgpack.packb({"params": params, "opt_state": opt_state}))
    os.replace(tmp, os.path.join(out, "state.msgpack"))
    meta = {
        "schema": SNAPSHOT_SCHEMA,
        "step": step,
        "epoch": epoch,
        "reason": reason,
        "loss": sanitize(float(loss)),
        "config": (sanitize(dataclasses.asdict(cfg))
                   if dataclasses.is_dataclass(cfg) else sanitize(cfg or {})),
    }
    if extra_meta:
        meta.update(sanitize(extra_meta))
    with open(os.path.join(out, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return out


def load_snapshot(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray],
                                      Dict[str, Any], Dict[str, Any]]:
    """A snapshot directory (the port's or the JAX package's) as (meta,
    batch, params, opt_state): ``params`` the flax variables dict
    ``{"params": tree}`` and ``opt_state`` the optax state's state-dict
    form, nested dicts of numpy arrays (``weights.params_from_jax`` and
    ``opt_state_from_jax`` read them)."""
    with open(os.path.join(path, "meta.json"), "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(
            f"{path}: schema {meta.get('schema')!r} != {SNAPSHOT_SCHEMA!r}")
    with np.load(os.path.join(path, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        payload = msgpack.unpackb(f.read())
    return meta, batch, payload["params"], payload["opt_state"]
