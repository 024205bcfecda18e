"""The live canary (port of ``pvraft_tpu/fleet/canary.py``): a
deterministic share of the traffic goes to the backend with the new
weights, each such request is mirrored to the incumbent, and the two
flows are compared: the mean end-point error (L2 per point) and the same
over the incumbent's mean flow magnitude. After ``min_samples``
comparisons the verdict is ``promote`` if both means are within their
bounds, else ``reject``. The bounds default to the bf16 serving bounds
(``SERVE_BF16_EPE_BOUND``, ``SERVE_BF16_REL_EPE_BOUND``).

The interleave is a stride, not a coin flip: request k goes to the
canary iff ``floor((k+1)*f) > floor(k*f)``, exactly ``fraction`` of any
long window, with no random stream. All state sits under one
``ordered_lock``; a verdict is decided under it and returned for the
caller to emit after release.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from pvraft_tpu_torch.analysis.concurrency.sanitizer import ordered_lock
from pvraft_tpu_torch.obs.events import CANARY_VERDICTS
from pvraft_tpu_torch.programs.geometries import FLEET_DEFAULTS

__all__ = ["CanaryController", "flow_epe"]


def flow_epe(candidate: List[List[float]],
             baseline: List[List[float]]) -> Dict[str, float]:
    """Mean endpoint error between two flow fields (JSON ``flow``
    payloads: N x 3 nested lists) plus the baseline's mean magnitude —
    the EPE accumulator one comparison contributes. Raises ValueError
    on a shape mismatch (the comparison would be meaningless)."""
    if len(candidate) != len(baseline) or not baseline:
        raise ValueError(
            f"flow shape mismatch: candidate n={len(candidate)} "
            f"baseline n={len(baseline)}")
    epe = mag = 0.0
    for c, b in zip(candidate, baseline):
        epe += math.sqrt(sum((ci - bi) ** 2 for ci, bi in zip(c, b)))
        mag += math.sqrt(sum(bi ** 2 for bi in b))
    n = float(len(baseline))
    return {"epe": epe / n, "mag": mag / n}


class CanaryController:
    """Arms/disarms the canary leg and renders the promotion verdict."""

    def __init__(self, fraction: float = FLEET_DEFAULTS["canary_fraction"],
                 min_samples: int = FLEET_DEFAULTS["canary_min_samples"],
                 epe_bound: float = FLEET_DEFAULTS["canary_epe_bound"],
                 rel_epe_bound: float =
                 FLEET_DEFAULTS["canary_rel_epe_bound"]):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1]: {fraction}")
        self.fraction = float(fraction)
        self.min_samples = int(min_samples)
        self.epe_bound = float(epe_bound)
        self.rel_epe_bound = float(rel_epe_bound)
        self._lock = ordered_lock("fleet.CanaryController._lock")
        self.armed = False               # guarded-by: _lock
        self.canary_backend: Optional[int] = None    # guarded-by: _lock
        self.baseline_backend: Optional[int] = None  # guarded-by: _lock
        self._stride = 0                 # guarded-by: _lock
        self._samples = 0                # guarded-by: _lock
        self._epe_sum = 0.0              # guarded-by: _lock
        self._mag_sum = 0.0              # guarded-by: _lock
        self.verdict: Optional[Dict[str, Any]] = None  # guarded-by: _lock

    def arm(self, canary_backend: int, baseline_backend: int) -> None:
        """Start a fresh canary window: counters reset, verdict
        cleared. Arming against itself is a config error."""
        if int(canary_backend) == int(baseline_backend):
            raise ValueError("canary and baseline must be distinct backends")
        with self._lock:
            self.armed = True
            self.canary_backend = int(canary_backend)
            self.baseline_backend = int(baseline_backend)
            self._stride = self._samples = 0
            self._epe_sum = self._mag_sum = 0.0
            self.verdict = None

    def disarm(self) -> None:
        with self._lock:
            self.armed = False
            self.canary_backend = self.baseline_backend = None

    def take(self) -> bool:
        """Deterministic stride decision for the next client request:
        True = route it to the canary backend. Always False once a
        verdict is in (the window is closed; promotion/rollback is the
        operator's move)."""
        with self._lock:
            if not self.armed or self.verdict is not None:
                return False
            k = self._stride
            self._stride += 1
            return (math.floor((k + 1) * self.fraction)
                    > math.floor(k * self.fraction))

    def record(self, canary_flow: List[List[float]],
               baseline_flow: List[List[float]]
               ) -> Optional[Dict[str, Any]]:
        """Accumulate one canary-vs-incumbent comparison; returns the
        verdict dict exactly once — on the call that crosses
        ``min_samples`` — for the caller to emit (after this lock is
        released; telemetry never nests under controller state)."""
        contrib = flow_epe(canary_flow, baseline_flow)
        with self._lock:
            if not self.armed or self.verdict is not None:
                return None
            self._samples += 1
            self._epe_sum += contrib["epe"]
            self._mag_sum += contrib["mag"]
            if self._samples < self.min_samples:
                return None
            epe = self._epe_sum / self._samples
            mean_mag = self._mag_sum / self._samples
            rel = epe / mean_mag if mean_mag > 0 else float("inf")
            verdict = ("promote" if epe <= self.epe_bound
                       and rel <= self.rel_epe_bound else "reject")
            assert verdict in CANARY_VERDICTS
            self.verdict = {
                "verdict": verdict,
                "epe": round(epe, 6),
                "bound": self.epe_bound,
                "rel_epe": round(rel, 6),
                "rel_bound": self.rel_epe_bound,
                "samples": self._samples,
                "fraction": self.fraction,
                "canary_backend": self.canary_backend,
                "baseline_backend": self.baseline_backend,
            }
            return dict(self.verdict)

    def status(self) -> Dict[str, Any]:
        """The /healthz canary block."""
        with self._lock:
            return {
                "armed": self.armed,
                "canary_backend": self.canary_backend,
                "baseline_backend": self.baseline_backend,
                "fraction": self.fraction,
                "min_samples": self.min_samples,
                "epe_bound": self.epe_bound,
                "rel_epe_bound": self.rel_epe_bound,
                "samples": self._samples,
                "verdict": dict(self.verdict) if self.verdict else None,
            }
