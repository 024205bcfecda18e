"""``pvraft_fleet_chaos/v1``: the schema of a fleet chaos run's evidence
(port of ``pvraft_tpu/fleet/artifact.py``).

A run of two or more backends behind the router shows three things:

1. losing a backend mid-load: every request still resolves (spillover
   and retry), the ledger identity holding at every polled snapshot;
2. a weight hot swap with no recompile: the weights digest changes and
   the sealed retrace watchdog counts 0;
3. the canary gate renders a verdict against its bounds.

:func:`validate_fleet_artifact` checks that structure; the embedded
``load`` block is a whole ``pvraft_serve_load/v1`` document and goes
through the serve validator.
"""

from __future__ import annotations

from typing import Any, Dict, List

from pvraft_tpu_torch.obs.events import CANARY_VERDICTS
from pvraft_tpu_torch.serve.loadgen import validate_load_artifact

__all__ = ["FLEET_CHAOS_SCHEMA", "validate_fleet_artifact"]

FLEET_CHAOS_SCHEMA = "pvraft_fleet_chaos/v1"

# Phase names, in the order the chaos run executes them.
FLEET_CHAOS_PHASES = ("baseline", "backend_loss", "hot_swap", "canary")


def _phase_index(phases: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    return {p.get("phase"): p for p in phases if isinstance(p, dict)}


def validate_fleet_artifact(doc: Any,
                            path: str = "<fleet_chaos>") -> List[str]:
    """Structural problems with one fleet chaos artifact ([] = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"{path}: not a JSON object"]
    if doc.get("schema") != FLEET_CHAOS_SCHEMA:
        problems.append(
            f"schema must be {FLEET_CHAOS_SCHEMA!r}: {doc.get('schema')!r}")
        return problems

    cfg = doc.get("config")
    if not isinstance(cfg, dict):
        problems.append("config: missing or not an object")
        cfg = {}
    backends = cfg.get("backends")
    if not isinstance(backends, int) or backends < 2:
        problems.append(
            f"config.backends: a fleet chaos run needs >= 2 backends "
            f"(got {backends!r})")
    targets = cfg.get("targets")
    if (not isinstance(targets, list) or not targets
            or not all(isinstance(t, str) and t for t in targets)):
        problems.append("config.targets: must be a non-empty string list")
    elif isinstance(backends, int) and len(targets) != backends:
        problems.append(
            f"config.targets: {len(targets)} entries for "
            f"{backends} backends")
    mix = cfg.get("traffic_mix")
    if not isinstance(mix, list) or not mix:
        problems.append("config.traffic_mix: missing (the capacity "
                        "plan's per-bucket fractions drive the run)")
    else:
        total = sum(row.get("fraction", 0) for row in mix
                    if isinstance(row, dict))
        if not 0.99 <= total <= 1.01:
            problems.append(
                f"config.traffic_mix: fractions sum to {total}, not 1")

    load = doc.get("load")
    if not isinstance(load, dict):
        problems.append("load: missing embedded pvraft_serve_load/v1 block")
    else:
        problems.extend(f"load.{p}" for p in validate_load_artifact(
            load, path=f"{path}#load"))

    phases = doc.get("phases")
    if not isinstance(phases, list):
        problems.append("phases: missing or not a list")
        phases = []
    by_name = _phase_index(phases)
    names = [p.get("phase") for p in phases if isinstance(p, dict)]
    if tuple(names) != FLEET_CHAOS_PHASES:
        problems.append(
            f"phases: must be {list(FLEET_CHAOS_PHASES)} in order "
            f"(got {names})")

    loss = by_name.get("backend_loss", {})
    if not isinstance(loss.get("killed_backend"), int):
        problems.append("phases[backend_loss].killed_backend: missing")
    if not (isinstance(loss.get("spillovers"), int)
            and loss["spillovers"] > 0):
        problems.append(
            "phases[backend_loss].spillovers: must be > 0 (losing a "
            "backend mid-load must visibly re-route work)")
    if loss.get("resolved") is not True:
        problems.append(
            "phases[backend_loss].resolved: every request of the loss "
            "phase must have resolved (ok or bounded-retry rejected)")

    swap_phase = by_name.get("hot_swap", {})
    swapped = (swap_phase.get("swap") or {}).get("swapped")
    if not isinstance(swapped, list) or not swapped:
        problems.append("phases[hot_swap].swap.swapped: missing rows")
    else:
        for row in swapped:
            if not isinstance(row, dict) or row.get("status") != 200:
                problems.append(
                    f"phases[hot_swap].swap.swapped: non-200 row {row!r}")
                continue
            report = row.get("report") or {}
            if not report.get("digest"):
                problems.append(
                    "phases[hot_swap]: swap report carries no digest")
            elif report.get("digest") == report.get("previous_digest"):
                problems.append(
                    "phases[hot_swap]: digest unchanged — no swap "
                    "actually happened")

    canary_phase = by_name.get("canary", {})
    verdict = canary_phase.get("verdict")
    if not isinstance(verdict, dict):
        problems.append("phases[canary].verdict: missing")
    else:
        if verdict.get("verdict") not in CANARY_VERDICTS:
            problems.append(
                f"phases[canary].verdict.verdict: "
                f"{verdict.get('verdict')!r} not in {CANARY_VERDICTS}")
        if not (isinstance(verdict.get("samples"), int)
                and verdict["samples"] >= 1):
            problems.append("phases[canary].verdict.samples: must be >= 1")

    rec = doc.get("reconciliation")
    if not isinstance(rec, dict):
        problems.append("reconciliation: missing")
    else:
        if rec.get("holds") is not True:
            problems.append(
                "reconciliation.holds: the request identity must have "
                "held at every polled snapshot")
        if not (isinstance(rec.get("snapshots"), int)
                and rec["snapshots"] >= 3):
            problems.append(
                "reconciliation.snapshots: need >= 3 mid-run polls "
                "(an unpolled identity proves nothing)")

    for key in ("recompiles", "watchdog_trips"):
        if doc.get(key) != 0:
            problems.append(
                f"{key}: must be 0 — the hot-swap claim is zero "
                f"recompiles under the sealed watchdog "
                f"(got {doc.get(key)!r})")
    return problems
