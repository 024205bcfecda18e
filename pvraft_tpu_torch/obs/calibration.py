"""Calibration evidence: the ``pvraft_cost_calibration/v1`` document
(port of ``pvraft_tpu/obs/calibration.py``).

One record per served (bucket, batch, dtype): the cost surface's
predicted device-seconds beside the measured ones (the serve pool's
``/healthz`` ``cost.calibration`` block, ``serve/costing.py``), with the
prediction's basis and the ``comparable`` flag; and the identity ledger:
``requests == responses + sum(rejected) + in_flight`` polled from the
service's Prometheus text throughout the run, which must have held at
every snapshot (``identity.violations == 0``).

``comparable: true`` is valid only on platform "tpu", the rule of
``serve/costing.py`` and of the event schema: a calibration taken on the
card records its ratio with ``comparable: false``.

``python -m pvraft_tpu_torch.obs validate-calibration`` is the CLI.
"""

from __future__ import annotations

from typing import Any, List

CALIBRATION_SCHEMA = "pvraft_cost_calibration/v1"

_REQUIRED = ("schema", "surface", "platform", "dtype", "identity",
             "records", "config")
_RECORD_REQUIRED = ("bucket", "batch", "dtype", "n", "predicted_s",
                    "measured_s", "ratio", "comparable")


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_calibration(doc: Any,
                         path: str = "<calibration>") -> List[str]:
    """Schema problems of one calibration artifact ([] = valid)."""
    if not isinstance(doc, dict):
        return [f"{path}: artifact is {type(doc).__name__}, not an object"]
    problems: List[str] = []
    if doc.get("schema") != CALIBRATION_SCHEMA:
        problems.append(
            f"{path}: schema {doc.get('schema')!r} != "
            f"{CALIBRATION_SCHEMA!r}")
    for key in _REQUIRED:
        if key not in doc:
            problems.append(f"{path}: missing field {key!r}")
    if problems:
        return problems
    if not isinstance(doc["platform"], str) or not doc["platform"]:
        problems.append(f"{path}: platform must be a non-empty string")
    identity = doc["identity"]
    if not isinstance(identity, dict) \
            or not isinstance(identity.get("snapshots"), int) \
            or not isinstance(identity.get("violations"), int):
        problems.append(
            f"{path}: identity must carry int snapshots/violations")
    else:
        if identity["snapshots"] < 1:
            problems.append(
                f"{path}: identity.snapshots {identity['snapshots']} — "
                "evidence with no polled snapshots proves nothing")
        if identity["violations"] != 0:
            problems.append(
                f"{path}: identity.violations "
                f"{identity['violations']} != 0 — the reconciliation "
                "identity must hold at EVERY polled snapshot")
    records = doc["records"]
    if not isinstance(records, list) or not records:
        problems.append(f"{path}: records must be a non-empty list")
        return problems
    for i, rec in enumerate(records):
        where = f"{path}: records[{i}]"
        if not isinstance(rec, dict):
            problems.append(f"{where}: not an object")
            continue
        for key in _RECORD_REQUIRED:
            if key not in rec:
                problems.append(f"{where}: missing {key!r}")
        if not isinstance(rec.get("comparable"), bool):
            problems.append(f"{where}: comparable must be a bool")
        elif rec["comparable"] and doc.get("platform") != "tpu":
            problems.append(
                f"{where}: comparable=true on platform "
                f"{doc.get('platform')!r} — only TPU measurements may "
                "be enforced against the TPU-topology prediction")
        for key in ("predicted_s", "measured_s"):
            if key in rec and (not _is_num(rec[key]) or rec[key] < 0):
                problems.append(
                    f"{where}: {key}={rec.get(key)!r} must be a "
                    "number >= 0")
        # The ratio is recomputed, not trusted.
        if all(_is_num(rec.get(k)) for k in ("predicted_s", "measured_s",
                                             "ratio")) \
                and rec["predicted_s"] > 0:
            want = rec["measured_s"] / rec["predicted_s"]
            if abs(rec["ratio"] - want) > max(1e-3, 1e-3 * want):
                problems.append(
                    f"{where}: ratio {rec['ratio']} != measured/"
                    f"predicted = {want:.4f}")
        if isinstance(rec.get("n"), int) and rec["n"] < 1:
            problems.append(f"{where}: n must be >= 1")
    return problems


def validate_calibration_file(path: str) -> List[str]:
    from pvraft_tpu_torch.obs.loading import load_json_artifact

    doc, problems = load_json_artifact(path)
    if problems:
        return problems
    return validate_calibration(doc, path=path)
