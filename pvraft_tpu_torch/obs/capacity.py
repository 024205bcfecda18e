"""Capacity planning: the ``pvraft_capacity/v1`` plan (port of
``pvraft_tpu/obs/capacity.py``). How many H100 cards for X QPS at this
SLO, as a pure function of three inputs:

* the cost surface (:class:`~pvraft_tpu_torch.programs.costs.
  CostSurface`, the H100 roofline over the port's ``pvraft_costs/v1``
  inventory) prices one (bucket, batch) serve dispatch in predicted
  device-seconds;
* a ``pvraft_serve_load/v1`` document's ``request_points`` histogram
  gives the traffic mix: which share of requests lands in which bucket;
* a ``pvraft_slo/v1`` report gives the latency bar and the measured
  max QPS beside it.

Each bucket's seconds per request are its best batch size's predicted
seconds over the batch (a geometry without a record uses the surface's
flagged linear extrapolation: every row records ``basis`` and
``extrapolated``). The demand at a QPS is the mix-weighted sum; a card
gives one device-second per second, derated by ``utilization_ceiling``
(headroom for the tail), so ``chips_needed = ceil(demand / ceiling)``.

The measured evidence carries its own ``comparable`` flag, true only on
platform "tpu" (the rule the JAX package's plans keep): a run on the
card is recorded beside the plan, not enforced against it. No
timestamps and stable rounding: the plan is byte-deterministic.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

CAPACITY_SCHEMA = "pvraft_capacity/v1"

# Default provisioning knobs (recorded in the artifact — the plan is a
# pure function of inputs INCLUDING these).
DEFAULT_QPS_LADDER = (10.0, 100.0, 1000.0)
DEFAULT_UTILIZATION_CEILING = 0.7


def _round(x: float, sig: int = 6) -> float:
    """Stable significant-figure rounding: the plan is
    byte-deterministic."""
    return float(f"{x:.{sig}g}")


def _bucket_for(n: float, buckets: Sequence[int]) -> Optional[int]:
    for b in buckets:
        if n <= b:
            return int(b)
    return None


def chips_needed(device_seconds_per_sec: float,
                 utilization_ceiling: float) -> int:
    """ceil(demand / ceiling) with a tolerance for float rounding: one
    expression for building the plan and for the validator's
    recompute."""
    return int(math.ceil(
        device_seconds_per_sec / utilization_ceiling - 1e-9))


def build_capacity_report(
    surface,
    load_doc: Dict[str, Any],
    slo_doc: Dict[str, Any],
    buckets: Sequence[int],
    batch_sizes: Sequence[int],
    dtype: str,
    qps_ladder: Sequence[float] = DEFAULT_QPS_LADDER,
    utilization_ceiling: float = DEFAULT_UTILIZATION_CEILING,
    inputs: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Join cost surface + traffic histogram + SLO report into the
    ``pvraft_capacity/v1`` plan. ``surface`` is a
    :class:`~pvraft_tpu_torch.programs.costs.CostSurface`; ``load_doc`` /
    ``slo_doc`` are the parsed documents; ``inputs`` records where they
    came from."""
    if not 0 < utilization_ceiling <= 1:
        raise ValueError("utilization_ceiling must be in (0, 1]")
    rp = load_doc.get("request_points")
    if not rp:
        raise ValueError(
            "load artifact carries no request_points histogram "
            "(pre-trace artifact?)")
    edges = [float(e) for e in rp["edges"]]
    counts = [int(c) for c in rp["counts"]]
    if len(counts) != len(edges) + 1:
        raise ValueError("request_points: len(counts) != len(edges) + 1")

    # Traffic mix: a request in bin i is only known to be <= edges[i],
    # so it is planned into the smallest bucket >= the bin's upper edge
    # (the bucket-advisor rule). The overflow bin (beyond the last edge)
    # is unservable by any table derived from this histogram.
    table = sorted(int(b) for b in buckets)
    per_bucket_requests: Dict[int, int] = {b: 0 for b in table}
    unservable = counts[-1]
    for i, count in enumerate(counts[:-1]):
        if not count:
            continue
        bucket = _bucket_for(edges[i], table)
        if bucket is None:
            unservable += count
        else:
            per_bucket_requests[bucket] += count
    total = sum(counts)
    served = sum(per_bucket_requests.values())

    # Per-bucket device-seconds per request: best certified batch size
    # (lowest per-slot seconds — the throughput configuration), via the
    # surface's flagged extrapolation when the exact geometry is
    # uncertified.
    bucket_rows: List[Dict[str, Any]] = []
    for bucket in table:
        best = None
        for bs in sorted(int(b) for b in batch_sizes):
            est = surface.estimate_serve(bucket, bs, dtype)
            if est is None:
                continue
            per_req = est.device_seconds / bs
            if best is None or per_req < best[0]:
                best = (per_req, bs, est)
        row: Dict[str, Any] = {
            "bucket": bucket,
            "requests": per_bucket_requests[bucket],
            "traffic_fraction": (_round(per_bucket_requests[bucket] / served)
                                 if served else 0.0),
        }
        if best is None:
            row["seconds_per_request"] = None
        else:
            per_req, bs, est = best
            row.update({
                "batch": bs,
                "program": est.name,
                "seconds_per_request": _round(per_req),
                "basis": est.basis,
                "extrapolated": est.extrapolated,
            })
            if est.extrapolated:
                row["extrapolation_scale"] = _round(est.scale)
        bucket_rows.append(row)

    # Mix-weighted device-seconds one average request costs.
    priced = [r for r in bucket_rows
              if r["seconds_per_request"] is not None and r["requests"]]
    mean_seconds = (
        sum(r["seconds_per_request"] * r["requests"] for r in priced)
        / sum(r["requests"] for r in priced)) if priced else None

    demand_rows: List[Dict[str, Any]] = []
    if mean_seconds is not None:
        for qps in qps_ladder:
            demand = _round(qps * mean_seconds)
            # Chips from the rounded demand, as the validator recomputes
            # them.
            demand_rows.append({
                "qps": float(qps),
                "device_seconds_per_sec": demand,
                "chips_needed": chips_needed(demand, utilization_ceiling),
            })

    slo = slo_doc.get("slo", {}) if isinstance(slo_doc, dict) else {}
    platform = (load_doc.get("config", {}) or {}).get("platform")
    return {
        "schema": CAPACITY_SCHEMA,
        "inputs": dict(inputs or {}),
        "bucket_table": table,
        "batch_sizes": sorted(int(b) for b in batch_sizes),
        "dtype": dtype,
        "utilization_ceiling": float(utilization_ceiling),
        "traffic": {
            "requests": total,
            "served_by_table": served,
            "unservable": unservable,
            "mean_device_seconds_per_request": (
                _round(mean_seconds) if mean_seconds is not None else None),
        },
        "per_bucket": bucket_rows,
        "demand": demand_rows,
        # The measured side: what the SLO and load evidence showed, on
        # which platform, and whether it may be enforced against the
        # plan (only a TPU's, the JAX package's rule).
        "measured_evidence": {
            "slo_p99_ms": slo.get("p99_ms"),
            "max_qps_under_slo": slo_doc.get("max_qps_under_slo"),
            "platform": platform if isinstance(platform, str) else "unknown",
            "comparable": platform == "tpu",
        },
    }


# ---------------------------------------------------------------- validate --


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_capacity(doc: Any, path: str = "<capacity>") -> List[str]:
    """Schema problems of a ``pvraft_capacity/v1`` artifact ([] =
    valid). The headline numbers are RECOMPUTED, not trusted: a
    hand-edited chips_needed that contradicts its own demand row (or a
    traffic fraction that exceeds 1) fails the gate."""
    if not isinstance(doc, dict):
        return [f"{path}: artifact is {type(doc).__name__}, not an object"]
    problems: List[str] = []
    if doc.get("schema") != CAPACITY_SCHEMA:
        problems.append(
            f"{path}: schema {doc.get('schema')!r} != {CAPACITY_SCHEMA!r}")
    for key in ("inputs", "bucket_table", "dtype", "utilization_ceiling",
                "traffic", "per_bucket", "demand", "measured_evidence"):
        if key not in doc:
            problems.append(f"{path}: missing field {key!r}")
    if problems:
        return problems
    ceiling = doc["utilization_ceiling"]
    if not _is_num(ceiling) or not 0 < ceiling <= 1:
        problems.append(
            f"{path}: utilization_ceiling {ceiling!r} must be in (0, 1]")
    if not isinstance(doc["per_bucket"], list) or not doc["per_bucket"]:
        problems.append(f"{path}: per_bucket must be a non-empty list")
        return problems
    frac_total = 0.0
    for i, row in enumerate(doc["per_bucket"]):
        where = f"{path}: per_bucket[{i}]"
        if not isinstance(row, dict):
            problems.append(f"{where}: not an object")
            continue
        for key in ("bucket", "requests", "traffic_fraction",
                    "seconds_per_request"):
            if key not in row:
                problems.append(f"{where}: missing {key!r}")
        spr = row.get("seconds_per_request")
        if spr is not None:
            if not _is_num(spr) or spr <= 0:
                problems.append(
                    f"{where}: seconds_per_request {spr!r} must be a "
                    "positive number or null")
            if "extrapolated" in row \
                    and not isinstance(row["extrapolated"], bool):
                problems.append(
                    f"{where}: extrapolated must be a bool — an "
                    "uncertified-geometry prediction must say so")
        if _is_num(row.get("traffic_fraction")):
            frac_total += row["traffic_fraction"]
    # Tolerance scales with the per-row rounding granularity: each
    # fraction is _round()ed to 6 significant figures (absolute error
    # up to 5e-7 for values <= 1), so an n-row plan can legitimately
    # sum to 1 + n * 5e-7.
    if frac_total > 1.0 + 5e-7 * len(doc["per_bucket"]):
        problems.append(
            f"{path}: traffic fractions sum to {frac_total:.7f} > 1")
    if not isinstance(doc["demand"], list):
        problems.append(f"{path}: demand must be a list")
        return problems
    for i, row in enumerate(doc["demand"]):
        where = f"{path}: demand[{i}]"
        if not isinstance(row, dict) or not all(
                _is_num(row.get(k)) for k in
                ("qps", "device_seconds_per_sec", "chips_needed")):
            problems.append(
                f"{where}: must carry numeric qps / "
                "device_seconds_per_sec / chips_needed")
            continue
        if _is_num(ceiling) and 0 < ceiling <= 1:
            want = chips_needed(row["device_seconds_per_sec"], ceiling)
            if row["chips_needed"] != want:
                problems.append(
                    f"{where}: chips_needed {row['chips_needed']} != "
                    f"ceil({row['device_seconds_per_sec']} / {ceiling}) "
                    f"= {want}")
    ev = doc["measured_evidence"]
    if not isinstance(ev, dict) \
            or not isinstance(ev.get("comparable"), bool):
        problems.append(
            f"{path}: measured_evidence.comparable must be a bool")
    elif ev["comparable"] and ev.get("platform") != "tpu":
        problems.append(
            f"{path}: measured_evidence.comparable=true on platform "
            f"{ev.get('platform')!r} — only TPU-measured evidence may "
            "be enforced against the plan (the pvraft_bench/v1 rule)")
    return problems


def validate_capacity_file(path: str) -> List[str]:
    from pvraft_tpu_torch.obs.loading import load_json_artifact

    doc, problems = load_json_artifact(path)
    if problems:
        return problems
    return validate_capacity(doc, path=path)
