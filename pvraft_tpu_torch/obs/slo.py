"""SLO evidence: a load run joined with its span records into a
``pvraft_slo/v1`` report (port of ``pvraft_tpu/obs/slo.py``).

The load artifact (``serve/loadgen.py``) gives each request's client
latency and the server's trace id (its ``X-Pvraft-Trace`` header); the
event stream gives each traced request's span tree (``obs/trace.py``).
Joined by trace id, they give per (bucket, batch, dtype) program the
stage quantiles, the end-to-end quantiles and ``stage_sum_ratio`` (the
sum of the stages' p99s over the end-to-end p99: near 1 when the stages
account for the tail), and per run whether the client p99 meets the SLO,
with ``max_qps_under_slo`` the best throughput of a run that does.
``(bucket, batch)`` come from the ``device_execute`` span's attributes,
``dtype`` from the load artifact's config. Quantiles are nearest-rank
over the raw samples (:func:`exact_quantile`, the load generator's
estimator too).

:func:`validate_slo_report` is the schema check (``python -m
pvraft_tpu_torch.obs validate-slo``); it recomputes
``max_qps_under_slo`` from the runs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from pvraft_tpu_torch.obs.trace import SERVE_STAGES, trace_shape

SLO_SCHEMA = "pvraft_slo/v1"

_STAT_KEYS = ("count", "mean_ms", "p50_ms", "p95_ms", "p99_ms")


def exact_quantile(samples: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank quantile over raw samples (None when empty) — the
    same estimator the loadgen client uses, so the two agree."""
    if not samples:
        return None
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def _stats(samples: List[float]) -> Dict[str, Any]:
    return {
        "count": len(samples),
        "mean_ms": (round(sum(samples) / len(samples), 3)
                    if samples else None),
        "p50_ms": _r(exact_quantile(samples, 0.50)),
        "p95_ms": _r(exact_quantile(samples, 0.95)),
        "p99_ms": _r(exact_quantile(samples, 0.99)),
    }


def _r(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 3)


def _index_traces(records: Sequence[Dict[str, Any]]
                  ) -> Dict[str, List[Dict[str, Any]]]:
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for rec in records:
        if rec.get("type") == "span":
            by_trace.setdefault(rec["trace_id"], []).append(rec)
    return by_trace


def build_slo_report(
    sources: Sequence[Tuple[str, Dict[str, Any], str,
                            Sequence[Dict[str, Any]]]],
    slo_p99_ms: float,
    ratio_band: Tuple[float, float] = (0.9, 1.1),
) -> Dict[str, Any]:
    """Build the report from ``(load_path, load_doc, events_path,
    event_records)`` tuples — one per loadgen run. Requests join to
    traces via the artifact's ``per_request[].trace_id`` (recorded from
    the server's ``X-Pvraft-Trace`` response header)."""
    totals = {"requests": 0, "ok": 0, "traced_ok": 0, "complete": 0,
              "orphan_spans": 0}
    # (bucket, batch, dtype) -> {"stages": {stage: [ms]}, "e2e": [ms]}
    programs: Dict[Tuple[int, int, str], Dict[str, Any]] = {}
    runs: List[Dict[str, Any]] = []

    for load_path, load_doc, events_path, records in sources:
        by_trace = _index_traces(records)
        dtype = (load_doc.get("config", {}) or {}).get(
            "compute_dtype", "float32")
        per_request = load_doc.get("per_request", [])
        totals["requests"] += load_doc.get("requests", {}).get(
            "total", len(per_request))
        ok_ms: List[float] = []
        for req in per_request:
            if req.get("status") != 200:
                continue
            totals["ok"] += 1
            if req.get("ms") is not None:
                ok_ms.append(req["ms"])
            spans = by_trace.get(req.get("trace_id") or "")
            if not spans:
                continue
            totals["traced_ok"] += 1
            # One completeness definition, shared with the trace
            # documents and their validator (obs.trace.trace_shape).
            roots, orphans, stages, complete = trace_shape(
                spans, SERVE_STAGES)
            totals["orphan_spans"] += len(orphans)
            totals["complete"] += complete
            if len(roots) != 1:
                continue
            exec_span = next(
                (s for s in spans if s["name"] == "device_execute"), None)
            attrs = (exec_span or {}).get("attrs", {})
            if "bucket" not in attrs or "batch" not in attrs:
                continue
            key = (int(attrs["bucket"]), int(attrs["batch"]), dtype)
            slot = programs.setdefault(
                key, {"stages": {s: [] for s in SERVE_STAGES}, "e2e": []})
            slot["e2e"].append(roots[0]["end_ms"] - roots[0]["start_ms"])
            for stage, dur in stages.items():
                if stage in slot["stages"]:
                    slot["stages"][stage].append(dur)
        client_p99 = _r(exact_quantile(ok_ms, 0.99))
        meets = client_p99 is not None and client_p99 <= slo_p99_ms
        runs.append({
            "load": load_path,
            "events": events_path,
            "throughput_rps": load_doc.get("throughput_rps"),
            "client_p99_ms": client_p99,
            "meets_slo": meets,
        })

    program_rows = []
    for (bucket, batch, dtype), slot in sorted(programs.items()):
        e2e = _stats(slot["e2e"])
        stage_stats = {s: _stats(ms) for s, ms in slot["stages"].items()}
        p99s = [st["p99_ms"] for st in stage_stats.values()
                if st["p99_ms"] is not None]
        stage_p99_sum = round(sum(p99s), 3) if p99s else None
        ratio = (round(stage_p99_sum / e2e["p99_ms"], 4)
                 if stage_p99_sum is not None and e2e["p99_ms"] else None)
        program_rows.append({
            "bucket": bucket, "batch": batch, "dtype": dtype,
            "requests": e2e["count"],
            "stages": stage_stats,
            "e2e": e2e,
            "stage_p99_sum_ms": stage_p99_sum,
            "stage_sum_ratio": ratio,
            "meets_slo": (e2e["p99_ms"] is not None
                          and e2e["p99_ms"] <= slo_p99_ms),
        })

    qualifying = [r["throughput_rps"] for r in runs
                  if r["meets_slo"] and r["throughput_rps"] is not None]
    return {
        "schema": SLO_SCHEMA,
        # ratio_band: the stage-sum bar this report is held to. [0.9, 1.1]
        # is the serialized-client bar; concurrency > 1 widens it
        # (independent scheduler stalls land in different stages' p99s).
        "slo": {"p99_ms": slo_p99_ms,
                "ratio_band": [ratio_band[0], ratio_band[1]]},
        "sources": [{"load": p, "events": e}
                    for p, _, e, _ in sources],
        "totals": totals,
        "programs": program_rows,
        "runs": runs,
        "max_qps_under_slo": max(qualifying) if qualifying else None,
    }


def validate_slo_report(doc: Any, path: str = "<report>") -> List[str]:
    """Schema problems of a ``pvraft_slo/v1`` report ([] = valid)."""
    if not isinstance(doc, dict):
        return [f"{path}: report is {type(doc).__name__}, not an object"]
    problems: List[str] = []
    if doc.get("schema") != SLO_SCHEMA:
        problems.append(
            f"{path}: schema {doc.get('schema')!r} != {SLO_SCHEMA!r}")
    for key in ("slo", "sources", "totals", "programs", "runs",
                "max_qps_under_slo"):
        if key not in doc:
            problems.append(f"{path}: missing field {key!r}")
    if problems:
        return problems
    if not isinstance(doc["slo"], dict) or not isinstance(
            doc["slo"].get("p99_ms"), (int, float)):
        problems.append(f"{path}: slo.p99_ms must be a number")
    # Malformed containers are reported problems, not tracebacks.
    for key, want in (("totals", dict), ("programs", list),
                      ("runs", list)):
        if not isinstance(doc[key], want):
            problems.append(
                f"{path}: {key} must be a {want.__name__}")
    if problems:
        return problems
    totals = doc["totals"]
    for key in ("requests", "ok", "traced_ok", "complete", "orphan_spans"):
        if not isinstance(totals.get(key), int):
            problems.append(f"{path}: totals.{key} must be an int")
    if isinstance(totals.get("traced_ok"), int) and isinstance(
            totals.get("complete"), int):
        if totals["complete"] > totals["traced_ok"]:
            problems.append(
                f"{path}: totals.complete {totals['complete']} > "
                f"traced_ok {totals['traced_ok']}")
    for i, row in enumerate(doc["programs"]):
        where = f"{path}: programs[{i}]"
        if not isinstance(row, dict):
            problems.append(f"{where}: not an object")
            continue
        for key in ("bucket", "batch", "dtype", "requests", "stages",
                    "e2e", "stage_p99_sum_ms", "stage_sum_ratio",
                    "meets_slo"):
            if key not in row:
                problems.append(f"{where}: missing {key!r}")
        stages = row.get("stages")
        if isinstance(stages, dict):
            missing = set(SERVE_STAGES) - set(stages)
            if missing:
                problems.append(
                    f"{where}: stages missing {sorted(missing)}")
            for stage, st in stages.items():
                if not isinstance(st, dict) or set(_STAT_KEYS) - set(st):
                    problems.append(
                        f"{where}: stages.{stage} must carry {_STAT_KEYS}")
        for block in ("e2e",):
            st = row.get(block)
            if isinstance(st, dict):
                order = [st.get(k) for k in ("p50_ms", "p95_ms", "p99_ms")]
                if all(isinstance(v, (int, float)) for v in order):
                    if not (order[0] <= order[1] <= order[2]):
                        problems.append(
                            f"{where}: {block} quantiles must be "
                            f"non-decreasing, got {order}")
    for i, run in enumerate(doc["runs"]):
        if not isinstance(run, dict) or "load" not in run or (
                "meets_slo" not in run):
            problems.append(
                f"{path}: runs[{i}] must carry load + meets_slo")
    mq = doc["max_qps_under_slo"]
    if mq is not None and not isinstance(mq, (int, float)):
        problems.append(
            f"{path}: max_qps_under_slo must be a number or null")
    # The headline number is recomputed, not trusted: it must equal the
    # max throughput among SLO-compliant runs (null when none qualifies)
    # — a hand-edited committed report cannot claim a QPS its runs never
    # delivered.
    qualifying = [r["throughput_rps"] for r in doc["runs"]
                  if isinstance(r, dict) and r.get("meets_slo")
                  and isinstance(r.get("throughput_rps"), (int, float))]
    want_mq = max(qualifying) if qualifying else None
    if (mq is None) != (want_mq is None) or (
            isinstance(mq, (int, float)) and want_mq is not None
            and abs(mq - want_mq) > 1e-9):
        problems.append(
            f"{path}: max_qps_under_slo={mq} but the qualifying runs "
            f"support {want_mq}")
    return problems


def validate_slo_report_file(path: str) -> List[str]:
    from pvraft_tpu_torch.obs.loading import load_json_artifact

    doc, problems = load_json_artifact(path)
    if problems:
        return problems
    return validate_slo_report(doc, path=path)
