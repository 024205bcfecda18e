"""The load generator and the ``pvraft_serve_load/v1`` artifact (port
of ``pvraft_tpu/serve/loadgen.py``).

:func:`run_load` drives a started ``ServeHTTPServer`` (or any
``host:port`` targets, a fleet router among them) with concurrent client
threads over real HTTP, the point counts cycling through the buckets,
and returns the measurement:

    {"requests": {"total", "ok", "rejected", "errors"},
     "latency_ms": {"p50", "p95", "p99", "mean", "max"},
     "throughput_rps", "duration_s",
     "per_request": [{"status", "ms", "n", "trace_id"[, "attempts"]}],
     "request_points": {"edges", "counts"},
     "server_metrics": {...the /metrics snapshot...}}

A caller adds ``schema``, ``config`` and ``compile`` to make the
artifact (``python -m pvraft_tpu_torch.serve loadgen``). The client
quantiles are nearest-rank over the raw samples
(``obs/slo.py::exact_quantile``); ``trace_id`` is the server's
``X-Pvraft-Trace`` header, which joins a request to its spans
(``obs/slo.py``). The payloads are drawn from ``host_rng(seed,
"serve.loadgen")`` as in the JAX package, so one seed drives the same
clouds through both; the retry backoff's jitter from
``"serve.retry_jitter"``, one stream per request.
:func:`validate_load_artifact` is the schema check (``python -m
pvraft_tpu_torch.serve validate-load``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pvraft_tpu_torch.rng import host_rng

SCHEMA_VERSION = "pvraft_serve_load/v1"
# The payloads' coordinate scale: pc1 uniform in [-1, 1]^3, the flow
# normal with standard deviation 0.05 (the JAX package's defaults).
COORD_SCALE = 1.0
# The first step of the retry ladder when a 503 names no Retry-After.
BACKOFF_MS = 50.0


def write_load_and_trace(out_path: str, artifact: Dict[str, Any],
                         events_path: str) -> Tuple[str, Dict[str, Any]]:
    """Validate and write one ``pvraft_serve_load/v1`` artifact and its
    ``pvraft_trace/v1`` sibling (``<out stem>.trace.json``, the span
    trees of the run's event stream). Returns ``(trace_path,
    trace_doc)``; raises SystemExit(1) on any schema problem (the caller
    is a CLI)."""
    import sys

    from pvraft_tpu_torch.obs.trace import (collect_traces,
                                             validate_trace_artifact)

    problems = validate_load_artifact(artifact, path=out_path)
    if problems:
        for p in problems:
            print(f"[loadgen] SCHEMA PROBLEM: {p}", file=sys.stderr)
        raise SystemExit(1)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=2)

    with open(events_path, "r", encoding="utf-8") as f:
        records = [json.loads(line) for line in f if line.strip()]
    trace_doc = collect_traces(records, source=events_path)
    trace_path = os.path.splitext(out_path)[0] + ".trace.json"
    trace_problems = validate_trace_artifact(trace_doc, path=trace_path)
    if trace_problems:
        for p in trace_problems:
            print(f"[loadgen] TRACE SCHEMA PROBLEM: {p}", file=sys.stderr)
        raise SystemExit(1)
    with open(trace_path, "w") as f:
        json.dump(trace_doc, f, indent=2)
    return trace_path, trace_doc

_REQUIRED = ("schema", "config", "compile", "requests", "latency_ms",
             "throughput_rps", "duration_s", "server_metrics")
_LAT_KEYS = ("p50", "p95", "p99", "mean", "max")


def validate_load_artifact(doc: Any,
                           path: str = "<artifact>") -> List[str]:
    """Schema problems of a load artifact ([] = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"{path}: artifact is {type(doc).__name__}, not an object"]
    if doc.get("schema") != SCHEMA_VERSION:
        problems.append(
            f"{path}: schema {doc.get('schema')!r} != {SCHEMA_VERSION!r}")
    for key in _REQUIRED:
        if key not in doc:
            problems.append(f"{path}: missing field {key!r}")
    reqs = doc.get("requests")
    if isinstance(reqs, dict):
        for key in ("total", "ok", "rejected", "errors"):
            if not isinstance(reqs.get(key), int):
                problems.append(
                    f"{path}: requests.{key} must be an int, "
                    f"got {reqs.get(key)!r}")
        if all(isinstance(reqs.get(k), int)
               for k in ("total", "ok", "rejected", "errors")):
            if reqs["ok"] + reqs["rejected"] + reqs["errors"] != reqs["total"]:
                problems.append(
                    f"{path}: requests ok+rejected+errors != total "
                    f"({reqs})")
    elif "requests" in doc:
        problems.append(f"{path}: requests must be an object")
    lat = doc.get("latency_ms")
    if isinstance(lat, dict):
        for key in _LAT_KEYS:
            v = lat.get(key)
            if v is not None and not isinstance(v, (int, float)):
                problems.append(
                    f"{path}: latency_ms.{key} must be a number or null, "
                    f"got {v!r}")
        order = [lat.get(k) for k in ("p50", "p95", "p99")]
        if all(isinstance(v, (int, float)) for v in order):
            if not (order[0] <= order[1] <= order[2]):
                problems.append(
                    f"{path}: latency quantiles must be non-decreasing, "
                    f"got p50={order[0]} p95={order[1]} p99={order[2]}")
    elif "latency_ms" in doc:
        problems.append(f"{path}: latency_ms must be an object")
    if not isinstance(doc.get("compile"), list):
        if "compile" in doc:
            problems.append(f"{path}: compile must be a list")
    for key in ("throughput_rps", "duration_s"):
        if key in doc and not isinstance(doc[key], (int, float)):
            problems.append(f"{path}: {key} must be a number")
    # Additive trace-plane fields (absent in pre-trace artifacts).
    if "per_request" in doc:
        if not isinstance(doc["per_request"], list):
            problems.append(f"{path}: per_request must be a list")
        else:
            for i, r in enumerate(doc["per_request"]):
                if not isinstance(r, dict) or not isinstance(
                        r.get("status"), int):
                    problems.append(
                        f"{path}: per_request[{i}] must carry an int "
                        f"status")
                elif r.get("trace_id") is not None and not isinstance(
                        r["trace_id"], str):
                    problems.append(
                        f"{path}: per_request[{i}].trace_id must be a "
                        f"string or null")
                elif "attempts" in r:
                    # Client-retry evidence (--retries): every attempt's
                    # status/ms, final attempt == the entry's own status.
                    atts = r["attempts"]
                    if (not isinstance(atts, list) or len(atts) < 2
                            or not all(isinstance(a, dict)
                                       and isinstance(a.get("status"), int)
                                       for a in atts)):
                        problems.append(
                            f"{path}: per_request[{i}].attempts must be "
                            f">= 2 objects each carrying an int status")
                    elif atts[-1]["status"] != r["status"]:
                        problems.append(
                            f"{path}: per_request[{i}] status "
                            f"{r['status']} != final attempt status "
                            f"{atts[-1]['status']}")
            if isinstance(reqs, dict) and isinstance(
                    reqs.get("total"), int) and len(
                    doc["per_request"]) != reqs["total"]:
                problems.append(
                    f"{path}: per_request has {len(doc['per_request'])} "
                    f"entries, requests.total is {reqs['total']}")
    # Additive multi-target field (fleet evidence): when the run
    # round-robined several endpoints, config.targets records them.
    cfg = doc.get("config")
    if isinstance(cfg, dict) and "targets" in cfg:
        tg = cfg["targets"]
        if (not isinstance(tg, list) or not tg
                or not all(isinstance(t, str) and t for t in tg)):
            problems.append(
                f"{path}: config.targets must be a non-empty list of "
                f"'host:port' strings")
    if "request_points" in doc:
        rp = doc["request_points"]
        if (not isinstance(rp, dict)
                or not isinstance(rp.get("edges"), list)
                or not isinstance(rp.get("counts"), list)
                or len(rp.get("counts", [])) !=
                len(rp.get("edges", [])) + 1):
            problems.append(
                f"{path}: request_points must carry edges + counts with "
                f"len(counts) == len(edges) + 1")
    return problems


def validate_load_artifact_file(path: str) -> List[str]:
    from pvraft_tpu_torch.obs.loading import load_json_artifact

    doc, problems = load_json_artifact(path)
    if problems:
        return problems
    return validate_load_artifact(doc, path=path)


def merge_measurements(rounds: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold several :func:`run_load` measurements of one server (or one
    router) into a single artifact-shaped measurement. Latency quantiles
    are recomputed from the concatenated per-request samples (exact,
    same estimator); ``server_metrics`` is the LAST round's snapshot
    (the server's counters are cumulative across its rounds)."""
    if not rounds:
        raise ValueError("no measurements to merge")
    from pvraft_tpu_torch.obs.slo import exact_quantile

    per_request = [r for m in rounds for r in m["per_request"]]
    lat = sorted(r["ms"] for r in per_request
                 if r["status"] == 200 and r["ms"] is not None)
    duration = sum(m["duration_s"] for m in rounds)
    requests = {
        key: sum(m["requests"][key] for m in rounds)
        for key in ("total", "ok", "rejected", "errors")}
    edges = rounds[0]["request_points"]["edges"]
    counts = [0] * len(rounds[0]["request_points"]["counts"])
    for m in rounds:
        if m["request_points"]["edges"] != edges:
            raise ValueError("rounds use different histogram edges")
        counts = [a + b for a, b in
                  zip(counts, m["request_points"]["counts"])]

    def pct(q: float) -> Optional[float]:
        v = exact_quantile(lat, q)
        return None if v is None else round(v, 3)

    return {
        "requests": requests,
        "latency_ms": {
            "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99),
            "mean": (round(sum(lat) / len(lat), 3) if lat else None),
            "max": round(lat[-1], 3) if lat else None,
        },
        "throughput_rps": (round(requests["ok"] / duration, 3)
                           if duration else 0.0),
        "duration_s": round(duration, 3),
        "per_request": per_request,
        "request_points": {"edges": edges, "counts": counts},
        "server_metrics": rounds[-1]["server_metrics"],
    }


def _post_json(host: str, port: int, path: str, doc: Dict[str, Any],
               timeout: float = 120.0) -> Dict[str, Any]:
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(doc).encode("utf-8"),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        retry_after = resp.getheader("Retry-After")
        try:
            # The serve stack always sends integer seconds; a foreign
            # proxy could legally send an HTTP-date — treat that as
            # "no hint" rather than crash the client thread.
            retry_after = (float(retry_after)
                           if retry_after is not None else None)
        except ValueError:
            retry_after = None
        return {"status": resp.status, "body": json.loads(body),
                "trace_id": resp.getheader("X-Pvraft-Trace"),
                "retry_after": retry_after}
    finally:
        conn.close()


def _get_json(host: str, port: int, path: str,
              timeout: float = 30.0) -> Dict[str, Any]:
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return json.loads(resp.read())
    finally:
        conn.close()


def _endpoints(server, targets) -> List[Tuple[str, int]]:
    """Resolve the endpoint list a load run round-robins over: the
    in-process ``server`` and/or
    ``targets`` — "host:port" strings, (host, port) tuples, or objects
    with ``host``/``port`` (e.g. another started server)."""
    eps: List[Tuple[str, int]] = []
    if server is not None:
        eps.append((server.host, int(server.port)))
    for t in targets or ():
        if isinstance(t, str):
            host, _, port = t.rpartition(":")
            host = host or "127.0.0.1"
            # Accept URL spellings ("http://h:p/") without pulling in a
            # URL parser: strip scheme prefix and trailing slash.
            if host.startswith(("http://", "https://")):
                host = host.split("://", 1)[1]
            eps.append((host, int(port.rstrip("/"))))
        elif isinstance(t, (tuple, list)):
            eps.append((str(t[0]), int(t[1])))
        else:
            eps.append((t.host, int(t.port)))
    if not eps:
        raise ValueError("run_load needs a server or at least one target")
    return eps


def run_load(
    server=None,                  # a started ServeHTTPServer (or None)
    n_requests: int = 0,
    concurrency: int = 1,
    point_counts: Optional[List[int]] = None,
    seed: int = 0,
    retries: int = 0,
    targets: Optional[List[Any]] = None,
) -> Dict[str, Any]:
    """Send ``n_requests`` over ``concurrency`` client threads against a
    running server; returns the raw measurement dict (no schema fields).
    Point counts cycle through ``point_counts`` so every bucket is hit.

    ``retries`` (default 0) bounds client-side re-attempts of 503
    responses:
    each retry backs off by the server's ``Retry-After`` when present
    (else an exponential ladder from ``BACKOFF_MS``), jittered 0.5-1.5x with
    a per-request deterministic RNG so two shed clients don't re-arrive
    in lockstep. Every attempt is recorded: a retried request's
    ``per_request`` entry carries an ``attempts`` list (schema-additive)
    and its top-level status/ms are the FINAL attempt's — a request that
    eventually succeeds counts ``ok``.

    ``targets``: additional or alternative endpoints; requests round-robin across the full endpoint list by
    request index, and a retried request rotates to the NEXT endpoint
    (a shed client fails over instead of hammering the host that shed
    it). With several endpoints ``server_metrics`` becomes
    ``{"targets": [{"target": "host:port", ...snapshot...}, ...]}`` —
    schema-additive, the single-target shape is unchanged."""
    eps = _endpoints(server, targets)
    point_counts = point_counts or []
    rng = host_rng(seed, "serve.loadgen")
    # Pre-generate the request payloads so client threads measure the
    # server, not numpy.
    payloads = []
    sizes = []          # recorded at build time: per_request[].n and the
    for i in range(n_requests):  # size histogram report what was DRIVEN
        n = point_counts[i % len(point_counts)]
        pc1 = rng.uniform(-COORD_SCALE, COORD_SCALE,
                          (n, 3)).astype(np.float32)
        flow = rng.normal(0, 0.05 * COORD_SCALE, (n, 3)).astype(np.float32)
        payloads.append({"pc1": pc1.tolist(), "pc2": (pc1 + flow).tolist()})
        sizes.append(n)

    results: List[Dict[str, Any]] = [None] * n_requests  # type: ignore
    cursor = {"i": 0}
    cursor_lock = threading.Lock()

    def client():
        while True:
            with cursor_lock:
                i = cursor["i"]
                if i >= n_requests:
                    return
                cursor["i"] = i + 1
            jitter = host_rng(seed, "serve.retry_jitter", i)
            attempts: List[Dict[str, Any]] = []
            for attempt in range(retries + 1):
                t0 = time.monotonic()
                retry_after = None
                host, port = eps[(i + attempt) % len(eps)]
                try:
                    r = _post_json(host, port, "/predict",
                                   payloads[i])
                    ms = (time.monotonic() - t0) * 1000.0
                    retry_after = r.get("retry_after")
                    attempts.append({"status": r["status"],
                                     "ms": round(ms, 3)})
                    result = {"status": r["status"], "ms": ms,
                              "trace_id": r["trace_id"]}
                except Exception as e:  # noqa: BLE001 — a client error is data
                    attempts.append({"status": -1, "ms": None})
                    result = {"status": -1, "ms": None, "trace_id": None,
                              "error": f"{type(e).__name__}: {e}"}
                if result["status"] != 503 or attempt == retries:
                    break
                # Bounded retry of explicit backpressure only (503):
                # honor Retry-After when the server derives one from its
                # probe cadence, else the exponential ladder; jittered
                # so shed clients spread out, capped so a chaos run's
                # wall clock stays bounded.
                base = (retry_after if retry_after is not None
                        else (BACKOFF_MS / 1000.0) * (2 ** attempt))
                time.sleep(min(base, 5.0) * (0.5 + jitter.random()))
            if len(attempts) > 1:
                result["attempts"] = attempts
            results[i] = result

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(concurrency)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    duration = time.monotonic() - t_start

    ok = [r for r in results if r["status"] == 200]
    rejected = [r for r in results if r["status"] in (400, 413, 503, 504)]
    # Everything else (transport failures recorded as -1, but also any
    # unexpected status such as a 500) counts as an error so the
    # ok+rejected+errors == total schema invariant holds by construction.
    errors = [r for r in results
              if r["status"] not in (200, 400, 413, 503, 504)]
    lat = sorted(r["ms"] for r in ok)

    # The SAME nearest-rank estimator the SLO report uses (its join
    # reconciles client quantiles against span quantiles — reuse, not a
    # parallel implementation that could drift).
    from pvraft_tpu_torch.obs.slo import exact_quantile

    def pct(q: float) -> Optional[float]:
        v = exact_quantile(lat, q)
        return None if v is None else round(v, 3)

    # Client-side request-size histogram on the server's exposed edges
    # (pvraft_serve_request_points): the artifact records what sizes
    # were DRIVEN, the server's histogram what it SAW — the pair must
    # reconcile (same histogram class, same bucketing rule), and either
    # seeds adaptive bucket geometry offline.
    from pvraft_tpu_torch.serve.metrics import POINT_EDGES, LatencyHistogram

    size_hist = LatencyHistogram(edges=POINT_EDGES)
    for n in sizes:
        size_hist.observe(float(n))

    return {
        "requests": {"total": n_requests, "ok": len(ok),
                     "rejected": len(rejected), "errors": len(errors)},
        "latency_ms": {
            "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99),
            "mean": round(float(np.mean(lat)), 3) if lat else None,
            "max": round(lat[-1], 3) if lat else None,
        },
        "throughput_rps": round(len(ok) / duration, 3) if duration else 0.0,
        "duration_s": round(duration, 3),
        "per_request": [
            {"status": r["status"],
             "ms": round(r["ms"], 3) if r["ms"] is not None else None,
             "n": sizes[i],
             "trace_id": r.get("trace_id"),
             # Per-attempt record of retried requests (absent when the
             # request went through in one attempt — schema-additive).
             **({"attempts": r["attempts"]} if "attempts" in r else {})}
            for i, r in enumerate(results)],
        "request_points": {"edges": [int(e) for e in POINT_EDGES],
                           "counts": list(size_hist.counts)},
        "server_metrics": (
            _get_json(*eps[0], "/metrics") if len(eps) == 1 else
            {"targets": [
                {"target": f"{h}:{p}", **_get_json(h, p, "/metrics")}
                for h, p in eps]}),
    }
