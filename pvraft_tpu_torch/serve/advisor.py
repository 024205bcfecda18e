"""Bucket-geometry advisor: a bucket table proposed from the traffic
(port of ``pvraft_tpu/serve/advisor.py``).

Every request pads up to its bucket, so a bucket far above the typical
request burns device work on padding, and every extra bucket is another
captured program per batch size. The request-size histogram
(``pvraft_serve_request_points`` on the server, ``request_points`` in a
load artifact) says what sizes arrive:

* a request in bin *i* is only known to be ``<= edges[i]``, so the
  candidate buckets are the non-empty bins' upper edges;
* choosing ``n_buckets`` of them to minimize the expected cost per
  request is a contiguous-partition DP, exact in O(bins^2 * n_buckets);
* the cost is predicted device-seconds when a
  :class:`~pvraft_tpu_torch.programs.costs.CostSurface` prices every
  candidate bucket and the current table, else expected device points,
  with ``objective.note`` naming the buckets it could not price;
* the current table is scored on the same histogram, with the share of
  the traffic it rejects.

The proposal is advice: nothing here changes the engine's buckets.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

ADVISOR_SCHEMA = "pvraft_bucket_advisor/v1"


def _bins(edges: Sequence[float],
          counts: Sequence[int]) -> List[Tuple[int, int]]:
    """Non-empty (upper_edge, count) bins, ascending. The overflow bin
    (counts[-1], sizes beyond the last edge) has no upper edge and is
    reported separately — no bucket table derived from this histogram
    can serve it."""
    if len(counts) != len(edges) + 1:
        raise ValueError(
            f"histogram shape mismatch: {len(counts)} counts for "
            f"{len(edges)} edges (want len(edges) + 1)")
    return [(int(edges[i]), int(c))
            for i, c in enumerate(counts[:-1]) if c]


def _cost_keys(bucket_cost: Optional[Dict[int, float]]
               ) -> Tuple[str, str, int]:
    """(per-request key, ideal key, rounding digits) for the active
    objective: device points, or predicted device-seconds when a cost
    table is supplied."""
    if bucket_cost is None:
        return "points_per_request", "ideal_points_per_request", 2
    return ("device_seconds_per_request",
            "ideal_device_seconds_per_request", 6)


def propose_buckets(edges: Sequence[float], counts: Sequence[int],
                    n_buckets: int,
                    min_bucket: int = 0,
                    bucket_cost: Optional[Dict[int, float]] = None
                    ) -> Dict[str, Any]:
    """The optimal ``n_buckets``-entry bucket table for this histogram
    (exact DP). The objective is expected device POINTS per request by
    default; ``bucket_cost`` (candidate bucket -> predicted
    device-seconds one request costs there, from
    ``CostSurface.serve_seconds_per_request``) swaps it to expected
    device-SECONDS — it must cover every candidate value, which the
    caller guarantees (``build_advisor_report`` falls back to points
    otherwise). Buckets below ``min_bucket`` (the engine's
    ``min_points`` floor or a hardware tile constraint) are disallowed;
    bins below it are served by the smallest legal bucket."""
    if n_buckets < 1:
        raise ValueError("n_buckets must be >= 1")
    bins = _bins(edges, counts)
    overflow = int(counts[-1])
    if not bins:
        raise ValueError("histogram has no in-range samples")
    # Respect the floor: candidate bucket values below min_bucket are
    # illegal, so merge their bins into the first legal candidate.
    candidates = sorted({max(edge, min_bucket) for edge, _ in bins})
    weight = {c: 0 for c in candidates}
    for edge, count in bins:
        weight[max(edge, min_bucket)] += count
    values = candidates
    if bucket_cost is not None:
        missing = [v for v in values if v not in bucket_cost]
        if missing:
            raise ValueError(
                f"bucket_cost does not cover candidate buckets "
                f"{missing} — fall back to the device-points objective "
                "instead of pricing uncertified geometry")
    w = [weight[v] for v in values]
    n = len(values)
    k_max = min(n_buckets, n)
    # dp[k][i]: min cost serving bins[0..i] with k buckets, the last
    # bucket being values[i] (a bucket table must include the largest
    # non-empty candidate or it rejects observed traffic).
    inf = float("inf")
    # prefix weights for O(1) range sums
    prefix = [0]
    for x in w:
        prefix.append(prefix[-1] + x)

    def unit_cost(v: int) -> float:
        return float(v) if bucket_cost is None else float(bucket_cost[v])

    def seg(j: int, i: int) -> float:
        """Cost of bins j..i all served by values[i]."""
        return (prefix[i + 1] - prefix[j]) * unit_cost(values[i])

    dp = [[inf] * n for _ in range(k_max + 1)]
    choice = [[-1] * n for _ in range(k_max + 1)]
    for i in range(n):
        dp[1][i] = seg(0, i)
    for k in range(2, k_max + 1):
        for i in range(k - 1, n):
            for j in range(k - 2, i):
                cost = dp[k - 1][j] + seg(j + 1, i)
                if cost < dp[k][i]:
                    dp[k][i] = cost
                    choice[k][i] = j
    best_k = min(k_max, n)
    cost = dp[best_k][n - 1]
    # Walk the choices back into the bucket list.
    buckets: List[int] = []
    k, i = best_k, n - 1
    while k >= 1 and i >= 0:
        buckets.append(values[i])
        i = choice[k][i]
        k -= 1
    buckets.reverse()
    total = sum(w)
    ideal = sum(cw * unit_cost(v)                    # one bucket per bin
                for v, cw in zip(values, w))
    per_key, ideal_key, digits = _cost_keys(bucket_cost)
    return {
        "buckets": buckets,
        per_key: round(cost / total, digits),
        ideal_key: round(ideal / total, digits),
        "overhead_vs_ideal": round(cost / ideal - 1.0, 4) if ideal else None,
        "requests": total,
        "overflow_requests": overflow,
    }


def score_buckets(buckets: Sequence[int], edges: Sequence[float],
                  counts: Sequence[int],
                  bucket_cost: Optional[Dict[int, float]] = None
                  ) -> Dict[str, Any]:
    """Expected cost per request of an EXISTING bucket table on this
    histogram (same objective switch as :func:`propose_buckets` —
    device points, or device-seconds when ``bucket_cost`` covers the
    table), plus the fraction of observed traffic it rejects (bins
    whose upper edge exceeds the largest bucket, and the overflow
    bin)."""
    bins = _bins(edges, counts)
    overflow = int(counts[-1])
    table = sorted(buckets)
    if bucket_cost is not None:
        missing = [b for b in table if int(b) not in bucket_cost]
        if missing:
            raise ValueError(
                f"bucket_cost does not cover table buckets {missing}")
    served_cost = 0.0
    served = rejected = 0
    per_bucket = {int(b): 0 for b in table}
    for edge, count in bins:
        bucket = next((b for b in table if edge <= b), None)
        if bucket is None:
            rejected += count
            continue
        served += count
        served_cost += count * (float(bucket) if bucket_cost is None
                                else float(bucket_cost[int(bucket)]))
        per_bucket[bucket] += count
    rejected += overflow
    total = served + rejected
    per_key, _, digits = _cost_keys(bucket_cost)
    return {
        "buckets": [int(b) for b in table],
        per_key: (round(served_cost / served, digits)
                  if served else None),
        "requests": total,
        "served_requests": served,
        "rejected_requests": rejected,
        "rejected_fraction": round(rejected / total, 4) if total else None,
        "per_bucket_requests": per_bucket,
    }


def candidate_buckets(edges: Sequence[float], counts: Sequence[int],
                      min_bucket: int = 0) -> List[int]:
    """The candidate bucket values :func:`propose_buckets` will choose
    from (non-empty bins' upper edges, min_bucket-folded) — exposed so
    the cost-surface coverage check and the DP agree on the exact set."""
    return sorted({max(edge, min_bucket)
                   for edge, _ in _bins(edges, counts)})


def build_advisor_report(edges: Sequence[float], counts: Sequence[int],
                         current_buckets: Sequence[int],
                         n_buckets: Optional[int] = None,
                         min_bucket: int = 0,
                         source: str = "<histogram>",
                         cost_surface=None,
                         dtype: str = "bfloat16") -> Dict[str, Any]:
    """The full advisory: proposed table (same size as the current one
    unless ``n_buckets`` overrides), current-table score, and the
    improvement — all from one histogram.

    ``cost_surface`` (a :class:`~pvraft_tpu_torch.programs.costs.
    CostSurface`) makes the objective predicted device-seconds when its
    serve records cover every candidate bucket and the current table
    exactly; otherwise the report scores device points, and
    ``objective.note`` names the buckets without a record."""
    k = n_buckets or len(current_buckets)
    bucket_cost = None
    objective: Dict[str, Any] = {"unit": "device_points"}
    if cost_surface is not None:
        need = sorted(set(candidate_buckets(edges, counts, min_bucket))
                      | {int(b) for b in current_buckets})
        costs = {b: cost_surface.serve_seconds_per_request(b, dtype)
                 for b in need}
        uncovered = sorted(b for b, c in costs.items() if c is None)
        if uncovered:
            objective["note"] = (
                f"cost surface has no certified serve record for "
                f"buckets {uncovered} (dtype {dtype}) — scoring in "
                "expected device points instead of predicted "
                "device-seconds")
        else:
            bucket_cost = costs
            objective = {"unit": "device_seconds", "dtype": dtype,
                         "surface": getattr(cost_surface, "path", None)}
    per_key, _, _ = _cost_keys(bucket_cost)
    proposed = propose_buckets(edges, counts, k, min_bucket=min_bucket,
                               bucket_cost=bucket_cost)
    current = score_buckets(current_buckets, edges, counts,
                            bucket_cost=bucket_cost)
    improvement = None
    if current[per_key] and current["served_requests"]:
        # Compare on the SAME population: the proposed table serves all
        # in-range traffic while the current one may reject part of it,
        # and per-request costs over different populations are not
        # comparable (a more-capable table would look like a regression
        # because it serves the big requests the current table bounces).
        # Re-score the proposal on exactly the bins the current table
        # serves; the extra traffic the proposal unlocks is reported as
        # the rejected fraction next to it, not folded into the cost.
        largest_current = max(current_buckets)
        served_counts = [
            c if i < len(edges) and edges[i] <= largest_current else 0
            for i, c in enumerate(counts)]
        proposed_on_served = score_buckets(
            proposed["buckets"], edges, served_counts,
            bucket_cost=bucket_cost)
        saved = current[per_key] - proposed_on_served[per_key]
        _, _, digits = _cost_keys(bucket_cost)
        improvement = {
            f"{per_key}_saved": round(saved, digits),
            "relative": round(saved / current[per_key], 4),
            "population": "traffic served by the current table",
        }
    return {
        "schema": ADVISOR_SCHEMA,
        "source": source,
        "histogram": {"edges": [int(e) for e in edges],
                      "counts": [int(c) for c in counts]},
        "min_bucket": int(min_bucket),
        "objective": objective,
        "proposed": proposed,
        "current": current,
        "improvement": improvement,
    }
