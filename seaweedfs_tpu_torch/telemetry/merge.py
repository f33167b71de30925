"""Cross-node histogram merging -> true cluster-level percentiles.

Every daemon in the fleet runs the same metrics registry, so a given
histogram family has IDENTICAL bucket boundaries on every node — which
makes the merge exact: summing per-node cumulative bucket counts yields
precisely the histogram of the pooled observations (property-tested in
tests/test_telemetry.py over random shardings). Quantiles then come
from the standard Prometheus histogram_quantile interpolation: find
the bucket the target rank lands in and interpolate linearly inside
it (lower bound 0 for the first bucket; the +Inf bucket clamps to the
largest finite boundary, same as promql).

The port's copy of seaweedfs_tpu/telemetry/merge.py.
"""

from __future__ import annotations

import math

# one node's histogram state: sorted [(le, cumulative_count), ...]
Buckets = "list[tuple[float, float]]"


def merge_buckets(shards: "list[Buckets]") -> "Buckets":
    """Sum same-boundary cumulative bucket vectors across nodes.
    Boundaries must agree (they do fleet-wide by construction);
    a shard with unknown boundaries raises ValueError rather than
    silently skewing the pool."""
    acc: dict[float, float] = {}
    bounds: "set[tuple[float, ...]] | None" = None
    for shard in shards:
        b = tuple(le for le, _ in sorted(shard))
        if bounds is None:
            bounds = {b}
        elif b not in bounds:
            raise ValueError(
                f"bucket boundaries differ across nodes: {sorted(bounds)} "
                f"vs {b}")
        for le, c in shard:
            acc[le] = acc.get(le, 0.0) + c
    return sorted(acc.items())


def quantile(buckets: "Buckets", q: float) -> float:
    """histogram_quantile over sorted cumulative (le, count) buckets.
    Returns NaN for an empty histogram; the +Inf bucket clamps to the
    largest finite boundary (promql behavior)."""
    if not buckets:
        return math.nan
    buckets = sorted(buckets)
    total = buckets[-1][1]
    if total <= 0:
        return math.nan
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le, count in buckets:
        if count >= rank:
            if le == math.inf:
                # promql: quantile falls in +Inf -> highest finite bound
                finite = [b for b, _ in buckets if b != math.inf]
                return finite[-1] if finite else math.nan
            if count == prev_count:
                return le
            return prev_le + (le - prev_le) * (rank - prev_count) \
                / (count - prev_count)
        prev_le, prev_count = le, count
    finite = [b for b, _ in buckets if b != math.inf]
    return finite[-1] if finite else math.nan


def fraction_at_most(buckets: "Buckets", threshold: float) -> float:
    """Fraction of observations <= threshold, interpolating inside the
    bucket the threshold falls in (the latency-SLO "good" fraction).
    NaN for an empty histogram."""
    if not buckets:
        return math.nan
    buckets = sorted(buckets)
    total = buckets[-1][1]
    if total <= 0:
        return math.nan
    prev_le, prev_count = 0.0, 0.0
    for le, count in buckets:
        if threshold <= le or le == math.inf:
            if le == math.inf or count == prev_count:
                return prev_count / total if le == math.inf else \
                    count / total
            frac_in_bucket = (threshold - prev_le) / (le - prev_le)
            return (prev_count + (count - prev_count)
                    * max(0.0, min(1.0, frac_in_bucket))) / total
        prev_le, prev_count = le, count
    return 1.0


def summarize(buckets: "Buckets", sum_: "float | None" = None,
              qs: "tuple[float, ...]" = (0.5, 0.9, 0.99)) -> dict:
    """The /cluster/telemetry per-family rollup: count, optional mean,
    and the requested quantiles."""
    buckets = sorted(buckets)
    total = buckets[-1][1] if buckets else 0.0
    out: dict = {"count": total}
    if sum_ is not None and total > 0:
        out["mean"] = sum_ / total
    for q in qs:
        v = quantile(buckets, q)
        out[f"p{int(q * 100)}"] = None if math.isnan(v) else v
    return out
