"""Exposition lint + registry lint, on top of the shared parser.

The port's copy of seaweedfs_tpu/stats/expo_lint.py. Two consumers:
  * the tests parse `REGISTRY.gather()` through `check_exposition` so a
    malformed family (missing TYPE, unsorted `le`, broken label
    escaping) fails CI instead of a scrape;
  * run standalone
    (`python -m seaweedfs_tpu_torch.stats.expo_lint`), it also lints the
    registry itself: duplicate metric names and a label-cardinality
    ceiling on the unbounded-by-construction labels (`peer`, `bucket`)
    that would otherwise grow a label set per address / per S3 bucket.

The exposition *grammar* lives in stats/parse.py (one parser shared
with the fleet telemetry scraper); this module keeps the semantic
rules layered on top: histograms must have ascending `le` ending at
+Inf with monotone cumulative counts and `_sum`/`_count` series, and
the registry's bounded label families must stay under their ceilings.
"""

from __future__ import annotations

import math
import sys

from .parse import Family, ParseError, histogram_series, parse_exposition

# Backwards-compatible name: the lint's callers catch ExpositionError;
# grammar violations now surface from the shared parser.
ExpositionError = ParseError


def check_exposition(text: str) -> list[str]:
    """Validate one exposition; returns the family names seen (those
    with samples), raising ExpositionError on the first grammar or
    histogram-shape violation."""
    families = parse_exposition(text)
    for family in families.values():
        if family.kind == "histogram":
            _check_histogram(family)
    return sorted(f.name for f in families.values() if f.samples)


def _check_histogram(family: Family) -> None:
    for key, ent in histogram_series(family).items():
        les = ent["buckets"]
        if not les:
            raise ExpositionError(0, family.name,
                                  f"histogram {dict(key)} has no buckets")
        order = [le for le, _ in les]
        if order != sorted(order):
            raise ExpositionError(0, family.name,
                                  f"histogram le not ascending: {order}")
        if order[-1] != math.inf:
            raise ExpositionError(0, family.name, "histogram missing +Inf")
        counts = [c for _, c in les]
        if any(b > a for a, b in zip(counts[1:], counts)):
            raise ExpositionError(0, family.name,
                                  "bucket counts not monotone")
        if ent["sum"] is None or ent["count"] is None:
            raise ExpositionError(0, family.name,
                                  f"histogram {dict(key)} missing "
                                  "_sum/_count")
        if ent["count"] != counts[-1]:
            raise ExpositionError(0, family.name, "_count != +Inf bucket")


# -- registry lint -----------------------------------------------------------

# any more distinct values than this on an address-/bucket-/tenant-
# shaped label means a cardinality leak (every peer/bucket/tenant mints
# a new series forever). `tenant` is bounded BY CONSTRUCTION in the qos
# scheduler — its policy max_tenants ceiling routes the long tail into
# one "~other" overflow bucket — and this lint keeps that contract.
# `key` (the heavy-hitter sketches' label) is bounded by the sketch
# capacity (telemetry/topk.py, SWTPU_HOT_KEYS) the same way.
DEFAULT_CARDINALITY_CEILING = 256
_BOUNDED_LABELS = ("peer", "bucket", "tenant", "key")

# the lifecycle plane's {from,to} tier-label pair is a tiny CLOSED set
# (lifecycle.TIERS: hot/ec/remote/trash) — a typo'd or computed tier
# name minting new series is a bug, so its ceiling is far tighter than
# the address-shaped labels above. The telemetry plane's enumerated
# label families ride the same tight ceiling: `stage` (the volume
# server's fixed recv/parse->admit->store->serialize pipeline),
# `window` (the SLO policy's burn-rate window names), and `kind` (the
# heavy-hitter dimensions: volume/tenant/method).
TIER_CARDINALITY_CEILING = 8
_TIER_LABELS = ("from", "to", "stage", "window", "kind")

# The continuous-profiling plane's labels are closed sets by
# construction and ride the tier ceiling too: `thread_class` (the
# sampler's fixed classification: event_loop/read_pool/writer_pool/
# grpc/raft/other), `state` (on_cpu/waiting), `pool` (the handful of
# named executors: read/ec_read/grpc/...), and `loop` (one value per daemon
# kind: volume/master/filer/s3). The geo plane's `link` is the closed
# geo/policy.LINK_CLASSES triple (intra_rack/cross_rack/cross_dc).
_TIER_LABELS = _TIER_LABELS + ("thread_class", "state", "pool", "loop",
                               "link")

# The degraded EC read's stage families: `phase` (gather/stage/wait/
# decode; a shard fetch's first/rest), `role` (a fetch's survivor/
# direct) and, on the serving peer, `kind` (range/fragment, above).
# `class` is the thread-CPU family's closed set (profiling/threadcpu:
# the sampler's thread classes, `capture` and `native`).
_TIER_LABELS = _TIER_LABELS + ("phase", "role", "class")

# Data-center names come from operator topology flags — bounded by the
# fleet's DC count, which is more than the tier sets but far under the
# address-shaped families. A `dc` label minting dozens of values means
# a node is misreporting its topology, not a real new site.
DC_CARDINALITY_CEILING = 32
_DC_LABELS = ("dc",)

# SLO names come from the operator's policy doc — small by design (a
# policy with hundreds of objectives is unreviewable), but not a
# closed set, so they get their own intermediate ceiling.
SLO_CARDINALITY_CEILING = 64
_SLO_LABELS = ("slo",)


def lint_registry(registry=None,
                  ceiling: int = DEFAULT_CARDINALITY_CEILING,
                  tier_ceiling: int = TIER_CARDINALITY_CEILING,
                  slo_ceiling: int = SLO_CARDINALITY_CEILING,
                  dc_ceiling: int = DC_CARDINALITY_CEILING
                  ) -> list[str]:
    """Registry-level problems: duplicate family names and per-label
    cardinality over the ceiling on `peer`/`bucket`/`tenant`/`key`
    labels (the much tighter tier ceiling covers `from`/`to`/`stage`/
    `window`/`kind`; SLO names get an intermediate one). Returns a list
    of human-readable findings (empty = clean)."""
    from .metrics import REGISTRY, Counter, Gauge, Histogram
    registry = registry or REGISTRY
    problems: list[str] = []
    seen: set[str] = set()
    for m in registry.metrics():
        if m.name in seen:
            problems.append(f"duplicate metric name {m.name}")
        seen.add(m.name)
        for i, lname in enumerate(m.label_names):
            if lname in _TIER_LABELS:
                cap = tier_ceiling
            elif lname in _SLO_LABELS:
                cap = slo_ceiling
            elif lname in _DC_LABELS:
                cap = dc_ceiling
            elif lname in _BOUNDED_LABELS:
                cap = ceiling
            else:
                continue
            if isinstance(m, (Counter, Gauge)):
                values = {lv[i] for lv in m._values}
            elif isinstance(m, Histogram):
                values = {lv[i] for lv in m._counts}
            else:  # pragma: no cover
                continue
            if len(values) > cap:
                problems.append(
                    f"{m.name}: label {lname!r} has {len(values)} distinct "
                    f"values (> ceiling {cap})")
    return problems


def main(argv: "list[str] | None" = None) -> int:
    """Standalone / CI entry point: grammar-check the standard
    registry's exposition (plain AND OpenMetrics renderings) and lint the
    registry. Exit 0 = clean."""
    from .metrics import REGISTRY
    rc = 0
    for om in (False, True):
        try:
            fams = check_exposition(REGISTRY.gather(openmetrics=om))
        except ExpositionError as e:
            print(f"exposition ({'openmetrics' if om else 'text'}): {e}")
            rc = 1
        else:
            print(f"exposition ({'openmetrics' if om else 'text'}): "
                  f"{len(fams)} families clean")
    problems = lint_registry()
    for p in problems:
        print(f"registry: {p}")
        rc = 1
    if not problems:
        print("registry: clean")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
