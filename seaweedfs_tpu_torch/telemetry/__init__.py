"""Fleet telemetry & SLO plane.

Every observability primitive below this package is per-node (/metrics,
/debug/traces, /debug/events each answer for one daemon). This package
is the fleet-level roll-up: a leader-resident collector scrapes every
node's exposition into a ring TSDB, merges same-bucket histograms into
true cluster percentiles, tracks heavy hitters with space-saving
sketches, and evaluates SLO burn rates — served at /cluster/telemetry
and `cluster.top`.

  topk.py       space-saving heavy-hitter sketch (guaranteed bounds)
  tsdb.py       bounded per-series ring windows, counter-delta rates
  merge.py      cross-node histogram merge -> percentiles
  slo.py        SLO policy doc + multi-window multi-burn-rate alerts
  hot.py        per-process hot volumes/tenants/methods recording
  collector.py  the leader-resident scrape/merge/evaluate loop

The port's copy of seaweedfs_tpu/telemetry/__init__.py; it also exports
`hot`, which the volume server records into.
"""

from . import hot
from .collector import TelemetryCollector
from .merge import fraction_at_most, merge_buckets, quantile, summarize
from .slo import SloEngine, SloPolicy, parse_slo_policy
from .topk import SpaceSaving
from .tsdb import RingTSDB

__all__ = [
    "TelemetryCollector", "RingTSDB", "SpaceSaving",
    "SloEngine", "SloPolicy", "parse_slo_policy",
    "merge_buckets", "quantile", "fraction_at_most", "summarize", "hot",
]
