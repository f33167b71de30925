"""Per-process telemetry of the port's data-plane daemons.

The port's slice of seaweedfs_tpu/telemetry/: the space-saving sketch
(`topk.py`) and the volume server's hot-key recording (`hot.py`), which a
pre-scrape hook mirrors into the `SeaweedFS_hot_*` gauges of /metrics. The
fleet half — the ring TSDB, the histogram merge, the SLO engine and the
collector — runs on the master and is ported with it.

  topk.py       space-saving heavy-hitter sketch (guaranteed bounds)
  hot.py        per-process hot volumes/tenants/methods recording
"""

from . import hot
from .topk import SpaceSaving

__all__ = ["SpaceSaving", "hot"]
