"""Async cross-cluster (cross-DC) replication with a bounded-lag invariant.

GeoSync rides the filer.sync machinery (replication/filer_sync.py): the
same metadata-stream subscription, signature loop guard, retry +
dead-letter discipline, and persisted-offset resume. What geo adds:

- its own offset namespace (`geo.sync.offset.<source-sig>`) so a
  cross-DC pairing can coexist with an intra-DC filer.sync between the
  same filers without the two fighting over one cursor;
- a replication-lag gauge, `SeaweedFS_geo_replication_lag_seconds{peer}`:
  age of the oldest not-yet-applied source event. The lag bound from the
  link-cost policy (`replication_lag_bound_s`) makes it an SLO-able
  objective — `lag_ok()` is the invariant the chaos lane asserts after a
  DC sever heals;
- maintenance-class QoS tagging: replication applies run under
  CLASS_MAINTENANCE so a catch-up storm after a link heals yields to
  foreground reads on the target instead of competing with them.

Lag semantics: meta-log timestamps are wall-clock nanoseconds (MetaLog
stamps `max(time.time_ns(), last+1)`), so `source_last_ts - applied_ts`
is the replication horizon in real seconds. When the cursor has caught
up to the source's newest event the lag is 0 — an idle source never
shows phantom lag just because no new events arrive.

The port's copy of seaweedfs_tpu/geo/replication.py over the port's
FilerSync, `qos.tagged(CLASS_MAINTENANCE)` and
`stats.GEO_REPLICATION_LAG`, unchanged.
"""

from __future__ import annotations

import time

from ..qos import CLASS_MAINTENANCE, tagged
from ..replication.filer_sync import FilerSync
from ..stats import GEO_REPLICATION_LAG
from ..utils.log import logger

log = logger("geo.sync")


class GeoSync(FilerSync):
    """filer.sync across an expensive link: distinct offset namespace,
    lag gauge + bound, maintenance-class applies."""

    def __init__(self, source_fs, target_fs, peer: str = "",
                 lag_bound_s: float = 0.0, path_prefix: str = "/",
                 from_ns: int | None = None, max_retries: int = 5,
                 retry_base_delay: float = 0.2):
        super().__init__(source_fs, target_fs, path_prefix=path_prefix,
                         from_ns=from_ns, max_retries=max_retries,
                         retry_base_delay=retry_base_delay)
        # peer label = the remote cluster this stream drains FROM; falls
        # back to the source signature so the gauge is never unlabeled
        self.peer = peer or f"sig-{self.source.filer.signature}"
        self.lag_bound_s = float(lag_bound_s)
        # re-point the cursor at the geo namespace: the base class loaded
        # from sync.offset.* before this key existed
        self._offset_key = (
            f"geo.sync.offset.{self.source.filer.signature}".encode())
        if from_ns is None:
            self.from_ns = self._load_offset()
        self._applied_ts_ns = self.from_ns
        GEO_REPLICATION_LAG.set(self.peer, value=self.lag_seconds())

    # -- lag invariant -------------------------------------------------------
    def lag_seconds(self) -> float:
        """Age of the newest source event not yet applied here; 0 when
        caught up. Computed live from the source meta-log head so an
        event sitting in the retry loop keeps aging."""
        head = getattr(self.source.filer.meta_log, "_last_ts", 0)
        if head <= self._applied_ts_ns:
            return 0.0
        # the un-applied head keeps aging even if no further events
        # arrive behind it. Wall-clock on purpose: meta-log stamps ARE
        # time.time_ns values (see module docstring), so a monotonic
        # reading would mix clock domains.
        age_from = self._applied_ts_ns if self._applied_ts_ns else head
        now_ns = time.time_ns()  # swtpu-lint: disable=wallclock-duration
        return max(0.0, (now_ns - age_from) / 1e9)

    def lag_ok(self) -> bool:
        """The bounded-lag invariant: lag under the policy bound (or no
        bound configured)."""
        return self.lag_bound_s <= 0 or self.lag_seconds() <= self.lag_bound_s

    # -- hooks over the base machinery --------------------------------------
    def _save_offset(self, ts_ns: int) -> None:
        super()._save_offset(ts_ns)
        self._applied_ts_ns = max(self._applied_ts_ns, ts_ns)
        GEO_REPLICATION_LAG.set(self.peer, value=self.lag_seconds())

    def _run(self) -> None:
        # catch-up bursts after a link heals are background work on the
        # target: same class the repair executor runs under
        with tagged(CLASS_MAINTENANCE):
            super()._run()
