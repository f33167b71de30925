"""In-memory ring TSDB for the leader's fleet scrapes.

Not a database — a bounded window of (ts, value) points per series,
just deep enough to answer the two questions the SLO engine and
/cluster/telemetry actually ask:

  * "what is the rate of counter X over the last W seconds?" —
    counter-delta rates with reset handling (a restarted node's
    counter dropping to zero contributes its new value, not a huge
    negative spike);
  * "what did histogram X's buckets do over the last W seconds?" —
    windowed cumulative-count deltas per bucket, ready for the
    cross-node merge.

Series are keyed (node, name, labels); memory is bounded by
max_points per series times the series the fleet actually exposes,
and series from nodes that stopped reporting are pruned after
`prune_after_s` so a decommissioned node doesn't pin its window
forever. Staleness is a first-class mark (scrape failures flip it,
tied to the health plane's `nodes_stale` signal): stale nodes keep
their history but are excluded from merges and rates until they
answer again.

The port's copy of seaweedfs_tpu/telemetry/tsdb.py.
"""

from __future__ import annotations

import threading
from collections import deque

LabelKey = "tuple[tuple[str, str], ...]"


class RingTSDB:
    def __init__(self, max_points: int = 64, prune_after_s: float = 900.0):
        self.max_points = max_points
        self.prune_after_s = prune_after_s
        # (node, name, labels) -> deque[(ts, value)]
        self._series: dict[tuple, deque] = {}
        self._stale: set[str] = set()
        self._last_seen: dict[str, float] = {}
        self._lock = threading.Lock()

    # -- ingest ---------------------------------------------------------
    def add(self, node: str, name: str, labels: LabelKey, ts: float,
            value: float) -> None:
        key = (node, name, labels)
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                dq = self._series[key] = deque(maxlen=self.max_points)
            dq.append((ts, value))
            self._last_seen[node] = max(self._last_seen.get(node, 0.0), ts)

    def ingest(self, node: str, families: dict, ts: float) -> int:
        """Store every sample of a parsed exposition (stats/parse.py
        families) under `node`, clearing its stale mark. Returns the
        sample count."""
        n = 0
        for fam in families.values():
            for s in fam.samples:
                self.add(node, s.name, s.labels, ts, s.value)
                n += 1
        with self._lock:
            self._stale.discard(node)
        return n

    # -- staleness ------------------------------------------------------
    def mark_stale(self, node: str) -> None:
        with self._lock:
            self._stale.add(node)

    def is_stale(self, node: str) -> bool:
        with self._lock:
            return node in self._stale

    def stale_nodes(self) -> set[str]:
        with self._lock:
            return set(self._stale)

    def nodes(self) -> list[str]:
        with self._lock:
            return sorted(self._last_seen)

    def forget(self, node: str) -> None:
        """Drop a node's series + marks (decommission)."""
        with self._lock:
            for key in [k for k in self._series if k[0] == node]:
                del self._series[key]
            self._stale.discard(node)
            self._last_seen.pop(node, None)

    def prune(self, now: float) -> list[str]:
        """Forget nodes silent for prune_after_s; returns who."""
        with self._lock:
            dead = [n for n, ts in self._last_seen.items()
                    if now - ts > self.prune_after_s]
        for n in dead:
            self.forget(n)
        return dead

    # -- reads ----------------------------------------------------------
    def latest(self, node: str, name: str, labels: LabelKey
               ) -> "tuple[float, float] | None":
        with self._lock:
            dq = self._series.get((node, name, labels))
            return dq[-1] if dq else None

    def series_points(self, node: str, name: str, labels: LabelKey
                      ) -> list:
        with self._lock:
            dq = self._series.get((node, name, labels))
            return list(dq) if dq else []

    def window_delta(self, node: str, name: str, labels: LabelKey,
                     window_s: float, now: float) -> float:
        """Monotone counter increase over the trailing window, summing
        positive point-to-point deltas so a counter reset (process
        restart) contributes the post-restart growth instead of a
        negative spike. 0.0 when fewer than 2 in-window points."""
        points = self.series_points(node, name, labels)
        lo = now - window_s
        inwin = [(ts, v) for ts, v in points if ts >= lo]
        if len(inwin) < 2:
            # the window opened mid-series: anchor on the last point
            # before the window if there is one
            before = [(ts, v) for ts, v in points if ts < lo]
            if before and inwin:
                inwin = [before[-1]] + inwin
            else:
                return 0.0
        delta = 0.0
        for (_, a), (_, b) in zip(inwin, inwin[1:]):
            if b >= a:
                delta += b - a
            else:
                delta += b  # reset: count growth since the restart
        return delta

    def rate(self, node: str, name: str, labels: LabelKey,
             window_s: float, now: float) -> float:
        return self.window_delta(node, name, labels, window_s, now) \
            / max(window_s, 1e-9)

    # -- cross-node aggregation ----------------------------------------
    def sum_window_delta(self, name: str, window_s: float, now: float,
                         label_filter=None,
                         include_stale: bool = False) -> float:
        """Counter growth over the window summed across every matching
        series of every non-stale node. `label_filter` is a
        {label: value} subset match (value "*" = any)."""
        total = 0.0
        for node, sname, labels in self._matching(name, label_filter,
                                                  include_stale):
            total += self.window_delta(node, sname, labels, window_s, now)
        return total

    def grouped_window_delta(self, name: str, group_label: str,
                             window_s: float, now: float,
                             label_filter=None) -> dict[str, float]:
        """Like sum_window_delta but grouped by one label's value."""
        out: dict[str, float] = {}
        for node, sname, labels in self._matching(name, label_filter,
                                                  False):
            val = dict(labels).get(group_label)
            if val is None:
                continue
            out[val] = out.get(val, 0.0) + self.window_delta(
                node, sname, labels, window_s, now)
        return out

    def _matching(self, name: str, label_filter, include_stale: bool):
        with self._lock:
            keys = list(self._series)
            stale = set(self._stale)
        for node, sname, labels in keys:
            if sname != name:
                continue
            if not include_stale and node in stale:
                continue
            if label_filter:
                ld = dict(labels)
                if any(ld.get(k) != v for k, v in label_filter.items()
                       if v != "*"):
                    continue
            yield node, sname, labels

    def histogram_window(self, family: str, window_s: float, now: float,
                         label_filter=None
                         ) -> "dict[float, float]":
        """Cross-node, cross-labelset merged bucket growth over the
        window: {le: cumulative count delta}, summed over every
        non-stale `<family>_bucket` series matching the filter (the
        filter never matches on `le`). Bucket boundaries are shared
        fleet-wide (every node runs the same registry), which is what
        makes the flat sum a true pooled histogram."""
        import math
        out: dict[float, float] = {}
        for node, sname, labels in self._matching(family + "_bucket",
                                                  None, False):
            ld = dict(labels)
            le_raw = ld.pop("le", None)
            if le_raw is None:
                continue
            if label_filter and any(
                    ld.get(k) != v for k, v in label_filter.items()
                    if v != "*"):
                continue
            le = math.inf if le_raw == "+Inf" else float(le_raw)
            out[le] = out.get(le, 0.0) + self.window_delta(
                node, sname, labels, window_s, now)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)
