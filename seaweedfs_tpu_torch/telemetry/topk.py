"""Space-saving heavy-hitter sketch (Metwally/Agrawal/El Abbadi).

The fleet has unbounded key spaces a metrics registry must never mint
series for — volume ids, tenants past the qos overflow bucket, RPC
methods × nodes — yet "which volumes/tenants are hot RIGHT NOW" is the
first question during an incident. The space-saving sketch answers it
in O(k) memory with a *guaranteed* error bound:

  * every tracked key reports `count` with `count - error <= true
    <= count` (the inherited `error` is recorded per key, so the
    report is self-qualifying);
  * any key whose true weight exceeds N/k (N = total weight offered,
    k = capacity) is guaranteed to be tracked;
  * max error across keys <= N/k.

tests/test_telemetry.py property-tests both bounds over random
zipfian streams. Used twice: per-process on the volume server (hot
volumes/tenants/methods by requests + bytes, exported as the bounded
`SeaweedFS_hot_requests{kind,key}` gauge families) and cluster-wide in
the leader's collector (merging per-node deltas into fleet top-k).

The port's copy of seaweedfs_tpu/telemetry/topk.py.
"""

from __future__ import annotations

import threading


class SpaceSaving:
    """Bounded top-k counter over an unbounded key space."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        # key -> [count, error]; error = the evicted minimum this key's
        # counter inherited when it displaced another key
        self._items: dict[str, list[float]] = {}
        self.total = 0.0  # N: total weight ever offered
        self._lock = threading.Lock()

    def offer(self, key: str, amount: float = 1.0) -> None:
        if amount <= 0:
            return
        with self._lock:
            self.total += amount
            ent = self._items.get(key)
            if ent is not None:
                ent[0] += amount
                return
            if len(self._items) < self.capacity:
                self._items[key] = [amount, 0.0]
                return
            # displace the minimum-count key; the newcomer inherits its
            # count as both floor and error bound
            victim = min(self._items, key=lambda k: self._items[k][0])
            vcount = self._items.pop(victim)[0]
            self._items[key] = [vcount + amount, vcount]

    def items(self, limit: int = 0) -> list[dict]:
        """Tracked keys, heaviest first: [{key, count, error}]. `count`
        over-estimates by at most `error` (true >= count - error)."""
        with self._lock:
            snap = sorted(self._items.items(),
                          key=lambda kv: kv[1][0], reverse=True)
        out = [{"key": k, "count": c, "error": e} for k, (c, e) in snap]
        return out[:limit] if limit else out

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self.total = 0.0
