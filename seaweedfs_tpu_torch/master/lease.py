"""Fid-range lease bookkeeping for the batched ingest control plane.

A lease is what `Assign(count=N)` hands out: a contiguous needle-key
range on one volume, one shared cookie, and a TTL. The sequencer already
made the reservation (sequencer.next_id(count) is the allocation — keys
are never handed out twice whether or not the lease is used); this
registry only tracks how many grants are still live so operators can see
outstanding ingest leases (`SeaweedFS_fid_leases_active`) and the
bench/chaos harnesses can assert leases drain to zero after a run.

TTL is advisory on the key range itself (expired keys simply go unused —
the sequencer never reissues them) but REAL for the range-scoped write
JWT the master mints alongside: the token's `exp` is this TTL, so a
leased client past it must re-lease before it can write again.

The port's copy of seaweedfs_tpu/master/lease.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.env import env_float

DEFAULT_LEASE_TTL_S = env_float("SWTPU_FID_LEASE_TTL_S", 60.0)


class FidLeaseRegistry:
    def __init__(self, ttl_s: float | None = None):
        self.ttl_s = DEFAULT_LEASE_TTL_S if ttl_s is None else ttl_s
        self._lock = threading.Lock()
        self._expiries: deque[float] = deque()  # monotonic deadlines, FIFO
        self.granted_total = 0
        self.keys_granted_total = 0

    def grant(self, count: int) -> float:
        """Record one range grant of `count` keys; returns the lease TTL
        in seconds (what the HTTP assign response advertises and the
        range JWT's exp is derived from)."""
        return self._grant(count, self.ttl_s)

    def grant_replicated(self, count: int,
                         ttl_s: float | None = None) -> float:
        """FSM-apply path: a grant committed through the raft log lands
        here on EVERY master (leader included — the leader does not also
        call grant(), so the gauge counts each lease exactly once). The
        expiry clock starts at local apply time: followers apply within
        one replication round of the leader, so the gauge converges, and
        a restart that replays unsnapshotted grant entries re-arms them
        for at most one TTL (the snapshot fold drops leases as
        ephemeral). Expired-but-unreplayed grants are never REISSUED in
        any case — key uniqueness lives in the replicated sequencer
        high-water mark, not in this registry."""
        return self._grant(count, self.ttl_s if ttl_s is None else ttl_s)

    def _grant(self, count: int, ttl_s: float) -> float:
        now = time.monotonic()
        with self._lock:
            self._prune_locked(now)
            self._expiries.append(now + ttl_s)
            self.granted_total += 1
            self.keys_granted_total += count
            active = len(self._expiries)
        self._publish(active)
        return ttl_s

    def active(self) -> int:
        """Leases granted and not yet past their TTL."""
        now = time.monotonic()
        with self._lock:
            self._prune_locked(now)
            active = len(self._expiries)
        self._publish(active)
        return active

    def prune(self) -> None:
        """Janitor hook: expire old grants so the gauge decays even when
        nobody is asking."""
        self.active()

    def _prune_locked(self, now: float) -> None:
        while self._expiries and self._expiries[0] <= now:
            self._expiries.popleft()

    @staticmethod
    def _publish(active: int) -> None:
        try:
            from ..stats import FID_LEASES_ACTIVE
            FID_LEASES_ACTIVE.set(value=active)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break assign)
            pass
