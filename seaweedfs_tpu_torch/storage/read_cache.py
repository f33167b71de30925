"""Hot-needle read cache: byte-bounded segmented LRU under the GET path.

Haystack's promise is one disk read per object, but real object-store
read traffic is Zipfian — a small hot set absorbs most GETs. Keeping
those needles in memory turns the volume server's hot-path read into a
dict lookup, and the segmented (probation -> protected) structure makes
the hot set scan-resistant: a one-pass sweep over a volume only ever
churns the probation segment, because an entry must be HIT AGAIN while
on probation to earn a protected slot (the SLRU admission filter —
reference: the 2Q/SLRU family; the fork's chunk_cache uses plain LRU,
which one backup walk flushes).

Coherence: every mutation in storage/volume.py, storage/store.py and
storage/vacuum.py funnels through the module-level `invalidate()` /
`invalidate_volume()` chokepoint — delete, overwrite, bulk-frame
append, tail replay, vacuum/compaction commit, unmount/destroy. The
registry fans the invalidation out to every live cache in the process
(mini-cluster tests run several volume servers in one interpreter;
vids are cluster-unique, so cross-server invalidation is at worst a
spurious miss, never a stale hit).

Admission is size-capped (`SWTPU_READ_CACHE_MAX_OBJ`): large needles
stream straight off the volume file — one multi-MB blob must not evict
thousands of hot small objects for a single pass-through read.

The port's copy of the JAX package's storage/read_cache.py, with its
metric hooks (SeaweedFS_read_cache_{hits,misses,evictions}_total).
Accounting uses delta updates against the shared
`SeaweedFS_read_cache_bytes` gauge (+n on insert, -n on evict /
invalidate / clear) so several caches in one process compose and the
gauge can never scrape negative while each cache's own contribution is
non-negative.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict

from ..stats import (READ_CACHE_BYTES, READ_CACHE_EVICTIONS, READ_CACHE_HITS,
                     READ_CACHE_MISSES)
from ..utils.env import env_int

# Defaults: a 64 MB cache holds ~64k hot 1 KB needles; objects above
# 256 KB bypass the cache entirely.
READ_CACHE_MB = env_int("SWTPU_READ_CACHE_MB", 64)
READ_CACHE_MAX_OBJ = env_int("SWTPU_READ_CACHE_MAX_OBJ", 256 << 10)

# Protected fraction of capacity: the scan-resistant segment. 0.8 is
# the classic SLRU split — probation is deliberately small so streaming
# misses recycle quickly.
_PROTECTED_FRAC = 0.8

_registry: "weakref.WeakSet[ReadCache]" = weakref.WeakSet()
_registry_lock = threading.Lock()


def register(cache: "ReadCache") -> None:
    with _registry_lock:
        _registry.add(cache)


def invalidate(vid: int, key: int) -> None:
    """One-needle coherence chokepoint: called by every storage-layer
    mutation (write/overwrite/delete/bulk append/tail replay) BEFORE the
    mutating call returns, so no later read can see pre-mutation bytes."""
    with _registry_lock:
        caches = list(_registry)
    for c in caches:
        c.invalidate(vid, key)


def invalidate_keys(vid: int, keys) -> None:
    """Batched chokepoint for bulk frames / tail replays: one registry
    snapshot and one locked pass (single epoch bump) per cache instead
    of 2N lock round-trips appended to every ingest ack."""
    with _registry_lock:
        caches = list(_registry)
    for c in caches:
        c.invalidate_many(vid, keys)


def invalidate_volume(vid: int) -> None:
    """Whole-volume chokepoint: vacuum/compaction commit (offsets moved),
    unmount, destroy, reload — anything that can re-arrange a volume's
    bytes wholesale."""
    with _registry_lock:
        caches = list(_registry)
    for c in caches:
        c.invalidate(vid)


class _Entry:
    __slots__ = ("needle", "nbytes", "protected")

    def __init__(self, needle, nbytes: int):
        self.needle = needle
        self.nbytes = nbytes
        self.protected = False


class ReadCache:
    """Segmented LRU over parsed Needle objects, keyed (vid, key).

    The stored needle's cookie is checked on get: a mismatched cookie is
    reported as a miss so the authoritative storage path answers (the
    volume raises PermissionError there, same as an uncached read).
    Needles are treated as immutable once cached — the read handler
    serves from the cached object without copying.
    """

    def __init__(self, capacity_bytes: int,
                 max_obj_bytes: int = READ_CACHE_MAX_OBJ,
                 protected_frac: float = _PROTECTED_FRAC):
        self.capacity = max(0, int(capacity_bytes))
        self.max_obj = int(max_obj_bytes)
        self.protected_cap = int(self.capacity * protected_frac)
        self._lock = threading.Lock()
        # key -> _Entry; OrderedDict LRU order (oldest first)
        self._probation: "OrderedDict[tuple[int, int], _Entry]" = OrderedDict()
        self._protected: "OrderedDict[tuple[int, int], _Entry]" = OrderedDict()
        self._bytes = 0
        self._protected_bytes = 0
        # per-volume invalidation epoch: put() rejects fills whose
        # storage read began before the latest invalidation, closing the
        # read-old-bytes / invalidate / cache-stale-fill race (see put)
        self._epochs: dict[int, int] = {}
        register(self)

    # -- accounting ---------------------------------------------------------
    def _gauge_add(self, delta: int) -> None:
        if delta:
            READ_CACHE_BYTES.add(amount=delta)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._probation) + len(self._protected)

    # -- data path ----------------------------------------------------------
    def get(self, vid: int, key: int, cookie: "int | None" = None):
        """Cached Needle or None. A probation hit promotes the entry to
        the protected segment (the frequency gate); a protected hit just
        refreshes recency."""
        k = (vid, key)
        with self._lock:
            ent = self._protected.get(k)
            if ent is not None:
                if cookie is not None and ent.needle.cookie != cookie:
                    self._miss()
                    return None
                self._protected.move_to_end(k)
                self._hit()
                return ent.needle
            ent = self._probation.get(k)
            if ent is None:
                self._miss()
                return None
            if cookie is not None and ent.needle.cookie != cookie:
                self._miss()
                return None
            # second touch while on probation: earned a protected slot
            del self._probation[k]
            ent.protected = True
            self._protected[k] = ent
            self._protected_bytes += ent.nbytes
            self._shrink_protected()
            self._hit()
            return ent.needle

    def epoch(self, vid: int) -> int:
        """Snapshot the volume's invalidation epoch BEFORE the storage
        read that will back a put() — the fill is only admitted if no
        invalidation landed in between."""
        with self._lock:
            return self._epochs.get(vid, 0)

    def put(self, vid: int, key: int, needle,
            epoch: "int | None" = None) -> bool:
        """Admit a needle read from storage. Size-gated: oversized
        objects are never cached. New keys land on probation; a key
        already cached is refreshed in place (same segment).

        `epoch` (from epoch(vid), snapshotted before the storage read)
        makes fills coherent: a mutation that completed after the
        snapshot bumped the volume's epoch, so a fill carrying the stale
        snapshot is rejected — without this, read(old bytes) ->
        delete+invalidate -> put(old bytes) would park deleted data in
        the cache forever."""
        nbytes = len(needle.data)
        if self.capacity <= 0 or nbytes > self.max_obj:
            return False
        k = (vid, key)
        freed = 0
        with self._lock:
            if epoch is not None and self._epochs.get(vid, 0) != epoch:
                return False
            old = self._protected.get(k) or self._probation.get(k)
            if old is not None:
                # refresh (e.g. raced overwrite+read): replace in place
                seg = self._protected if old.protected else self._probation
                ent = _Entry(needle, nbytes)
                ent.protected = old.protected
                seg[k] = ent
                seg.move_to_end(k)
                self._bytes += nbytes - old.nbytes
                if old.protected:
                    self._protected_bytes += nbytes - old.nbytes
                    self._shrink_protected()
                delta = nbytes - old.nbytes
            else:
                self._probation[k] = _Entry(needle, nbytes)
                self._bytes += nbytes
                delta = nbytes
            freed = self._evict_over_capacity()
            # gauge delta INSIDE the lock: this cache's contribution is
            # never observably negative, so the shared gauge (a sum of
            # per-cache contributions) can never scrape negative either
            self._gauge_add(delta - freed)
        return True

    def invalidate(self, vid: int, key: "int | None" = None) -> None:
        """Drop one needle (or a whole volume's) from the cache and bump
        the volume's epoch so in-flight fills that read pre-mutation
        bytes cannot land afterwards. Callers invalidate AFTER the
        mutation is visible in the needle map — any fill that saw the
        old bytes necessarily snapshotted the pre-bump epoch."""
        freed = 0
        with self._lock:
            self._epochs[vid] = self._epochs.get(vid, 0) + 1
            if key is not None:
                freed = self._drop((vid, key))
            else:
                for seg in (self._probation, self._protected):
                    for k in [k for k in seg if k[0] == vid]:
                        freed += self._drop(k)
            self._gauge_add(-freed)

    def invalidate_many(self, vid: int, keys) -> None:
        """Drop a batch of needles under ONE lock acquisition with a
        single epoch bump — same coherence as N invalidate() calls."""
        freed = 0
        with self._lock:
            self._epochs[vid] = self._epochs.get(vid, 0) + 1
            for key in keys:
                freed += self._drop((vid, key))
            self._gauge_add(-freed)

    def clear(self) -> None:
        with self._lock:
            freed = self._bytes
            self._probation.clear()
            self._protected.clear()
            self._bytes = 0
            self._protected_bytes = 0
            self._gauge_add(-freed)

    # -- internals (call with self._lock held) ------------------------------
    def _drop(self, k) -> int:
        ent = self._probation.pop(k, None)
        if ent is None:
            ent = self._protected.pop(k, None)
            if ent is not None:
                self._protected_bytes -= ent.nbytes
        if ent is None:
            return 0
        self._bytes -= ent.nbytes
        return ent.nbytes

    def _shrink_protected(self) -> None:
        """Demote protected LRU entries back to probation's MRU end until
        the protected segment fits its share — demoted entries get one
        more probation lap before eviction instead of dying instantly."""
        while self._protected_bytes > self.protected_cap and self._protected:
            k, ent = self._protected.popitem(last=False)
            self._protected_bytes -= ent.nbytes
            ent.protected = False
            self._probation[k] = ent

    def _evict_over_capacity(self) -> int:
        """Evict probation LRU first (the scan victims), protected only
        when probation alone cannot make room. Returns bytes freed."""
        freed = 0
        while self._bytes > self.capacity:
            if self._probation:
                _, ent = self._probation.popitem(last=False)
            elif self._protected:
                _, ent = self._protected.popitem(last=False)
                self._protected_bytes -= ent.nbytes
            else:
                break
            self._bytes -= ent.nbytes
            freed += ent.nbytes
            self._evictions()
        return freed

    # -- metrics ------------------------------------------------------------
    @staticmethod
    def _hit() -> None:
        READ_CACHE_HITS.inc()

    @staticmethod
    def _miss() -> None:
        READ_CACHE_MISSES.inc()

    @staticmethod
    def _evictions() -> None:
        READ_CACHE_EVICTIONS.inc()

    def stats(self) -> dict:
        with self._lock:
            return {
                "bytes": self._bytes,
                "protected_bytes": self._protected_bytes,
                "entries": len(self._probation) + len(self._protected),
                "probation": len(self._probation),
                "protected": len(self._protected),
                "capacity": self.capacity,
            }


def default_cache() -> "ReadCache | None":
    """Cache sized from SWTPU_READ_CACHE_MB (0 disables caching). Env is
    re-read per call so tests and late-configured daemons can size (or
    disable) the cache without re-importing the module."""
    mb = env_int("SWTPU_READ_CACHE_MB", READ_CACHE_MB)
    if mb <= 0:
        return None
    return ReadCache(mb << 20,
                     max_obj_bytes=env_int("SWTPU_READ_CACHE_MAX_OBJ",
                                           READ_CACHE_MAX_OBJ))
