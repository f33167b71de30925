"""VolumeLayout: writable-volume tracking per (collection, rp, ttl, disk).

Reference: weed/topology/volume_layout.go:132 (state), :291 (PickForWrite),
:214 (EnsureCorrectWritables). The layout answers "which volume id should
this write go to" with round-robin over writable volumes whose replica sets
are complete and under the size limit.

The port's copy of seaweedfs_tpu/master/volume_layout.py.
"""

from __future__ import annotations

import random
import threading

from .topology import Topology, VolumeInfo


class VolumeLayout:
    def __init__(self, topo: Topology, collection: str, replication: str,
                 ttl: str, disk_type: str):
        self.topo = topo
        self.collection = collection
        self.replication = replication
        self.ttl = ttl
        self.disk_type = disk_type
        self.writable: set[int] = set()
        self.readonly: set[int] = set()
        self.oversized: set[int] = set()
        self.crowded: set[int] = set()
        self.lock = threading.RLock()
        from ..storage.types import ReplicaPlacement
        self._copy_count = ReplicaPlacement.parse(replication).copy_count

    def register(self, v: VolumeInfo) -> None:
        with self.lock:
            if v.read_only:
                self.readonly.add(v.id)
                self.writable.discard(v.id)
            elif v.size >= self.topo.volume_size_limit:
                self.oversized.add(v.id)
                self.writable.discard(v.id)
            else:
                self.readonly.discard(v.id)
                self.writable.add(v.id)

    def unregister(self, vid: int) -> None:
        with self.lock:
            self.writable.discard(vid)
            self.readonly.discard(vid)
            self.oversized.discard(vid)
            self.crowded.discard(vid)

    def ensure_correct_writables(self) -> None:
        """Drop volumes whose replica sets are incomplete or oversized."""
        with self.lock:
            for vid in list(self.writable):
                locs = self.topo.lookup(vid)
                if len(locs) < self._copy_count:
                    self.writable.discard(vid)
                # iterate node volume dicts under the TOPOLOGY lock:
                # heartbeat ingest mutates disk.volumes concurrently
                # ("dictionary changed size during iteration" — caught by
                # tests/stress assign-storm)
                with self.topo.lock:
                    infos = [v for n in locs for v in n.all_volumes()
                             if v.id == vid]
                if any(v.size >= self.topo.volume_size_limit or v.read_only
                       for v in infos):
                    self.writable.discard(vid)

    def pick_for_write(self) -> int | None:
        """A writable volume id, placement-aware: volumes whose every
        holder sits behind an OPEN circuit breaker are deprioritized
        (an assign pointing at a half-dead node costs the client a
        retry budget), and among the healthy the pick is weighted
        toward holders with lower byte load — the placement engine's
        load definition (volume + EC shard bytes), so hot nodes shed
        new write traffic naturally. Still randomized across the
        preferred tier so one volume never becomes the write hotspot."""
        with self.lock:
            if not self.writable:
                return None
            cands = tuple(self.writable)
            if len(cands) == 1:
                return cands[0]
            healthy, shunned = [], []
            try:
                from .. import ec as ec_accounting
                from ..placement.engine import DEFAULT_SHARD_DIVISOR
                from ..utils import retry
                est_shard = (self.topo.volume_size_limit
                             // DEFAULT_SHARD_DIVISOR)
                # per-NODE byte loads memoized once (several writable
                # vids share holders — recomputing per vid made every
                # assign O(vids x volumes) under the topology lock),
                # counting volume bytes AND estimated EC shard bytes:
                # the engine's one load definition, so a shard-crushed
                # holder can't read as empty on the write path either
                node_bytes: dict[str, int] = {}

                def load_of(h) -> int:
                    b = node_bytes.get(h.id)
                    if b is None:
                        b = sum(v.size for v in h.all_volumes()) + \
                            est_shard * sum(
                                ec_accounting.shard_count(s.shard_bits)
                                for s in h.all_ec_shards())
                        node_bytes[h.id] = b
                    return b

                # iterate holder maps under the topology lock:
                # heartbeat ingest mutates them concurrently
                with self.topo.lock:
                    loads = {}
                    for vid in cands:
                        holders = list(
                            self.topo.volume_locations.get(vid, {})
                            .values())
                        if holders and all(
                                retry.breaker(h.id).state == retry.OPEN
                                for h in holders):
                            shunned.append(vid)
                            continue
                        healthy.append(vid)
                        loads[vid] = max(
                            (load_of(h) for h in holders), default=0)
            except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (placement nuance must never fail an assign)
                return random.choice(cands)
            if not healthy:
                return random.choice(cands)
            # prefer volumes at or under the median holder byte load;
            # <= median (not "first half sorted") so ties — the common
            # fresh-cluster case — keep the WHOLE candidate set and
            # writes stay uniformly spread across servers
            ranked = sorted(loads.get(vid, 0) for vid in healthy)
            median = ranked[(len(ranked) - 1) // 2]
            tier = [vid for vid in healthy
                    if loads.get(vid, 0) <= median]
            return random.choice(tier or healthy)

    def active_count(self) -> int:
        with self.lock:
            return len(self.writable)

    def should_grow(self, min_active: int = 1) -> bool:
        return self.active_count() < min_active


class LayoutRegistry:
    def __init__(self, topo: Topology):
        self.topo = topo
        self._layouts: dict[tuple, VolumeLayout] = {}
        self.lock = threading.RLock()

    def get(self, collection: str, replication: str, ttl: str,
            disk_type: str) -> VolumeLayout:
        key = (collection, replication, ttl, disk_type)
        with self.lock:
            lo = self._layouts.get(key)
            if lo is None:
                lo = self._layouts[key] = VolumeLayout(
                    self.topo, collection, replication, ttl, disk_type)
            return lo

    def register_volume(self, v: VolumeInfo) -> None:
        self.get(v.collection, str(v.replica_placement), str(v.ttl),
                 v.disk_type).register(v)

    def unregister_volume(self, v: VolumeInfo) -> None:
        self.get(v.collection, str(v.replica_placement), str(v.ttl),
                 v.disk_type).unregister(v.id)

    def all_layouts(self) -> list[VolumeLayout]:
        with self.lock:
            return list(self._layouts.values())
