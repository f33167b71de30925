"""Cluster topology tree: DataCenter -> Rack -> DataNode -> Disk.

Reference: weed/topology/{topology,node,data_node,disk}.go and the EC
registration paths topology_ec.go:102/:131. The master holds one Topology;
volume servers stream heartbeats that register/diff their volume and EC-shard
lists; lookups and placement walk this tree.

The port's copy of seaweedfs_tpu/master/topology.py.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .. import ec as ec_accounting
from ..storage.types import TTL, DiskType, ReplicaPlacement


@dataclass
class VolumeInfo:
    id: int
    size: int = 0
    collection: str = ""
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    version: int = 3
    disk_type: str = "hdd"
    compact_revision: int = 0
    modified_at_second: int = 0

    @classmethod
    def from_pb(cls, m) -> "VolumeInfo":
        return cls(
            id=m.id, size=m.size, collection=m.collection,
            file_count=m.file_count, delete_count=m.delete_count,
            deleted_byte_count=m.deleted_byte_count, read_only=m.read_only,
            replica_placement=ReplicaPlacement.from_byte(m.replica_placement),
            ttl=TTL.from_bytes(m.ttl.to_bytes(2, "little")),
            version=m.version or 3, disk_type=m.disk_type or "hdd",
            compact_revision=m.compact_revision,
            modified_at_second=m.modified_at_second)

    def layout_key(self) -> tuple:
        return (self.collection, str(self.replica_placement), str(self.ttl),
                self.disk_type)


@dataclass
class EcShardInfo:
    volume_id: int
    collection: str
    shard_bits: int
    disk_type: str = "hdd"
    destroy_time: int = 0  # fork: EC TTL


class Disk:
    def __init__(self, disk_type: str, max_volume_count: int = 0):
        self.type = disk_type
        self.max_volume_count = max_volume_count
        self.volumes: dict[int, VolumeInfo] = {}
        self.ec_shards: dict[int, EcShardInfo] = {}

    @property
    def volume_count(self) -> int:
        return len(self.volumes)

    @property
    def ec_shard_count(self) -> int:
        return sum(ec_accounting.shard_count(s.shard_bits)
                   for s in self.ec_shards.values())

    def free_slots(self, ec_shards_per_slot: int = 14) -> int:
        used = self.volume_count + (self.ec_shard_count + ec_shards_per_slot - 1) // ec_shards_per_slot
        return max(0, self.max_volume_count - used)


class DataNode:
    def __init__(self, ip: str, port: int, grpc_port: int = 0,
                 public_url: str = "", rack: "Rack | None" = None):
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port or port + 10000
        self.public_url = public_url or f"{ip}:{port}"
        self.rack = rack
        self.disks: dict[str, Disk] = {}
        self.last_seen = time.monotonic()  # staleness clock, not wall
        self.max_file_key = 0

    @property
    def id(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def grpc_address(self) -> str:
        return f"{self.ip}:{self.grpc_port}"

    def disk(self, disk_type: str) -> Disk:
        d = self.disks.get(disk_type)
        if d is None:
            d = self.disks[disk_type] = Disk(disk_type)
        return d

    def all_volumes(self):
        for d in self.disks.values():
            yield from d.volumes.values()

    def all_ec_shards(self):
        for d in self.disks.values():
            yield from d.ec_shards.values()

    def free_slots(self, disk_type: str) -> int:
        d = self.disks.get(disk_type)
        return d.free_slots() if d else 0


class Rack:
    def __init__(self, rid: str, dc: "DataCenter"):
        self.id = rid
        self.dc = dc
        self.nodes: dict[str, DataNode] = {}


class DataCenter:
    def __init__(self, did: str):
        self.id = did
        self.racks: dict[str, Rack] = {}

    def rack(self, rid: str) -> Rack:
        r = self.racks.get(rid)
        if r is None:
            r = self.racks[rid] = Rack(rid, self)
        return r


class Topology:
    """Reference topology.go:59. Thread-safe via one coarse lock (the master
    is control-plane only; contention is low)."""

    def __init__(self, volume_size_limit: int = 30_000 * 1024 * 1024):
        self.lock = threading.RLock()
        self.dcs: dict[str, DataCenter] = {}
        self.volume_size_limit = volume_size_limit
        self.max_volume_id = 0
        # vid -> {node_id: DataNode} for normal volumes
        self.volume_locations: dict[int, dict[str, DataNode]] = {}
        # vid -> {shard_id -> set[node_id]}, and vid -> collection
        self.ec_locations: dict[int, dict[int, set[str]]] = {}
        self.ec_collections: dict[int, str] = {}
        # vid -> stripe-width high-water mark (max shard id ever seen + 1):
        # heartbeats don't carry RS(k,m), so the health plane infers each
        # volume's expected n from the ids observed over time — robust to
        # later shard loss, reset only when the volume itself goes away
        self.ec_expected: dict[int, int] = {}
        self.nodes: dict[str, DataNode] = {}

    # -- registration ------------------------------------------------------
    def get_or_create_node(self, ip: str, port: int, grpc_port: int,
                           public_url: str, dc: str, rack: str,
                           max_volume_counts: dict[str, int]) -> DataNode:
        with self.lock:
            nid = f"{ip}:{port}"
            node = self.nodes.get(nid)
            if node is None:
                dco = self.dcs.setdefault(dc or "DefaultDataCenter",
                                          DataCenter(dc or "DefaultDataCenter"))
                ro = dco.rack(rack or "DefaultRack")
                node = DataNode(ip, port, grpc_port, public_url, ro)
                ro.nodes[nid] = node
                self.nodes[nid] = node
            for dtype, cnt in (max_volume_counts or {}).items():
                node.disk(dtype).max_volume_count = cnt
            node.last_seen = time.monotonic()
            return node

    def sync_volumes(self, node: DataNode, volumes: list[VolumeInfo]
                     ) -> tuple[list[VolumeInfo], list[VolumeInfo]]:
        """Full-state sync; returns (new, deleted) (topology.go:322)."""
        with self.lock:
            incoming = {v.id: v for v in volumes}
            existing = {v.id: v for v in node.all_volumes()}
            new, deleted = [], []
            for vid, v in incoming.items():
                self.max_volume_id = max(self.max_volume_id, vid)
                if vid not in existing:
                    new.append(v)
                node.disk(v.disk_type).volumes[vid] = v
                self.volume_locations.setdefault(vid, {})[node.id] = node
            for vid, v in existing.items():
                if vid not in incoming:
                    deleted.append(v)
                    for d in node.disks.values():
                        d.volumes.pop(vid, None)
                    locs = self.volume_locations.get(vid)
                    if locs:
                        locs.pop(node.id, None)
                        if not locs:
                            self.volume_locations.pop(vid, None)
            return new, deleted

    def incremental_volumes(self, node: DataNode, new: list[VolumeInfo],
                            deleted: list[VolumeInfo]) -> None:
        with self.lock:
            for v in new:
                self.max_volume_id = max(self.max_volume_id, v.id)
                node.disk(v.disk_type).volumes[v.id] = v
                self.volume_locations.setdefault(v.id, {})[node.id] = node
            for v in deleted:
                for d in node.disks.values():
                    d.volumes.pop(v.id, None)
                locs = self.volume_locations.get(v.id)
                if locs:
                    locs.pop(node.id, None)
                    if not locs:
                        self.volume_locations.pop(v.id, None)

    def sync_ec_shards(self, node: DataNode, shards: list[EcShardInfo]
                       ) -> tuple[list[EcShardInfo], list[EcShardInfo]]:
        """Full EC-shard sync (topology_ec.go:16 SyncDataNodeEcShards)."""
        with self.lock:
            incoming = {s.volume_id: s for s in shards}
            existing = {s.volume_id: s for s in node.all_ec_shards()}
            new, deleted = [], []
            for vid, s in incoming.items():
                if vid not in existing or existing[vid].shard_bits != s.shard_bits:
                    new.append(s)
                node.disk(s.disk_type).ec_shards[vid] = s
                self.ec_collections[vid] = s.collection
                self._note_ec_width(vid, s.shard_bits)
                locs = self.ec_locations.setdefault(vid, {})
                # full-state diff needs the ABSENT ids too (discard arm)
                for sid in range(ec_accounting.MAX_SHARD_ID):
                    if s.shard_bits >> sid & 1:
                        locs.setdefault(sid, set()).add(node.id)
                    else:
                        locs.get(sid, set()).discard(node.id)
            for vid, s in existing.items():
                if vid not in incoming:
                    deleted.append(s)
                    self._drop_node_ec(node, vid)
            return new, deleted

    def incremental_ec_shards(self, node: DataNode, new: list[EcShardInfo],
                              deleted: list[EcShardInfo]) -> None:
        with self.lock:
            for s in new:
                cur = node.disk(s.disk_type).ec_shards.get(s.volume_id)
                bits = (cur.shard_bits if cur else 0) | s.shard_bits
                node.disk(s.disk_type).ec_shards[s.volume_id] = EcShardInfo(
                    s.volume_id, s.collection, bits, s.disk_type, s.destroy_time)
                self.ec_collections[s.volume_id] = s.collection
                self._note_ec_width(s.volume_id, s.shard_bits)
                locs = self.ec_locations.setdefault(s.volume_id, {})
                for sid in ec_accounting.shard_ids(s.shard_bits):
                    locs.setdefault(sid, set()).add(node.id)
            for s in deleted:
                for d in node.disks.values():
                    cur = d.ec_shards.get(s.volume_id)
                    if cur:
                        cur.shard_bits &= ~s.shard_bits
                        if cur.shard_bits == 0:
                            d.ec_shards.pop(s.volume_id, None)
                locs = self.ec_locations.get(s.volume_id, {})
                for sid in ec_accounting.shard_ids(s.shard_bits):
                    locs.get(sid, set()).discard(node.id)

    def _note_ec_width(self, vid: int, shard_bits: int) -> None:
        # lock held by caller
        ids = ec_accounting.shard_ids(shard_bits)
        if ids:
            self.ec_expected[vid] = max(self.ec_expected.get(vid, 0),
                                        ids[-1] + 1)

    def _drop_node_ec(self, node: DataNode, vid: int) -> None:
        for d in node.disks.values():
            d.ec_shards.pop(vid, None)
        locs = self.ec_locations.get(vid, {})
        for sid in list(locs):
            locs[sid].discard(node.id)
            if not locs[sid]:
                locs.pop(sid)
        if not locs:
            self.ec_locations.pop(vid, None)
            self.ec_collections.pop(vid, None)
            self.ec_expected.pop(vid, None)

    def unregister_node(self, node: DataNode) -> tuple[list[int], list[int]]:
        """Node death: remove all its volumes/shards; returns (vids, ec_vids)
        whose location sets changed (master_grpc_server.go:64-96)."""
        with self.lock:
            vids = [v.id for v in node.all_volumes()]
            ec_vids = [s.volume_id for s in node.all_ec_shards()]
            for vid in vids:
                locs = self.volume_locations.get(vid)
                if locs:
                    locs.pop(node.id, None)
                    if not locs:
                        self.volume_locations.pop(vid, None)
            for vid in ec_vids:
                self._drop_node_ec(node, vid)
            for d in node.disks.values():
                d.volumes.clear()
                d.ec_shards.clear()
            if node.rack:
                node.rack.nodes.pop(node.id, None)
            self.nodes.pop(node.id, None)
            return vids, ec_vids

    # -- lookup ------------------------------------------------------------
    def lookup(self, vid: int) -> list[DataNode]:
        with self.lock:
            return list(self.volume_locations.get(vid, {}).values())

    def lookup_ec(self, vid: int) -> dict[int, list[DataNode]]:
        with self.lock:
            out = {}
            for sid, nids in self.ec_locations.get(vid, {}).items():
                holders = [self.nodes[n] for n in nids if n in self.nodes]
                if holders:  # fully-evacuated shard ids are not locations
                    out[sid] = holders
            return out

    def next_volume_id(self) -> int:
        with self.lock:
            self.max_volume_id += 1
            return self.max_volume_id

    def all_nodes(self) -> list[DataNode]:
        with self.lock:
            return list(self.nodes.values())

    def collections(self) -> set[str]:
        with self.lock:
            out = set()
            for node in self.nodes.values():
                for v in node.all_volumes():
                    out.add(v.collection)
                for s in node.all_ec_shards():
                    out.add(s.collection)
            return out
