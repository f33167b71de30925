"""The port's master (seaweedfs_tpu_torch/master/) held against the JAX
package's, in process and byte for byte: one numpy-seeded heartbeat
sequence (registrations, volume and EC shard churn, a node leaving) fed
into a master of each package gives equal
`TopologyInfo.SerializeToString(deterministic=True)`; with the module
`random` seeded alike before each call, equal Assign responses (single
fids, fid-range leases, and assigns that must grow a volume, whose picks
go through a recording allocator); equal LookupVolume and LookupEcVolume
answers from the gRPC service bodies; and JSON-equal health reports
(`master.health.evaluate`) and repair plans (`maintenance.build_plan`)
from seeded snapshots."""

import json
import random

import numpy as np
import pytest

from seaweedfs_tpu import maintenance as ref_maintenance
from seaweedfs_tpu.master import health as ref_health
from seaweedfs_tpu.master.master_server import MasterServer as RefMaster
from seaweedfs_tpu.master.topology import VolumeInfo as RefVolumeInfo
from seaweedfs_tpu.pb import master_pb2 as ref_pb
from seaweedfs_tpu.storage.types import ReplicaPlacement as RefPlacement
from seaweedfs_tpu_torch import maintenance
from seaweedfs_tpu_torch.master import health
from seaweedfs_tpu_torch.master.master_server import MasterServer
from seaweedfs_tpu_torch.master.topology import VolumeInfo
from seaweedfs_tpu_torch.pb import master_pb2 as pb
from seaweedfs_tpu_torch.storage.types import ReplicaPlacement

N_NODES = 6


class _Context:
    """The two methods a unary service body may call on its context."""

    def invocation_metadata(self):
        return ()

    def abort(self, code, message):
        raise RuntimeError(f"abort {code}: {message}")


def heartbeat_rounds(seed: int) -> "list[list[dict]]":
    """Plain heartbeats of N_NODES servers over three rounds: full state,
    then churn (volumes dropped and added, EC shards moved), then a
    round where node 0 is gone."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(N_NODES):
        port = 8080 + i
        nodes.append({
            "ip": "127.0.0.1", "port": port, "grpc_port": port + 10000,
            "public_url": f"127.0.0.1:{port}",
            "data_center": f"dc{i % 2}", "rack": f"r{i % 3}",
            "max_volume_counts": {"hdd": int(rng.integers(8, 20))},
            "max_file_key": int(rng.integers(1, 1 << 20))})
    vids = list(range(1, 13))
    holders = {v: sorted(int(x) for x in rng.choice(
        N_NODES, int(rng.integers(1, 3)), replace=False)) for v in vids}
    coll = {v: str(rng.choice(["", "pics", "logs"])) for v in vids}
    rp = {v: ("001" if len(holders[v]) == 2 else "000") for v in vids}
    ec_bits = {20: [0] * N_NODES, 21: [0] * N_NODES}
    for vid in ec_bits:
        for sid in range(14):
            ec_bits[vid][int(rng.integers(0, N_NODES))] |= 1 << sid

    def round_of(skip=(), dropped=(), extra=None):
        out = []
        for i, n in enumerate(nodes):
            if i in skip:
                continue
            vols = []
            for v in vids:
                if i in holders[v] and v not in dropped:
                    vols.append({
                        "id": v, "collection": coll[v],
                        "size": int(rng.integers(0, 1 << 30)),
                        "file_count": int(rng.integers(0, 5000)),
                        "delete_count": int(rng.integers(0, 50)),
                        "deleted_byte_count": int(rng.integers(0, 1 << 20)),
                        "read_only": bool(rng.integers(0, 8) == 0),
                        "replica_placement": RefPlacement.parse(
                            rp[v]).to_byte(),
                        "version": 3, "disk_type": "hdd"})
            if extra and i in extra:
                vols.append(extra[i])
            ecs = [{"id": vid, "collection": "ec",
                    "ec_index_bits": bits[i], "disk_type": "hdd"}
                   for vid, bits in ec_bits.items() if bits[i]]
            out.append({**n, "volumes": vols, "ec_shards": ecs,
                        "has_no_volumes": not vols,
                        "has_no_ec_shards": not ecs})
        return out

    first = round_of()
    # churn: two volumes dropped, one new volume on node 3, a shard of
    # EC volume 20 moved from its holder to another node
    moved_from = next(i for i in range(N_NODES) if ec_bits[20][i])
    low = ec_bits[20][moved_from] & -ec_bits[20][moved_from]
    ec_bits[20][moved_from] &= ~low
    ec_bits[20][(moved_from + 1) % N_NODES] |= low
    second = round_of(dropped=(2, 7), extra={3: {
        "id": 30, "collection": "pics", "size": 4096, "file_count": 3,
        "replica_placement": 0, "version": 3, "disk_type": "hdd"}})
    third = round_of(skip=(0,), dropped=(2, 7))
    return [first, second, third]


def to_pb(mod, hb: dict):
    msg = mod.Heartbeat(
        ip=hb["ip"], port=hb["port"], grpc_port=hb["grpc_port"],
        public_url=hb["public_url"], max_file_key=hb["max_file_key"],
        data_center=hb["data_center"], rack=hb["rack"],
        max_volume_counts=hb["max_volume_counts"],
        has_no_volumes=hb["has_no_volumes"],
        has_no_ec_shards=hb["has_no_ec_shards"])
    for v in hb["volumes"]:
        msg.volumes.add(**v)
    for s in hb["ec_shards"]:
        msg.ec_shards.add(**s)
    return msg


def fed_master(cls, mod, info_cls, placement_cls, seed: int):
    """A master (not started: no ports) fed the seeded heartbeat rounds;
    node 0 leaves before the third, as its stream's end does it. Growth
    goes through a recording allocator that registers like the real
    AllocateVolume path, without the RPC."""
    ms = cls(port=19333, volume_size_limit_mb=1024, pulse_seconds=1.0)
    allocated = []

    def allocate(node, vid, req):
        allocated.append((node.id, vid, req.collection, req.replication))
        v = info_cls(id=vid, collection=req.collection,
                     replica_placement=placement_cls.parse(req.replication),
                     disk_type=req.disk_type)
        ms.topo.incremental_volumes(node, [v], [])
        ms.layouts.register_volume(v)

    ms.growth.allocate_fn = allocate
    handles = {}
    for rnd, beats in enumerate(heartbeat_rounds(seed)):
        if rnd == 2:
            node = handles.pop("127.0.0.1:8080")
            ms.topo.unregister_node(node)
        for hb in beats:
            key = f"{hb['ip']}:{hb['port']}"
            handles[key] = ms._handle_heartbeat(to_pb(mod, hb),
                                                handles.get(key))
    return ms, allocated


@pytest.fixture(scope="module")
def masters():
    got = fed_master(MasterServer, pb, VolumeInfo, ReplicaPlacement, 3)
    want = fed_master(RefMaster, ref_pb, RefVolumeInfo, RefPlacement, 3)
    return got, want


def test_topology_info_bytes_equal(masters):
    (ms, _), (ref, _) = masters
    got = ms.topology_info().SerializeToString(deterministic=True)
    want = ref.topology_info().SerializeToString(deterministic=True)
    assert got == want
    assert len(ms.topo.nodes) == N_NODES - 1
    no_ec = ms.topology_info(include_ec=False)
    assert no_ec.SerializeToString(deterministic=True) == \
        ref.topology_info(include_ec=False).SerializeToString(
            deterministic=True)
    assert ms.topo.max_volume_id == ref.topo.max_volume_id == 30


ASSIGNS = [
    {"count": 1, "collection": "pics"},
    {"count": 1, "collection": ""},
    {"count": 1024, "collection": "logs"},          # a fid-range lease
    {"count": 1, "collection": "fresh"},            # must grow
    {"count": 1, "collection": "fresh", "replication": "010"},
    {"count": 7, "collection": "pics", "writable_volume_count": 3},
]


@pytest.mark.parametrize("k", range(len(ASSIGNS)))
def test_assign_responses_equal(masters, k):
    (ms, got_alloc), (ref, want_alloc) = masters
    out = []
    for m, mod in ((ms, pb), (ref, ref_pb)):
        random.seed(1000 + k)
        resp = m.do_assign(mod.AssignRequest(**ASSIGNS[k]))
        out.append(resp.SerializeToString(deterministic=True))
    assert out[0] == out[1]
    assert not pb.AssignResponse.FromString(out[0]).error
    assert got_alloc == want_alloc
    assert (ms.fid_leases.keys_granted_total, ms.fid_leases.active()) == (
        ref.fid_leases.keys_granted_total, ref.fid_leases.active())


@pytest.mark.parametrize("method,req", [
    ("LookupVolume", {"volume_or_file_ids": ["1", "3", "5,0123456789",
                                             "7", "20", "99", "x"]}),
    ("LookupEcVolume", {"volume_id": 20}),
    ("LookupEcVolume", {"volume_id": 21}),
    ("VolumeList", {}),
    ("Statistics", {"collection": "pics"}),
    ("CollectionList", {}),
    ("EcCollectList", {}),
])
def test_lookup_bodies_equal(masters, method, req):
    (ms, _), (ref, _) = masters
    out = []
    for m, mod in ((ms, pb), (ref, ref_pb)):
        handler = m._build_service()._handlers[method]
        req_cls = {"LookupVolume": mod.LookupVolumeRequest,
                   "LookupEcVolume": mod.LookupEcVolumeRequest,
                   "VolumeList": mod.VolumeListRequest,
                   "Statistics": mod.StatisticsRequest,
                   "CollectionList": mod.CollectionListRequest,
                   "EcCollectList": mod.EcCollectListRequest}[method]
        resp = handler.unary_unary(req_cls(**req), _Context())
        out.append(resp.SerializeToString(deterministic=True))
    assert out[0] == out[1]
    assert out[0]


def seeded_snapshot(seed: int) -> dict:
    """An evaluate() snapshot: replicated volumes at every deficit, EC
    volumes from whole to unreadable, stale and full nodes."""
    rng = np.random.default_rng(seed)
    nodes = [{"id": f"10.0.0.{i}:8080", "age_s": float(rng.integers(0, 40)),
              "used_slots": int(rng.integers(0, 20)), "max_slots": 20,
              "rack": f"r{i % 4}", "dc": f"dc{i % 2}"} for i in range(8)]
    ids = [n["id"] for n in nodes]
    volumes = []
    for vid in range(1, 25):
        expected = int(rng.integers(1, 4))
        present = int(rng.integers(0, expected + 1)) or 1
        volumes.append({
            "id": vid, "collection": str(rng.choice(["", "c"])),
            "present": present, "expected": expected,
            "read_only": bool(rng.integers(0, 6) == 0),
            "size": int(rng.integers(0, 2 << 30)),
            "holders": sorted(str(x) for x in rng.choice(
                ids, present, replace=False))})
    ec_volumes = []
    for vid in range(40, 52):
        lost = int(rng.integers(0, 7))
        present = sorted(int(x) for x in rng.choice(14, 14 - lost,
                                                    replace=False))
        ec_volumes.append({
            "id": vid, "collection": "ec", "present_ids": present,
            "expected_n": 14,
            "holders": sorted(str(x) for x in rng.choice(ids, 4,
                                                         replace=False))})
    return {"volumes": volumes, "ec_volumes": ec_volumes, "nodes": nodes,
            "volume_size_limit": 1 << 30}


def report_json(report: dict) -> str:
    doc = dict(report)
    doc.pop("generated_ms")
    return json.dumps(doc, sort_keys=True)


@pytest.mark.parametrize("seed,parity", [(1, 4), (2, 2), (3, 4)])
def test_health_evaluate_and_repair_plan_json_equal(seed, parity):
    snap = seeded_snapshot(seed)
    got = health.evaluate(snap, parity=parity, stale_after_s=30.0)
    want = ref_health.evaluate(snap, parity=parity, stale_after_s=30.0)
    assert report_json(got) == report_json(want)
    assert {it["severity"] for it in got["items"]} >= {
        health.DEGRADED, health.AT_RISK}

    def probe_geometry(vid, collection):
        return {"codec": "rs", "d": 14 - parity, "p": parity,
                "shard_size": 1 << 20}

    plan = maintenance.build_plan(got, probe_geometry=probe_geometry)
    ref_plan = ref_maintenance.build_plan(want,
                                          probe_geometry=probe_geometry)
    doc, ref_doc = plan.to_dict(), ref_plan.to_dict()
    for d in (doc, ref_doc):
        d.pop("generated_ms", None)
    assert json.dumps(doc, sort_keys=True) == json.dumps(ref_doc,
                                                         sort_keys=True)
    assert plan.items
