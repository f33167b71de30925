"""The port's placement engine and planners (seaweedfs_tpu_torch/placement/)
held against the JAX package's on the same numpy-seeded snapshots: the
rack-capped EC spread (RS(10,4) on four racks, where the cap holds, and
RS(14,2) on too few racks, where it degrades to the most even spread),
the EC and volume balance plans, and VolumeGrowth's picks over a seeded
topology. Every comparison is exact: node ids in order, and the plans'
`to_dict()` JSON but its time stamp. Both sides get their own
`random.Random` of one seed."""

import json
import random

import numpy as np
import pytest

from seaweedfs_tpu import placement as ref_placement
from seaweedfs_tpu.master.topology import Topology as RefTopology
from seaweedfs_tpu.master.volume_growth import GrowRequest as RefGrowRequest
from seaweedfs_tpu.master.volume_growth import VolumeGrowth as RefGrowth
from seaweedfs_tpu_torch import placement
from seaweedfs_tpu_torch.master.topology import Topology
from seaweedfs_tpu_torch.master.volume_growth import GrowRequest, VolumeGrowth


def seeded_fleet(seed: int, n_racks: int, nodes_per_rack: int,
                 ec=((), 0)) -> dict:
    """Plain data of a heterogeneous fleet: slots, volumes and EC shards of
    stripe `ec[1]` on `ec[0]` shard ids, all from a numpy seed."""
    rng = np.random.default_rng(seed)
    nodes = []
    vid = 100
    for r in range(n_racks):
        for i in range(nodes_per_rack):
            cap = int(rng.integers(8, 40))
            vols = {}
            for _ in range(int(rng.integers(0, 6))):
                vid += 1
                vols[vid] = {"size": int(rng.integers(1 << 20, 1 << 30)),
                             "collection": str(rng.choice(["", "c1"]))}
            nodes.append({"id": f"127.0.0.1:{8000 + len(nodes)}",
                          "rack": f"r{r}", "dc": f"dc{r % 2}",
                          "max_slots": cap,
                          "free_slots": cap - len(vols) - int(
                              rng.integers(0, 3)),
                          "volumes": vols, "ec_shards": {}})
    shard_ids, ec_vid = ec
    if shard_ids:
        # the whole stripe starts on a few nodes, as right after a
        # generate on one server
        owners = rng.choice(len(nodes), 2, replace=False)
        for k, sid in enumerate(shard_ids):
            node = nodes[int(owners[k % 2])]
            node["ec_shards"].setdefault(ec_vid, {
                "collection": "ec", "shard_ids": [],
                "shard_bytes": 64 << 20})["shard_ids"].append(sid)
    return {"nodes": nodes}


def plan_json(plan) -> str:
    """A plan's JSON without its wall-clock stamp."""
    doc = plan.to_dict()
    doc.pop("generated_ms")
    return json.dumps(doc, sort_keys=True)


def snapshot(pkg, fleet: dict):
    return pkg.Snapshot(nodes=[pkg.NodeView(
        id=n["id"], rack=n["rack"], dc=n["dc"], grpc_port=18000,
        max_slots=n["max_slots"], free_slots=n["free_slots"],
        volumes={k: dict(v) for k, v in n["volumes"].items()},
        ec_shards={k: {**v, "shard_ids": sorted(v["shard_ids"])}
                   for k, v in n["ec_shards"].items()})
        for n in fleet["nodes"]])


@pytest.mark.parametrize("d,p,n_racks,nodes_per_rack,seed", [
    (10, 4, 4, 1, 1),   # the smoke's layout: the cap holds exactly
    (10, 4, 4, 3, 2),
    (14, 2, 3, 2, 3),   # too few racks: the most even spread
    (14, 2, 8, 1, 4),   # RS(14,2) with its 8 racks
])
def test_spread_ec_shards_matches_reference(d, p, n_racks, nodes_per_rack,
                                            seed):
    fleet = seeded_fleet(seed, n_racks, nodes_per_rack)
    got = placement.spread_ec_shards(snapshot(placement, fleet), d + p, p,
                                     rng=random.Random(seed), vid=7)
    want = ref_placement.spread_ec_shards(
        snapshot(ref_placement, fleet), d + p, p, rng=random.Random(seed),
        vid=7)
    assert [n.id for n in got] == [n.id for n in want]
    per_rack = {}
    for n in got:
        per_rack[n.rack] = per_rack.get(n.rack, 0) + 1
    if n_racks * p >= d + p:
        assert max(per_rack.values()) <= p
    else:
        assert max(per_rack.values()) == -(-(d + p) // n_racks)


@pytest.mark.parametrize("d,p,n_racks,seed", [(10, 4, 4, 5), (14, 2, 3, 6)])
def test_ec_balance_plan_matches_reference(d, p, n_racks, seed):
    fleet = seeded_fleet(seed, n_racks, 2, ec=(list(range(d + p)), 9))
    got = placement.build_ec_balance_plan(snapshot(placement, fleet),
                                          default_parity=p)
    want = ref_placement.build_ec_balance_plan(
        snapshot(ref_placement, fleet), default_parity=p)
    assert got.moves, "the seeded stripe sits on two nodes: moves expected"
    assert plan_json(got) == plan_json(want)


@pytest.mark.parametrize("collection,seed", [(None, 7), ("c1", 8)])
def test_volume_balance_plan_matches_reference(collection, seed):
    fleet = seeded_fleet(seed, 3, 2)
    # one node empty, so the plan has somewhere to go
    fleet["nodes"][0]["volumes"] = {}
    got = placement.build_volume_balance_plan(
        snapshot(placement, fleet), collection=collection)
    want = ref_placement.build_volume_balance_plan(
        snapshot(ref_placement, fleet), collection=collection)
    assert plan_json(got) == plan_json(want)


def _topology(cls, seed: int):
    rng = np.random.default_rng(seed)
    topo = cls(volume_size_limit=1 << 30)
    port = 8000
    for dc in range(2):
        for r in range(3):
            for _ in range(int(rng.integers(1, 4))):
                port += 1
                topo.get_or_create_node("127.0.0.1", port, port + 10000, "",
                                        f"dc{dc}", f"dc{dc}-r{r}",
                                        {"hdd": int(rng.integers(2, 20))})
    return topo


@pytest.mark.parametrize("replication", ["000", "001", "010", "100", "011"])
def test_volume_growth_picks_match_reference(replication):
    picks = []
    for cls, growth_cls, req_cls in ((Topology, VolumeGrowth, GrowRequest),
                                     (RefTopology, RefGrowth, RefGrowRequest)):
        topo = _topology(cls, 11)
        seen = []
        growth = growth_cls(
            topo, allocate_fn=lambda node, vid, req: seen.append(
                (node.id, vid)), rng=random.Random(11))
        out = growth.grow(req_cls(collection="g", replication=replication,
                                  count=4))
        picks.append((seen, [(vid, [n.id for n in nodes])
                             for vid, nodes in out]))
    assert picks[0] == picks[1]
    assert len(picks[0][1]) == 4
