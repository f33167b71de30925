"""VolumeGrowth: pick servers for new volume replica sets and allocate.

Reference: weed/topology/volume_growth.go:94 (AutomaticGrowByType),
:147 (findEmptySlotsForOneVolume), :245 (grow + AllocateVolume RPC). The
replica placement xyz code decides the spread: first server in some rack,
`same_rack` more in that rack, `other_rack` in other racks of the same DC,
`other_dc` in other data centers.

Candidate picks inside each structural slot go through the placement
engine's shared scoring core (seaweedfs_tpu/placement/engine.py): free
slots, byte load (volume AND EC shard bytes), and live breaker state
rank the candidates, so a half-dead or shard-crushed node stops winning
placements just because it has free slots. All randomness flows through
ONE injectable `random.Random` (`rng=`) — tests seed it and the pick
paths become reproducible (the spread property tests pin the
same_rack/other_rack contract across randomized topologies).

The port's copy of seaweedfs_tpu/master/volume_growth.py.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..storage.types import ReplicaPlacement
from ..utils.log import logger
from .topology import DataNode, Topology

log = logger("growth")


@dataclass
class GrowRequest:
    collection: str = ""
    replication: str = "000"
    ttl: str = ""
    disk_type: str = "hdd"
    preferred_dc: str = ""
    preferred_rack: str = ""
    preferred_node: str = ""
    count: int = 1


class VolumeGrowth:
    def __init__(self, topo: Topology, allocate_fn=None,
                 rng: "random.Random | None" = None, costs_fn=None):
        """allocate_fn(node, vid, req) performs the AllocateVolume RPC; tests
        inject a fake. `rng` seeds every shuffle/choice in the pick paths
        (tests pin it; production uses the module-global stream).
        `costs_fn() -> LinkCostModel | None` (geo plane) prices the
        other-DC replica choice — called lazily so the master can wire
        it before its policy parses."""
        self.topo = topo
        self.allocate_fn = allocate_fn
        self.rng = rng if rng is not None else random
        self.costs_fn = costs_fn

    def find_slots(self, req: GrowRequest) -> list[DataNode]:
        """Pick a replica set honoring the placement code, or raise."""
        rp = ReplicaPlacement.parse(req.replication)
        with self.topo.lock:
            dcs = list(self.topo.dcs.values())
            # shuffle-then-stable-sort: DCs rank by free capacity
            # (emptiest first) with ties staying randomized — repeated
            # grows fill the fleet evenly instead of coin-flipping
            self.rng.shuffle(dcs)
            dcs.sort(key=lambda d: -self._dc_free(d, req.disk_type))
            main_dc = None
            for dc in dcs:
                if req.preferred_dc and dc.id != req.preferred_dc:
                    continue
                # need rp.other_dc other DCs with >=1 free slot
                others = [d for d in dcs if d.id != dc.id
                          and self._dc_free(d, req.disk_type) >= 1]
                if len(others) < rp.other_dc:
                    continue
                picked = self._pick_in_dc(dc, rp, req)
                if picked is None:
                    continue
                main_dc = dc
                servers = picked
                for d in self._order_other_dcs(others, dc, rp.other_dc):
                    n = self._pick_one(self._dc_nodes(d), req)
                    if n is None:
                        break
                    servers.append(n)
                else:
                    return servers
            if main_dc is None:
                raise RuntimeError(
                    f"no free volume slots for replication {req.replication} "
                    f"disk {req.disk_type}")
            raise RuntimeError("insufficient data centers for replication")

    def _order_other_dcs(self, others: list, main_dc, k: int) -> list:
        """The `k` other DCs an other_dc replica lands in. Geo-blind:
        a plain random sample (the historical behavior). With a link
        cost model: a random permutation stably re-sorted by link cost
        from the main DC, so the CHEAPEST cross-DC links carry replica
        traffic first and equal-cost ties stay randomized — on a fleet
        with uniform cross-DC pricing this degrades to the exact
        random sample."""
        costs = self.costs_fn() if self.costs_fn is not None else None
        if costs is None:
            return self.rng.sample(others, k)
        chosen = self.rng.sample(others, len(others))
        chosen.sort(key=lambda d: costs.cost(main_dc.id, "", d.id, ""))
        return chosen[:k]

    def _dc_nodes(self, dc) -> list[DataNode]:
        return [n for r in dc.racks.values() for n in r.nodes.values()]

    def _dc_free(self, dc, disk_type: str) -> int:
        return sum(n.free_slots(disk_type) for n in self._dc_nodes(dc))

    def _pick_one(self, nodes: list[DataNode], req: GrowRequest,
                  exclude: set[str] = frozenset()) -> DataNode | None:
        """Best candidate by the shared placement score (free ratio,
        byte load incl. EC shards, breaker state); exact-score ties
        break through self.rng so a seeded run is reproducible."""
        cands = [n for n in nodes if n.id not in exclude
                 and n.free_slots(req.disk_type) >= 1
                 and (not req.preferred_node or n.id == req.preferred_node)]
        if not cands:
            return None
        from ..placement import engine as placement_engine
        views = [placement_engine.view_of_data_node(
            n, self.topo.volume_size_limit, disk_type=req.disk_type)
            for n in cands]
        best = placement_engine.pick_best(views, rng=self.rng)
        return next(n for n in cands if n.id == best.id)

    def _pick_in_dc(self, dc, rp: ReplicaPlacement, req: GrowRequest
                    ) -> list[DataNode] | None:
        racks = list(dc.racks.values())
        # same shuffle-then-sort as DCs: the emptiest rack hosts the
        # next volume (rack-level even fill), random only across ties
        self.rng.shuffle(racks)
        racks.sort(key=lambda r: -sum(n.free_slots(req.disk_type)
                                      for n in r.nodes.values()))
        for rack in racks:
            if req.preferred_rack and rack.id != req.preferred_rack:
                continue
            other_racks = [r for r in racks if r.id != rack.id
                           and any(n.free_slots(req.disk_type) >= 1
                                   for n in r.nodes.values())]
            if len(other_racks) < rp.other_rack:
                continue
            # same_rack + 1 servers inside this rack
            nodes = list(rack.nodes.values())
            picked: list[DataNode] = []
            used: set[str] = set()
            for _ in range(rp.same_rack + 1):
                n = self._pick_one(nodes, req, exclude=used)
                if n is None:
                    picked = []
                    break
                picked.append(n)
                used.add(n.id)
            if not picked:
                continue
            for r in self.rng.sample(other_racks, rp.other_rack):
                n = self._pick_one(list(r.nodes.values()), req)
                if n is None:
                    return None
                picked.append(n)
            return picked
        return None

    def grow(self, req: GrowRequest) -> list[tuple[int, list[DataNode]]]:
        """Allocate req.count new volumes; returns [(vid, servers)]."""
        out = []
        for _ in range(max(1, req.count)):
            servers = self.find_slots(req)
            vid = self.topo.next_volume_id()
            ok = True
            for node in servers:
                if self.allocate_fn is not None:
                    try:
                        self.allocate_fn(node, vid, req)
                    except Exception as e:  # noqa: BLE001
                        log.warning("allocate vid=%d on %s failed: %s",
                                    vid, node.id, e)
                        ok = False
                        break
            if ok:
                out.append((vid, servers))
        if not out:
            raise RuntimeError("volume growth failed on all candidates")
        return out
