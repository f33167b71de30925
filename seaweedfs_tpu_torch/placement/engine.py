"""Placement engine: ONE scoring core for admission-time placement and
rebalance.

The scale-out plane's first principle (ROADMAP; the Facebook
warehouse-cluster study, PAPERS arXiv:1309.0186) is that placement is a
*cost* decision, not a count decision: repair and rebalance traffic
dominate cross-rack links at scale, so where a replica / EC shard / new
volume lands must weigh

  * free capacity (free volume slots as the byte-capacity proxy the
    heartbeat actually carries),
  * current BYTE load — live volume bytes plus EC shard bytes, so a
    shard-heavy server stops masquerading as empty (the old
    volume.balance counted only volume_infos and kept piling volumes
    onto EC-loaded nodes),
  * failure-domain spread (rack, then DC), and
  * live circuit-breaker state (a half-dead node must not win a
    placement just because it is empty — it is empty *because* it is
    half-dead).

Every consumer — VolumeGrowth replica picks, VolumeLayout's
pick_for_write, ec.encode's shard spread, and the rebalance planner
(placement/plan.py) — scores candidates through `score()` so placement
and balance can never disagree about what "loaded" means.

The scoring formula (documented in README "Placement & rebalance"):

    score(node) =  W_FREE    * free_slots / max_slots
                 - W_LOAD    * load_bytes / max(load_bytes over cohort)
                 - W_RACK    * [node.rack in avoid_racks]
                 - W_DC      * [node.dc   in avoid_dcs]
                 - W_BREAKER * breaker_penalty(node)    # open=1, half=¼

Higher is better; exact ties break randomly through the caller's seeded
RNG so placement is reproducible under test and spreads under load.

The port's copy of seaweedfs_tpu/placement/engine.py.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..utils.log import logger

log = logger("placement")

# scoring weights — spread beats load beats free space beats breaker
# nuance; a fully-open breaker is close to disqualifying
W_FREE = 1.0
W_LOAD = 0.5
W_RACK = 1.5
W_DC = 0.75
W_BREAKER = 2.0
# geo link-cost term: kept strictly below W_DC so failure-
# domain spread still beats cheapness — geo only ORDERS candidates that
# spread equally (the cheapest other-DC wins, never the same DC twice)
W_GEO = 0.6

# fallback per-shard byte estimate divisor when no geometry probe
# reached a stripe: a shard of RS(d,p) holds ~1/d of the volume, and
# the reference default d=10 makes a conservative (small) estimate —
# better than the zero the old balance code effectively used
DEFAULT_SHARD_DIVISOR = 10


@dataclass
class NodeView:
    """One volume server as the engine scores it — buildable from a live
    master Topology (snapshot_from_topology) or a shell VolumeList dump
    (snapshot_from_servers), so master-side placement and shell-side
    rebalance run the same arithmetic."""
    id: str
    rack: str = ""
    dc: str = ""
    grpc_port: int = 0
    max_slots: int = 0
    free_slots: int = 0
    # vid -> {"size": int, "collection": str}
    volumes: dict = field(default_factory=dict)
    # vid -> {"collection": str, "shard_ids": [int], "shard_bytes": int}
    ec_shards: dict = field(default_factory=dict)

    @property
    def volume_bytes(self) -> int:
        return sum(v["size"] for v in self.volumes.values())

    @property
    def ec_bytes(self) -> int:
        return sum(len(s["shard_ids"]) * s["shard_bytes"]
                   for s in self.ec_shards.values())

    @property
    def load_bytes(self) -> int:
        """The honest load: volume bytes AND EC shard bytes (the
        satellite fix — an EC-shard-heavy server is not empty)."""
        return self.volume_bytes + self.ec_bytes

    @property
    def free_ratio(self) -> float:
        return self.free_slots / self.max_slots if self.max_slots else 0.0


@dataclass
class Snapshot:
    """One topology snapshot the planner/engine works against. Built
    once per operation; callers update it locally as moves land instead
    of re-collecting (re-collecting mid-plan races heartbeats)."""
    nodes: list

    def by_id(self) -> dict:
        return {n.id: n for n in self.nodes}

    def racks(self) -> dict:
        out: dict[str, list] = {}
        for n in self.nodes:
            out.setdefault(n.rack, []).append(n)
        return out

    def max_load(self) -> int:
        return max((n.load_bytes for n in self.nodes), default=0)


def _breaker_penalty(node_id: str) -> float:
    """0 = healthy, ¼ = half-open (probing), 1 = open (failing)."""
    try:
        from ..utils import retry
        state = retry.breaker(node_id).state
        if state == retry.OPEN:
            return 1.0
        if state == retry.HALF_OPEN:
            return 0.25
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (breaker registry is best-effort advice)
        pass
    return 0.0


def geo_penalty(costs, origin, node: NodeView) -> float:
    """Normalized [0, 1] link-cost penalty of reaching `node` from
    `origin` = (dc, rack): 0 on the cheapest link class, 1 on the
    priciest known (cross-DC incl. overrides). None costs/origin -> 0,
    so geo-blind callers pay nothing."""
    if costs is None or origin is None:
        return 0.0
    c = costs.cost(origin[0], origin[1], node.dc, node.rack)
    worst = max([costs.cross_dc, *costs.overrides.values()])
    span = worst - costs.intra_rack
    return (c - costs.intra_rack) / span if span > 0 else 0.0


def score(node: NodeView, cohort_max_load: int = 0,
          avoid_racks=(), avoid_dcs=(), costs=None, origin=None) -> float:
    """The one scoring formula (module docstring). `cohort_max_load`
    normalizes the byte-load term across the candidate set; `costs` (a
    geo LinkCostModel) + `origin` (dc, rack) add the W_GEO-weighted
    link-cost term for placements that copy bytes from somewhere."""
    s = W_FREE * node.free_ratio
    if cohort_max_load > 0:
        s -= W_LOAD * (node.load_bytes / cohort_max_load)
    if node.rack and node.rack in avoid_racks:
        s -= W_RACK
    if node.dc and node.dc in avoid_dcs:
        s -= W_DC
    s -= W_GEO * geo_penalty(costs, origin, node)
    s -= W_BREAKER * _breaker_penalty(node.id)
    return s


def rank(nodes: list, rng: "random.Random | None" = None,
         avoid_racks=(), avoid_dcs=(), costs=None, origin=None) -> list:
    """Candidates best-first; exact-score ties shuffled by `rng` (seeded
    by tests, module-global `random` otherwise) then id-ordered so a
    seeded run is fully deterministic."""
    if not nodes:
        return []
    rng = rng or random
    cohort_max = max(n.load_bytes for n in nodes)
    jitter = {n.id: rng.random() for n in nodes}
    return sorted(nodes, key=lambda n: (
        -score(n, cohort_max, avoid_racks, avoid_dcs, costs, origin),
        jitter[n.id], n.id))


def pick_best(nodes: list, rng: "random.Random | None" = None,
              avoid_racks=(), avoid_dcs=(), costs=None, origin=None):
    """The single best candidate (ties random through rng), or None."""
    ranked = rank(nodes, rng, avoid_racks, avoid_dcs, costs, origin)
    return ranked[0] if ranked else None


# -- snapshots ---------------------------------------------------------------

def snapshot_from_servers(servers: list, shard_bytes_of=None,
                          default_shard_bytes: int = 0) -> Snapshot:
    """Build a Snapshot from `CommandEnv.collect_volume_servers()` dicts
    (the shell/VolumeList side). `shard_bytes_of(vid, collection) ->
    int|None` is an optional read-only probe (maintenance's
    VolumeEcShardsInfo sweep) for real per-shard bytes; without an
    answer the per-shard size falls back to `default_shard_bytes`."""
    from .. import ec as ec_accounting
    shard_bytes_memo: dict[int, int] = {}

    def _shard_bytes(vid: int, collection: str) -> int:
        if vid in shard_bytes_memo:
            return shard_bytes_memo[vid]
        size = None
        if shard_bytes_of is not None:
            try:
                size = shard_bytes_of(vid, collection)
            except Exception as e:  # noqa: BLE001 — probe is best-effort
                log.debug("shard byte probe for %s failed: %s", vid, e)
        shard_bytes_memo[vid] = size or default_shard_bytes
        return shard_bytes_memo[vid]

    nodes = []
    for srv in servers:
        view = NodeView(id=srv["id"], rack=srv.get("rack", ""),
                        dc=srv.get("dc", ""),
                        grpc_port=srv.get("grpc_port", 0))
        for disk in srv["disks"].values():
            view.max_slots += disk.max_volume_count
            view.free_slots += disk.free_volume_count
            for v in disk.volume_infos:
                view.volumes[v.id] = {"size": v.size,
                                      "collection": v.collection}
            for s in disk.ec_shard_infos:
                sids = ec_accounting.shard_ids(s.ec_index_bits)
                if not sids:
                    continue
                view.ec_shards[s.id] = {
                    "collection": s.collection, "shard_ids": sids,
                    "shard_bytes": _shard_bytes(s.id, s.collection)}
        nodes.append(view)
    return Snapshot(nodes=sorted(nodes, key=lambda n: n.id))


def view_of_data_node(n, volume_size_limit: int,
                      disk_type: str = "") -> NodeView:
    """ONE NodeView constructor for master-side DataNodes — VolumeGrowth
    picks and snapshot_from_topology both call this, so the two can't
    drift on what a node's load means. Slots count only `disk_type`
    disks when given (placement targets a tier); BYTES count every
    disk — load is load wherever it sits. EC shard bytes are estimated
    from the volume size limit (heartbeats don't carry shard sizes)."""
    from .. import ec as ec_accounting
    est_shard = volume_size_limit // DEFAULT_SHARD_DIVISOR
    view = NodeView(
        id=n.id,
        rack=n.rack.id if n.rack else "",
        dc=n.rack.dc.id if n.rack else "",
        grpc_port=n.grpc_port)
    for dtype, d in n.disks.items():
        if not disk_type or dtype == disk_type:
            view.max_slots += d.max_volume_count
            view.free_slots += d.free_slots()
        for vid, v in d.volumes.items():
            view.volumes[vid] = {"size": v.size,
                                 "collection": v.collection}
        for vid, s in d.ec_shards.items():
            sids = ec_accounting.shard_ids(s.shard_bits)
            if sids:
                view.ec_shards[vid] = {
                    "collection": s.collection,
                    "shard_ids": sids,
                    "shard_bytes": est_shard}
    return view


def snapshot_from_topology(topo, disk_type: str = "") -> Snapshot:
    """Build a Snapshot from the master's live Topology (the
    VolumeGrowth / pick_for_write side)."""
    with topo.lock:
        nodes = [view_of_data_node(n, topo.volume_size_limit, disk_type)
                 for n in topo.nodes.values()]
    return Snapshot(nodes=sorted(nodes, key=lambda n: n.id))


# -- EC shard spread ---------------------------------------------------------

def spread_ec_shards(snapshot: Snapshot, n_shards: int, parity: int,
                     rng: "random.Random | None" = None,
                     vid: int = 0, costs=None, origin=None) -> list:
    """Assign each of a stripe's `n_shards` shards to a NodeView such
    that NO RACK holds more than `parity` shards — rack loss then costs
    at most p shards, which RS(d,p) reconstructs: rack loss ≠ data
    loss, for RS(14,2) (16 shards: needs ≥8 racks) and RS(10,4)
    (needs ≥4) alike.

    When the topology simply cannot honor the cap (fewer than
    ceil(n/p) racks — the single-rack dev box), the spread degrades
    gracefully: racks stay as even as possible (minimal max-per-rack)
    and the shortfall is logged once, not raised — encoding must not
    fail because the fleet is small.

    Within the rack constraint, shards go to the best-scoring node
    (shared `score()` core) that holds the fewest shards of this stripe
    so far, so node loss also costs the fewest shards. Returns a list
    of length `n_shards` (node per shard id)."""
    if not snapshot.nodes:
        raise RuntimeError("no volume servers to spread ec shards onto")
    rng = rng or random
    parity = max(1, parity)
    n_racks = len({n.rack for n in snapshot.nodes})
    feasible = n_racks * parity >= n_shards
    if not feasible and n_racks > 1:
        log.warning(
            "ec spread vid=%s: %d racks cannot cap %d shards at %d/rack; "
            "falling back to most-even rack spread", vid, n_racks,
            n_shards, parity)
    rack_count: dict[str, int] = {}
    node_count: dict[str, int] = {}
    cohort_max = snapshot.max_load()
    jitter = {n.id: rng.random() for n in snapshot.nodes}
    out = []
    # even fallback cap when infeasible: ceil(n_shards / n_racks)
    cap = parity if feasible else -(-n_shards // max(1, n_racks))
    for _sid in range(n_shards):
        cands = [n for n in snapshot.nodes
                 if rack_count.get(n.rack, 0) < cap]
        if not cands:
            cands = list(snapshot.nodes)  # cap exhausted: stay even
        best = min(cands, key=lambda n: (
            node_count.get(n.id, 0), rack_count.get(n.rack, 0),
            -score(n, cohort_max, costs=costs, origin=origin),
            jitter[n.id], n.id))
        out.append(best)
        node_count[best.id] = node_count.get(best.id, 0) + 1
        rack_count[best.rack] = rack_count.get(best.rack, 0) + 1
    return out
