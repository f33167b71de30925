"""Rebalance planner: one topology snapshot in, one deterministic
byte-costed MovePlan out.

The planning mirror of maintenance/planner.py: a pure function over a
Snapshot (no RPCs — `volume.balance -dryRun` prints the exact plan the
executor would run), costed in BYTES like the repair planner's
`bytes_moved`, because the warehouse-cluster study's lesson is that
rebalance traffic competes with repair and foreground reads for the
same cross-rack links:

  * volume balance moves bytes from the most-loaded server toward the
    least-loaded until max/min byte skew converges, counting EC shard
    bytes in the load (an EC-heavy server is NOT an attractive
    destination — the bug the old count-based balancer had);
  * each step moves the single volume whose size best closes the gap
    (moving s bytes closes 2s of spread), cheapest first on ties;
  * intra-rack destinations win over cross-rack ones, and cross-rack
    traffic is CAPPED per run (`cross_rack_limit_bytes`) so a balance
    pass cannot saturate the inter-rack fabric — the remainder waits
    for the next sweep;
  * EC balance evens each stripe's per-server shard counts without ever
    violating the rack-safety cap (≤ parity shards of a stripe per
    rack) and GROUPS shard ids per (volume, src, dst) pair into one
    move — one VolumeEcShardsMove RPC per pair instead of one per
    shard re-collecting the cluster in between.

Plans are deterministic: same snapshot (and probes) in, byte-identical
plan out — the property tests replan and compare.

The port's copy of seaweedfs_tpu/placement/plan.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..utils.log import logger
from .engine import Snapshot

log = logger("placement.plan")

MOVE_VOLUME = "volume"
MOVE_EC = "ec"

# stop when max/min per-server byte load is at or under this (the bench
# gate asserts 1.3; planning a little tighter leaves convergence slack
# for in-flight writes between plan and execution)
DEFAULT_TARGET_SKEW = 1.15
DEFAULT_MAX_MOVES = 64
# per-run cross-rack budget: one default volume (30 GB) worth of bytes;
# shell flag -crossRackLimitMB overrides
DEFAULT_CROSS_RACK_LIMIT = 30 << 30


@dataclass
class Move:
    """One rebalance move: a whole volume, or a group of EC shards of
    one stripe between one (src, dst) pair. `link` is the geo link
    class the bytes cross (policy.LINK_CLASSES) and
    `cost_weighted_bytes` = bytes_moved * that link's cost multiplier —
    the currency plans are ordered and budgeted in."""
    kind: str                # "volume" | "ec"
    vid: int
    collection: str
    src: str                 # node ids
    dst: str
    bytes_moved: int
    cross_rack: bool = False
    shard_ids: list[int] = field(default_factory=list)  # ec only
    link: str = "intra_rack"
    cost_weighted_bytes: int = 0

    def describe(self) -> str:
        what = (f"volume {self.vid}" if self.kind == MOVE_VOLUME
                else f"ec {self.vid} shards {self.shard_ids}")
        hop = self.link.replace("_", "-") if self.link else (
            "cross-rack" if self.cross_rack else "intra-rack")
        return (f"{what} {self.src} -> {self.dst} "
                f"(~{self.bytes_moved:,} B, {hop})")

    def to_dict(self) -> dict:
        return {"kind": self.kind, "vid": self.vid,
                "collection": self.collection, "src": self.src,
                "dst": self.dst, "bytes_moved": self.bytes_moved,
                "cross_rack": self.cross_rack, "link": self.link,
                "cost_weighted_bytes": self.cost_weighted_bytes,
                "shard_ids": list(self.shard_ids)}


@dataclass
class MovePlan:
    moves: list
    skew_before: float
    skew_after: float        # planned (post-simulation) skew
    notes: list = field(default_factory=list)
    generated_ms: int = 0

    def __post_init__(self):
        if not self.generated_ms:
            self.generated_ms = int(time.time() * 1000)

    def __bool__(self) -> bool:
        return bool(self.moves)

    @property
    def total_bytes(self) -> int:
        return sum(m.bytes_moved for m in self.moves)

    @property
    def cross_rack_bytes(self) -> int:
        return sum(m.bytes_moved for m in self.moves if m.cross_rack)

    @property
    def cross_dc_bytes(self) -> int:
        return sum(m.bytes_moved for m in self.moves
                   if m.link == "cross_dc")

    @property
    def cost_weighted_bytes(self) -> int:
        return sum(m.cost_weighted_bytes for m in self.moves)

    def to_dict(self) -> dict:
        return {"moves": [m.to_dict() for m in self.moves],
                "skew_before": round(self.skew_before, 3),
                "skew_after": round(self.skew_after, 3),
                "total_bytes": self.total_bytes,
                "cross_rack_bytes": self.cross_rack_bytes,
                "cross_dc_bytes": self.cross_dc_bytes,
                "cost_weighted_bytes": self.cost_weighted_bytes,
                "notes": list(self.notes),
                "generated_ms": self.generated_ms}

    def render(self, println) -> None:
        println(f"balance plan: {len(self.moves)} move(s), "
                f"{self.total_bytes:,} B total "
                f"({self.cross_rack_bytes:,} B cross-rack, "
                f"{self.cross_dc_bytes:,} B cross-dc, "
                f"{self.cost_weighted_bytes:,} cost-weighted), "
                f"byte skew {self.skew_before:.2f} -> "
                f"{self.skew_after:.2f} (planned)")
        for i, m in enumerate(self.moves, 1):
            println(f"  {i}. {m.describe()}")
        for note in self.notes:
            println(f"  !! {note}")


def _skew(loads: dict) -> float:
    """max/min per-server byte load; empty servers count at 1 byte so
    a fresh node reads as infinitely attractive without dividing by
    zero. 1.0 = perfectly even."""
    if not loads:
        return 1.0
    mx = max(loads.values())
    mn = min(loads.values())
    return mx / max(1, mn)


def build_volume_balance_plan(
        snap: Snapshot, collection: "str | None" = None,
        target_skew: float = DEFAULT_TARGET_SKEW,
        max_moves: int = DEFAULT_MAX_MOVES,
        cross_rack_limit_bytes: int = DEFAULT_CROSS_RACK_LIMIT,
        costs=None) -> MovePlan:
    """Greedy byte balance over one snapshot. Only volumes (optionally
    of one collection) move; EC shard bytes still weigh the load on
    both ends, so a shard-heavy server neither donates volumes it
    doesn't have nor attracts volumes it can't afford.

    `costs` (geo LinkCostModel; default price list when None) prices
    every candidate hop: the greedy key prefers the cheapest link that
    closes a gap — a cross-DC move only plans when no intra-DC fix
    exists — and cross-DC traffic is separately capped by the policy's
    `cross_dc_budget` (0 = unlimited)."""
    from ..geo.policy import LinkCostModel
    costs = costs or LinkCostModel()
    nodes = {n.id: n for n in snap.nodes}
    if len(nodes) < 2:
        return MovePlan([], 1.0, 1.0)
    loads = {nid: n.load_bytes for nid, n in nodes.items()}
    # local holder map for replica-safety (never land a vid on a server
    # already holding it), updated as planned moves land
    holders: dict[int, set] = {}
    vol_state: dict[str, dict] = {}
    # destination slots are debited as planned moves land — the static
    # snapshot alone would let the greedy loop pile more volumes onto a
    # nearly-full node than it has slots, failing at execution time
    free = {nid: n.free_slots for nid, n in nodes.items()}
    # a vid moves AT MOST ONCE per plan: chained A->B then B->C moves
    # of one volume would race under the executor's concurrency (and
    # waste a full copy); the second-best donor volume converges the
    # same bytes in one hop next run
    moved_vids: set[int] = set()
    for nid, n in nodes.items():
        vol_state[nid] = dict(n.volumes)
        for vid in n.volumes:
            holders.setdefault(vid, set()).add(nid)
    skew_before = _skew(loads)
    moves: list[Move] = []
    notes: list[str] = []
    cross_budget = cross_rack_limit_bytes
    dc_budget = costs.cross_dc_budget or float("inf")
    capped = False
    # moves conserve bytes, so the convergence target is fixed up front
    mean = sum(loads.values()) / len(loads)
    while len(moves) < max_moves and _skew(loads) > target_skew:
        order = sorted(loads, key=lambda i: (-loads[i], i))
        # donors most-loaded-first: a node whose load is all EC shards
        # (nothing movable here — ec.balance owns shard moves) must not
        # stall the whole plan, so the search falls through to the next
        # donor that CAN shed
        best = None  # (rank tuple, src_id, vid, v, dst_id, cross)
        for src_id in order[:-1]:
            movable = [
                (vid, v) for vid, v in vol_state[src_id].items()
                if (collection is None or v["collection"] == collection)
                and v["size"] > 0 and vid not in moved_vids]
            if not movable:
                continue
            # pick (volume, dst): moves that keep the destination at or
            # under the fleet mean rank first (no churn — a volume
            # lands once instead of cascading through an overfed
            # neighbor), then intra-rack before cross-rack, then the
            # size that best halves the src->dst gap, cheapest on ties
            for dst_id in order:
                dgap = loads[src_id] - loads[dst_id]
                if dgap <= 0:
                    continue
                s_n, d_n = nodes[src_id], nodes[dst_id]
                link = costs.classify(s_n.dc, s_n.rack, d_n.dc, d_n.rack)
                mult = costs.cost(s_n.dc, s_n.rack, d_n.dc, d_n.rack)
                cross = link != "intra_rack"
                if cross and cross_budget <= 0:
                    capped = True
                    continue
                if link == "cross_dc" and dc_budget <= 0:
                    capped = True
                    continue
                if free[dst_id] <= 0:
                    continue
                for vid, v in movable:
                    if dst_id in holders.get(vid, ()):
                        continue
                    if v["size"] >= dgap:
                        continue  # would overshoot: roles just swap
                    if cross and v["size"] > cross_budget:
                        capped = True
                        continue
                    if link == "cross_dc" and v["size"] > dc_budget:
                        capped = True
                        continue
                    overshoots = loads[dst_id] + v["size"] > mean
                    # link-cost multiplier where the old key held the
                    # cross-rack boolean: identical ordering on a
                    # single-DC fleet (1 < 4 iff False < True), and the
                    # cheapest link wins whenever one closes a gap
                    key = (overshoots, mult,
                           abs(dgap / 2 - v["size"]),
                           v["size"], vid, dst_id)
                    if best is None or key < best[0]:
                        best = (key, src_id, vid, v, dst_id, cross, link,
                                mult)
            if best is not None:
                break
        if best is None:
            if capped:
                notes.append("cross-rack/cross-dc byte budget exhausted; "
                             "remaining skew waits for the next run")
            break
        _, src_id, vid, v, dst_id, cross, link, mult = best
        moves.append(Move(kind=MOVE_VOLUME, vid=vid,
                          collection=v["collection"], src=src_id,
                          dst=dst_id, bytes_moved=v["size"],
                          cross_rack=cross, link=link,
                          cost_weighted_bytes=int(v["size"] * mult)))
        if cross:
            cross_budget -= v["size"]
        if link == "cross_dc":
            dc_budget -= v["size"]
        del vol_state[src_id][vid]
        vol_state[dst_id][vid] = v
        holders[vid].discard(src_id)
        holders[vid].add(dst_id)
        moved_vids.add(vid)
        free[dst_id] -= 1
        free[src_id] += 1
        loads[src_id] -= v["size"]
        loads[dst_id] += v["size"]
    if len(moves) >= max_moves and _skew(loads) > target_skew:
        notes.append(f"move budget ({max_moves}) exhausted at skew "
                     f"{_skew(loads):.2f}")
    return MovePlan(moves, skew_before, _skew(loads), notes=notes)


def build_ec_balance_plan(
        snap: Snapshot, collection: "str | None" = None,
        parity_of=None, default_parity: int = 2,
        max_moves: int = DEFAULT_MAX_MOVES, costs=None) -> MovePlan:
    """Even each EC stripe's per-server shard counts from ONE snapshot,
    honoring the rack-safety cap (≤ p shards of a stripe per rack).
    `parity_of(vid, collection) -> int|None` probes the sealed
    geometry; no answer falls back to `default_parity`.

    All moves of one stripe between one (src, dst) pair are grouped
    into a single Move — the executor issues one VolumeEcShardsMove per
    pair (the satellite fix: the old loop re-ran the settled-holder
    poll and a full topology collect per single shard).

    `costs` (geo LinkCostModel; defaults when None) orders candidate
    destinations cheapest-link-first within the evenness/rack caps, so
    a shard never crosses a DC when an intra-DC destination fixes the
    same imbalance."""
    from ..geo.policy import LinkCostModel
    costs = costs or LinkCostModel()
    nodes = {n.id: n for n in snap.nodes}
    if len(nodes) < 2:
        return MovePlan([], 1.0, 1.0)
    loads = {nid: n.load_bytes for nid, n in nodes.items()}
    skew_before = _skew(loads)
    rack_of = {nid: n.rack for nid, n in nodes.items()}
    dc_of = {nid: n.dc for nid, n in nodes.items()}

    def _mult(a: str, b: str) -> float:
        return costs.cost(dc_of[a], rack_of[a], dc_of[b], rack_of[b])
    # stripe state: vid -> {node_id: set(shard_ids)}
    stripes: dict[int, dict[str, set]] = {}
    meta: dict[int, dict] = {}
    for nid, n in nodes.items():
        for vid, s in n.ec_shards.items():
            if collection is not None and s["collection"] != collection:
                continue
            stripes.setdefault(vid, {}).setdefault(
                nid, set()).update(s["shard_ids"])
            meta.setdefault(vid, {"collection": s["collection"],
                                  "shard_bytes": s["shard_bytes"]})
    moves: list[Move] = []
    notes: list[str] = []
    # (vid, src, dst) -> Move, so per-pair groups accrete shard ids
    grouped: dict[tuple, Move] = {}
    for vid in sorted(stripes):
        by_node = stripes[vid]
        total = sum(len(s) for s in by_node.values())
        if not total:
            continue
        parity = default_parity
        if parity_of is not None:
            try:
                parity = parity_of(vid, meta[vid]["collection"]) \
                    or default_parity
            except Exception as e:  # noqa: BLE001 — probe is best-effort
                log.debug("parity probe for ec %s failed: %s", vid, e)
        cap = -(-total // len(nodes))  # ceil: per-node evenness target
        rack_counts: dict[str, int] = {}
        for nid, sids in by_node.items():
            rack_counts[rack_of[nid]] = \
                rack_counts.get(rack_of[nid], 0) + len(sids)
        n_racks = len({n.rack for n in snap.nodes})
        rack_cap = max(1, parity) if n_racks * max(1, parity) >= total \
            else -(-total // max(1, n_racks))
        moved_any = True
        while moved_any and len(moves) + len(grouped) < max_moves:
            moved_any = False
            counts = {nid: len(by_node.get(nid, ())) for nid in nodes}
            over = sorted((nid for nid, c in counts.items() if c > cap),
                          key=lambda i: (-counts[i], i))
            if not over:
                # evenness ok; still fix rack-safety violations (a
                # whole rack over cap must shed to another rack)
                over = sorted(
                    (nid for nid in counts
                     if counts[nid]
                     and rack_counts.get(rack_of[nid], 0) > rack_cap),
                    key=lambda i: (-counts[i], i))
            for src_id in over:
                # cost multiplier ranks AFTER the evenness/rack terms
                # (spread is safety, cheapness is preference) but
                # BEFORE load — an intra-DC destination beats a
                # cross-DC one whenever both fix the imbalance
                dsts = sorted(
                    (nid for nid in nodes
                     if nid != src_id and counts[nid] < cap
                     and vid not in nodes[nid].ec_shards
                     and nid not in by_node
                     and rack_counts.get(rack_of[nid], 0) < rack_cap),
                    key=lambda i: (counts[i],
                                   rack_counts.get(rack_of[i], 0),
                                   _mult(src_id, i), loads[i], i))
                # a node that already holds other shards of the stripe
                # may still take more if it stays under the caps
                if not dsts:
                    dsts = sorted(
                        (nid for nid in nodes
                         if nid != src_id and counts[nid] < cap
                         and (rack_of[nid] == rack_of[src_id]
                              or rack_counts.get(rack_of[nid], 0)
                              < rack_cap)),
                        key=lambda i: (counts[i],
                                       rack_counts.get(rack_of[i], 0),
                                       _mult(src_id, i), loads[i], i))
                if not dsts:
                    continue
                dst_id = dsts[0]
                sid = min(by_node[src_id])
                by_node[src_id].discard(sid)
                if not by_node[src_id]:
                    by_node.pop(src_id)
                by_node.setdefault(dst_id, set()).add(sid)
                if rack_of[dst_id] != rack_of[src_id]:
                    rack_counts[rack_of[src_id]] -= 1
                    rack_counts[rack_of[dst_id]] = \
                        rack_counts.get(rack_of[dst_id], 0) + 1
                sz = meta[vid]["shard_bytes"]
                loads[src_id] -= sz
                loads[dst_id] += sz
                key = (vid, src_id, dst_id)
                mv = grouped.get(key)
                if mv is None:
                    link = costs.classify(
                        dc_of[src_id], rack_of[src_id],
                        dc_of[dst_id], rack_of[dst_id])
                    grouped[key] = Move(
                        kind=MOVE_EC, vid=vid,
                        collection=meta[vid]["collection"],
                        src=src_id, dst=dst_id, bytes_moved=sz,
                        cross_rack=link != "intra_rack",
                        link=link,
                        cost_weighted_bytes=int(
                            sz * _mult(src_id, dst_id)),
                        shard_ids=[sid])
                else:
                    mv.shard_ids.append(sid)
                    mv.bytes_moved += sz
                    mv.cost_weighted_bytes += int(
                        sz * _mult(src_id, dst_id))
                moved_any = True
                break
    moves.extend(sorted(grouped.values(),
                        key=lambda m: (m.bytes_moved, m.vid, m.src)))
    if len(moves) >= max_moves:
        notes.append(f"move budget ({max_moves}) exhausted")
    for m in moves:
        m.shard_ids.sort()
    return MovePlan(moves, skew_before, _skew(loads), notes=notes)
