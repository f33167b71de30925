"""Repair planner: one health report in, one prioritized repair plan out.

The Facebook warehouse-cluster study (PAPERS arXiv:1309.0186) frames
recovery as a scheduling problem: erasure-code repair traffic is a
first-class network load, so the repair queue must be *ordered* (the
stripes closest to data loss first) and the executor *throttled* — not
an indiscriminate sweep. The planner owns the ordering half:

  * items sorted by ascending `distance_to_data_loss` (0 = the next
    failure loses data), then by descending severity, EC stripes before
    replicated volumes on ties, remounts before rebuilds (a remount is
    IO-free compared to a reconstruction), volume id last — so two
    planners over the same report emit byte-identical plans;
  * each item carries the CONCRETE action and its source/target
    selection:
      - `ec.remount`  — a missing shard still sits on a live holder's
        disk (found by the caller's remount probe): mount it back, no
        reconstruction traffic at all;
      - `ec.rebuild`  — reconstruct missing shards from the k survivors;
      - `volume.replicate` — copy a replica-deficient volume from a
        healthy holder to servers that lack it (targets picked by free
        slots, ordered healthy-first through the circuit breakers);
  * DATA_LOSS items are *reported, never "repaired"*: a stripe below k
    shards (or a volume with zero holders) cannot be reconstructed from
    the cluster — pretending otherwise would burn the repair budget and
    hide the outage. They land in `plan.unrepairable`.

The planner is a pure function over the report plus an optional probe —
it performs no RPCs of its own, so `cluster.repair -dryRun` prints the
exact plan the executor would run.

The port's copy of seaweedfs_tpu/maintenance/planner.py.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..master.health import AT_RISK, DATA_LOSS, DEGRADED, _RANK
from ..utils.log import logger

log = logger("repair.planner")

ACTION_EC_REMOUNT = "ec.remount"
ACTION_EC_REBUILD = "ec.rebuild"
ACTION_REPLICATE = "volume.replicate"

# remount first (free), then reconstruction, then replica copies — used
# only to break ties AFTER distance/severity/kind (see _sort_key)
_ACTION_ORDER = {ACTION_EC_REMOUNT: 0, ACTION_EC_REBUILD: 1,
                 ACTION_REPLICATE: 2}


@dataclass
class RepairItem:
    """One concrete repair: what to do, to which volume, from/to where."""
    action: str
    kind: str                  # "ec" | "volume" (health item kind)
    vid: int
    collection: str
    severity: str
    distance: int              # distance_to_data_loss at plan time
    shard_ids: list[int] = field(default_factory=list)
    deficit: int = 0
    sources: list[str] = field(default_factory=list)   # donor node ids
    targets: list[str] = field(default_factory=list)   # landing node ids
    # ec.remount: node id -> shard ids found on that node's disk
    remount: dict[str, list[int]] = field(default_factory=dict)
    # network cost of this repair in survivor/copy bytes (0 = free, as a
    # remount is; -1 = unknown, no geometry probe reached the volume).
    # Codec-aware: a piggybacked stripe's single-data-shard rebuild costs
    # (d+|group|)/2 half-shards where plain RS costs d full shards.
    bytes_moved: int = -1
    repair_codec: str = ""
    # geo plane: the same bytes priced through the link-cost model
    # (each survivor byte weighted by the link from its holder's DC to
    # the repair DC); -1 = no cost model or no topology in the report
    cost_weighted_bytes: int = -1
    # the DC the repair should land in: the one holding the most
    # survivors (survivor locality — near helpers are cheap helpers)
    repair_dc: str = ""

    @property
    def key(self) -> tuple[str, int]:
        """Per-volume lock key: two items on one volume never run
        concurrently (a remount and a rebuild of the same stripe)."""
        return (self.kind, self.vid)

    def describe(self) -> str:
        cost = (f" (~{self.bytes_moved:,} B moved)"
                if self.bytes_moved > 0 else "")
        if self.bytes_moved > 0 and self.cost_weighted_bytes > 0:
            cost = (f" (~{self.bytes_moved:,} B moved, "
                    f"{self.cost_weighted_bytes:,} cost-weighted"
                    + (f", repair in {self.repair_dc}" if self.repair_dc
                       else "") + ")")
        if self.action == ACTION_EC_REMOUNT:
            where = ", ".join(f"{n}:{sids}" for n, sids in
                              sorted(self.remount.items()))
            return (f"{self.action} ec volume {self.vid} "
                    f"shards on disk at {where}")
        if self.action == ACTION_EC_REBUILD:
            codec = f" [{self.repair_codec}]" if self.repair_codec else ""
            return (f"{self.action} ec volume {self.vid} "
                    f"missing shards {self.shard_ids}{codec}{cost}")
        return (f"{self.action} volume {self.vid} "
                f"x{self.deficit} {self.sources[:1]} -> {self.targets}{cost}")

    def to_dict(self) -> dict:
        return {"action": self.action, "kind": self.kind, "vid": self.vid,
                "collection": self.collection, "severity": self.severity,
                "distance_to_data_loss": self.distance,
                "shard_ids": list(self.shard_ids), "deficit": self.deficit,
                "sources": list(self.sources), "targets": list(self.targets),
                "remount": {n: list(s) for n, s in self.remount.items()},
                "bytes_moved": self.bytes_moved,
                "repair_codec": self.repair_codec,
                "cost_weighted_bytes": self.cost_weighted_bytes,
                "repair_dc": self.repair_dc}


@dataclass
class RepairPlan:
    items: list[RepairItem]
    unrepairable: list[dict]   # DATA_LOSS health items, verbatim + reason
    verdict: str
    generated_ms: int

    def __bool__(self) -> bool:
        return bool(self.items)

    def to_dict(self) -> dict:
        return {"verdict": self.verdict, "generated_ms": self.generated_ms,
                "items": [it.to_dict() for it in self.items],
                "unrepairable": list(self.unrepairable)}

    def render(self, println) -> None:
        """Human plan listing (cluster.repair and -dryRun print this)."""
        println(f"repair plan: {len(self.items)} action(s), "
                f"{len(self.unrepairable)} unrepairable, "
                f"verdict {self.verdict}")
        for i, it in enumerate(self.items, 1):
            println(f"  {i}. [{it.severity} d={it.distance}] "
                    f"{it.describe()}")
        for u in self.unrepairable:
            println(f"  !! [DATA_LOSS] {u['kind']} {u['id']}: "
                    f"{u.get('reason', 'unreadable with registered holders')}"
                    " — restore from backup or re-register its holders")


def _sort_key(it: RepairItem):
    # ties break by network cost, cheapest first (the warehouse-cluster
    # ordering: most-at-risk, then least repair traffic); with a geo
    # cost model the COST-WEIGHTED bytes order — a cheap intra-DC
    # rebuild beats an equal-size cross-DC one. Unknown cost (-1) sorts
    # after every known cost rather than before
    cost = (it.cost_weighted_bytes if it.cost_weighted_bytes >= 0
            else it.bytes_moved if it.bytes_moved >= 0 else float("inf"))
    return (it.distance, -_RANK[it.severity],
            0 if it.kind == "ec" else 1,
            _ACTION_ORDER.get(it.action, 9), cost, it.vid)


def _node_dcs(report: dict) -> dict:
    return {nd["id"]: nd.get("dc", "") for nd in report.get("nodes", ())}


def _pick_replica_targets(report: dict, holders: list[str],
                          deficit: int, costs=None) -> list[str]:
    """Servers that do NOT hold the volume: fresh heartbeats before
    stale (a wedged-but-registered node must not be the landing zone),
    cheapest copy link from the nearest surviving holder when a geo
    cost model is given (survivor locality: an intra-DC candidate beats
    a cross-DC one), most free slots first (id breaks ties), then
    ordered healthy-first through the circuit breakers —
    deterministically within each breaker class. Stale nodes stay at
    the tail rather than dropping out entirely: with no fresh candidate
    a degraded copy beats none."""
    from ..utils import retry
    node_dc = _node_dcs(report)
    holder_dcs = sorted({node_dc.get(h, "") for h in holders} - {""})

    def _link_cost(nd) -> float:
        if costs is None or not holder_dcs:
            return 0.0
        dc = nd.get("dc", "")
        return min(costs.cost(h, "", dc, "") for h in holder_dcs)

    nodes = [nd for nd in report.get("nodes", ())
             if nd["id"] not in set(holders)]
    nodes.sort(key=lambda nd: (bool(nd.get("stale")), _link_cost(nd),
                               -(nd.get("max_slots", 0)
                                 - nd.get("used_slots", 0)), nd["id"]))
    ranked = retry.order_by_breaker([nd["id"] for nd in nodes])
    return ranked[:deficit]


def _weighted(report: dict, holders, nbytes: int, costs,
              targets=()) -> tuple[int, str]:
    """(cost-weighted bytes, repair DC) for moving `nbytes` of survivor
    reads into the DC holding the most survivors (the near side — the
    MSR fold then ships ONE folded fragment per far group instead of
    raw helper fragments, but the planner prices the conservative
    un-folded fetch). Returns (-1, "") without a model or topology."""
    if costs is None or nbytes < 0:
        return -1, ""
    node_dc = _node_dcs(report)
    dcs = [node_dc.get(h, "") for h in holders]
    known = [d for d in dcs if d]
    if not known:
        return -1, ""
    # most survivors, ties to the lexicographically first DC — two
    # planners over one report must land the repair in the same place
    tally: dict[str, int] = {}
    for d in known:
        tally[d] = tally.get(d, 0) + 1
    repair_dc = min(tally, key=lambda d: (-tally[d], d))
    per = nbytes / max(1, len(dcs)) if not targets else nbytes
    total = 0.0
    if targets:
        # replica copies: nbytes per target from the nearest holder
        for t in targets:
            tdc = node_dc.get(t, "")
            total += min(costs.cost(h, "", tdc, "x") for h in known) * per
    else:
        # survivor reads: each holder ships its share into repair_dc
        # (intra-DC helpers price as cross_rack — the planner has no
        # rack detail, and same-rack survivors are the exception)
        for d in dcs:
            total += costs.weighted(per, d or repair_dc, "", repair_dc, "x")
    return int(total), repair_dc


def _ec_rebuild_cost(probe_geometry, vid: int, collection: str,
                     missing: "list[int]") -> tuple[int, str]:
    """(bytes the rebuild must read, codec) — codec-aware via the
    volume's sealed geometry. (-1, "") when no probe reached it."""
    if probe_geometry is None:
        return -1, ""
    try:
        g = probe_geometry(vid, collection)
    except Exception as e:  # noqa: BLE001 — probe is best-effort
        log.warning("geometry probe for ec %s failed: %s", vid, e)
        return -1, ""
    if not g or not g.get("shard_size") or not g.get("d") or not g.get("p"):
        return -1, (g or {}).get("codec", "")
    codec = g.get("codec") or "rs"
    try:
        from ..ops.coder import repair_read_bytes
        return (repair_read_bytes(codec, g["d"], g["p"], missing,
                                  g["shard_size"]), codec)
    except Exception as e:  # noqa: BLE001 — a malformed .vif must cost
        log.warning("repair cost for ec %s (codec %s, %s+%s) failed: %s",
                    vid, codec, g.get("d"), g.get("p"), e)
        return -1, codec  # ...one stripe its estimate, not the whole plan


def build_plan(report: dict, probe_remountable=None,
               probe_geometry=None, costs=None) -> RepairPlan:
    """Derive the repair plan from a health report (master/health.py
    evaluate() / HealthEngine.scan() / GET /cluster/health — all three
    produce the same shape).

    `probe_remountable(vid, missing_sids, collection) -> {node: [sids]}`
    is optional and read-only: it reports missing shards that still
    exist ON DISK on live holders (executor.make_remount_probe wires it
    to VolumeEcShardsInfo). Shards it finds become `ec.remount` items;
    the remainder become `ec.rebuild`.

    `probe_geometry(vid, collection) -> {codec, d, p, shard_size}` is
    equally optional/read-only (executor.make_geometry_probe): with it,
    every item carries its network cost in `bytes_moved` — computed with
    the volume's sealed codec through the coder registry, so a
    piggybacked stripe's 0.65x and an msr stripe's (n-1)/p repair reads
    are what get costed and ordered, not the plain-RS d-full-shards.

    `costs` (a geo LinkCostModel) additionally prices each item in
    cost-weighted bytes (`cost_weighted_bytes`, `repair_dc`): survivor
    reads weighted by the link from each holder's DC into the DC with
    the most survivors, replica copies by the cheapest holder->target
    link — and replica targets prefer near survivors.
    """
    from ..utils import retry

    items: list[RepairItem] = []
    unrepairable: list[dict] = []
    for it in report.get("items", ()):
        kind, sev = it.get("kind"), it.get("severity")
        if sev == DATA_LOSS:
            u = dict(it)
            u.setdefault("reason",
                         "below reconstruction threshold" if kind == "ec"
                         else "no live holders")
            unrepairable.append(u)
            continue
        if sev not in (DEGRADED, AT_RISK):
            continue
        if kind == "ec":
            missing = sorted(it.get("shards_missing", ()))
            if not missing:
                continue
            remount: dict[str, list[int]] = {}
            if probe_remountable is not None:
                try:
                    found = probe_remountable(it["id"], missing,
                                              it.get("collection", ""))
                    remount = {n: sorted(s) for n, s in sorted(found.items())
                               if s}
                except Exception as e:  # noqa: BLE001 — probe is best-effort
                    log.warning("remount probe for ec %s failed: %s",
                                it["id"], e)
            remountable = sorted({s for sids in remount.values()
                                  for s in sids})
            if remountable:
                items.append(RepairItem(
                    action=ACTION_EC_REMOUNT, kind="ec", vid=it["id"],
                    collection=it.get("collection", ""), severity=sev,
                    distance=it["distance_to_data_loss"],
                    shard_ids=remountable, remount=remount,
                    bytes_moved=0))  # mount-back moves no shard bytes
            rebuild = [s for s in missing if s not in remountable]
            if rebuild:
                # donors are the surviving shard holders; the executor
                # resolves them live (holder sets drift between plan and
                # execution as heartbeats land)
                cost, codec = _ec_rebuild_cost(
                    probe_geometry, it["id"], it.get("collection", ""),
                    rebuild)
                weighted, repair_dc = _weighted(
                    report, it.get("holders", ()), cost, costs)
                items.append(RepairItem(
                    action=ACTION_EC_REBUILD, kind="ec", vid=it["id"],
                    collection=it.get("collection", ""), severity=sev,
                    distance=it["distance_to_data_loss"],
                    shard_ids=rebuild, bytes_moved=cost,
                    repair_codec=codec, cost_weighted_bytes=weighted,
                    repair_dc=repair_dc))
        elif kind == "volume":
            deficit = it.get("replica_deficit", 0)
            if not deficit:
                continue
            holders = sorted(it.get("holders", ()))
            size = it.get("size")  # absent (pre-size reports) != zero
            targets = _pick_replica_targets(report, holders, deficit,
                                            costs=costs)
            weighted, repair_dc = _weighted(
                report, holders, size if size is not None else -1,
                costs, targets=targets)
            items.append(RepairItem(
                action=ACTION_REPLICATE, kind="volume", vid=it["id"],
                collection=it.get("collection", ""), severity=sev,
                distance=it["distance_to_data_loss"], deficit=deficit,
                sources=retry.order_by_breaker(holders),
                targets=targets,
                bytes_moved=(size * deficit if size is not None else -1),
                cost_weighted_bytes=weighted, repair_dc=repair_dc))
        # node/disk items (stale heartbeats, full disks) are operator
        # signals, not volume repairs — the plan leaves them to alerts
    items.sort(key=_sort_key)
    plan = RepairPlan(items=items, unrepairable=unrepairable,
                      verdict=report.get("verdict", "OK"),
                      generated_ms=int(time.time() * 1000))
    _publish_pending(plan)
    return plan


def _publish_pending(plan: RepairPlan) -> None:
    """SeaweedFS_repairs_pending{severity}: planned-but-not-done repairs,
    refreshed on every plan build (shell and cron alike); the executor
    decrements as repairs land. DATA_LOSS pending = unrepairable items,
    so a nonzero DATA_LOSS gauge is an alert, not a queue."""
    try:
        from ..master.health import SEVERITIES
        from ..stats import REPAIRS_PENDING
        counts = {s: 0 for s in SEVERITIES}
        for it in plan.items:
            counts[it.severity] += 1
        counts[DATA_LOSS] = len(plan.unrepairable)
        for sev, n in counts.items():
            REPAIRS_PENDING.set(sev, value=n)
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break planning)
        pass
