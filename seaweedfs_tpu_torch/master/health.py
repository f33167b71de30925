"""Cluster health plane: data-at-risk scoring over the master topology.

The Facebook warehouse-cluster study (PAPERS arXiv:1309.0186) shows the
operationally dominant signal in an RS(k,m) store is the population of
stripes sitting at reduced redundancy awaiting repair — state the master
already holds per volume and per EC shard but (until now) never
aggregated. This module derives, on every scan:

* per replicated volume: replica deficit vs. its replication policy;
* per EC volume: shards present vs. the stripe's expected RS(k,m)
  (fork default 14+2; geometry is configurable, so expected n is
  tracked as a per-volume high-water mark of observed shard ids and k
  is derived from the configured parity count);
* distance_to_data_loss: how many MORE holder failures the item can
  tolerate while staying readable (0 = the next failure loses data);
* dead/stale nodes, read-only and full volumes, full disks;

rolled up into severity buckets:

    OK        -> full redundancy
    DEGRADED  -> reduced redundancy, repair can restore it
    AT_RISK   -> distance_to_data_loss == 0: one more failure is loss
    DATA_LOSS -> unreadable with the holders currently registered

and a top-level verdict (the max item severity). The engine feeds three
surfaces: `/cluster/health` JSON, the SeaweedFS_volumes_at_risk /
SeaweedFS_ec_shards_missing / SeaweedFS_replica_deficit /
SeaweedFS_nodes_stale gauges, and `health.severity` / `health.verdict`
events in the ops journal on every transition.

`evaluate()` is a pure function over a plain snapshot dict so the shell
(`cluster.check`) scores a TopologyInfo dump with byte-identical
semantics when the master HTTP endpoint isn't reachable.

Known limitation: a volume whose LAST holder disappears also disappears
from the topology, so a total wipeout degrades to "vid no longer
reported" rather than a DATA_LOSS item; the severity-change event
emitted on the way down (AT_RISK -> gone) is the durable breadcrumb.

The port's copy of seaweedfs_tpu/master/health.py.
"""

from __future__ import annotations

import threading
import time

from .. import ec as ec_bits
from ..utils.log import logger

log = logger("health")

OK, DEGRADED, AT_RISK, DATA_LOSS = "OK", "DEGRADED", "AT_RISK", "DATA_LOSS"
SEVERITIES = (OK, DEGRADED, AT_RISK, DATA_LOSS)
_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# fork default stripe: RS(14,2) (reference ZTO fork hardcodes 14+2;
# ours is configurable per encode, see ec/locate.py EcGeometry)
DEFAULT_PARITY_SHARDS = 2


def worse(a: str, b: str) -> str:
    return a if _RANK[a] >= _RANK[b] else b


def score_replicated(present: int, expected: int) -> tuple[str, int]:
    """(severity, distance_to_data_loss) for a replicated volume.
    distance counts ADDITIONAL holder losses tolerable while readable:
    a volume is readable down to its last copy, so distance is
    present-1. A single-copy policy at full strength is OK by policy —
    the operator chose replication 000 — though its distance is 0."""
    if present <= 0:
        return DATA_LOSS, -1
    distance = present - 1
    if present >= expected:
        return OK, distance
    if present == 1:
        return AT_RISK, 0
    return DEGRADED, distance


def score_ec(present: int, k: int, n: int) -> tuple[str, int]:
    """(severity, distance_to_data_loss) for an RS(k, n-k) stripe:
    readable while >= k distinct shards survive."""
    distance = present - k
    if present < k:
        return DATA_LOSS, distance
    if present == k:
        return AT_RISK, 0
    if present < n:
        return DEGRADED, distance
    return OK, distance


def evaluate(snapshot: dict, parity: int = DEFAULT_PARITY_SHARDS,
             stale_after_s: float = 0.0,
             disk_full_ratio: float = 0.95) -> dict:
    """Score a topology snapshot into the health report dict.

    `snapshot` is plain data (see MasterServer.health_snapshot and
    shell snapshot_from_topology_info):
      volumes:    [{id, collection, present, expected, read_only, size,
                    holders}]
      ec_volumes: [{id, collection, present_ids, expected_n}]
      nodes:      [{id, age_s (None = unknown), used_slots, max_slots}]
      volume_size_limit: int
    """
    items: list[dict] = []
    counts = {s: 0 for s in SEVERITIES}
    replica_deficit = 0
    ec_missing = 0
    read_only_volumes = 0
    full_volumes = 0
    size_limit = snapshot.get("volume_size_limit") or 0
    # holder -> DC so DEGRADED/AT_RISK items name the data centers
    # still holding copies (the geo operator's first question during a
    # DC sever: "which side has the surviving bytes?")
    node_dc = {nd["id"]: nd.get("dc", "")
               for nd in snapshot.get("nodes", ())}

    def _dcs_of(holders) -> list[str]:
        return sorted({node_dc.get(h, "") for h in holders} - {""})

    for v in snapshot.get("volumes", ()):
        sev, dist = score_replicated(v["present"], v["expected"])
        deficit = max(0, v["expected"] - v["present"])
        replica_deficit += deficit
        full = bool(size_limit and v.get("size", 0) >= size_limit)
        if v.get("read_only"):
            read_only_volumes += 1
        if full:
            full_volumes += 1
        counts[sev] += 1
        if sev != OK or deficit:
            items.append({
                "kind": "volume", "id": v["id"],
                "collection": v.get("collection", ""),
                "severity": sev, "distance_to_data_loss": dist,
                "replicas_present": v["present"],
                "replicas_expected": v["expected"],
                "replica_deficit": deficit,
                "read_only": bool(v.get("read_only")), "full": full,
                "size": v.get("size", 0),
                "holders": sorted(v.get("holders", ())),
                "dcs": _dcs_of(v.get("holders", ())),
            })

    for e in snapshot.get("ec_volumes", ()):
        present_ids = sorted(e["present_ids"])
        n = max(e["expected_n"], len(present_ids))
        # a snapshot that KNOWS a volume's parity (shell probes a holder
        # via VolumeEcShardsInfo) carries it per-volume; otherwise the
        # configured cluster default applies
        k = max(1, n - e.get("parity", parity))
        sev, dist = score_ec(len(present_ids), k, n)
        missing = sorted(set(range(n)) - set(present_ids))
        ec_missing += len(missing)
        counts[sev] += 1
        if sev != OK:
            items.append({
                "kind": "ec", "id": e["id"],
                "collection": e.get("collection", ""),
                "severity": sev, "distance_to_data_loss": dist,
                "shards_present": present_ids,
                "shards_missing": missing,
                "rs": {"k": k, "n": n},
                "holders": sorted(e.get("holders", ())),
                "dcs": _dcs_of(e.get("holders", ())),
            })

    nodes_out: list[dict] = []
    stale_nodes = 0
    for nd in snapshot.get("nodes", ()):
        age = nd.get("age_s")
        stale = bool(stale_after_s and age is not None
                     and age > stale_after_s)
        used, cap = nd.get("used_slots", 0), nd.get("max_slots", 0)
        disk_full = bool(cap and used >= cap * disk_full_ratio)
        if stale:
            stale_nodes += 1
            items.append({"kind": "node", "id": nd["id"],
                          "severity": DEGRADED, "stale": True,
                          "age_s": round(age, 1),
                          "dc": nd.get("dc", "")})
            counts[DEGRADED] += 1
        if disk_full:
            items.append({"kind": "disk", "id": nd["id"],
                          "severity": DEGRADED, "used_slots": used,
                          "max_slots": cap, "dc": nd.get("dc", "")})
            counts[DEGRADED] += 1
        nodes_out.append({"id": nd["id"],
                          "age_s": (round(age, 1) if age is not None
                                    else None),
                          "stale": stale, "used_slots": used,
                          "max_slots": cap,
                          "rack": nd.get("rack", ""),
                          "dc": nd.get("dc", "")})

    verdict = OK
    for it in items:
        verdict = worse(verdict, it["severity"])
    items.sort(key=lambda it: -_RANK[it["severity"]])
    return {
        "verdict": verdict,
        "generated_ms": int(time.time() * 1000),
        "counts": counts,
        "totals": {"replica_deficit": replica_deficit,
                   "ec_shards_missing": ec_missing,
                   "nodes_stale": stale_nodes,
                   "volumes_read_only": read_only_volumes,
                   "volumes_full": full_volumes,
                   "nodes": len(nodes_out)},
        "items": items,
        "nodes": nodes_out,
    }


def snapshot_from_topology_info(ti, volume_size_limit: int = 0,
                                expected_n_of=None) -> dict:
    """Build an evaluate() snapshot from a TopologyInfo protobuf (the
    shell's VolumeList view). Node staleness is unknown from a topology
    dump (no last_seen on the wire), so age_s is None. `expected_n_of`
    maps (vid, present_ids) -> stripe width for EC volumes; default
    infers max(present)+1, which undercounts when the HIGHEST shards
    are the lost ones — callers with a live cluster should probe a
    holder (VolumeEcShardsInfo) instead."""
    from ..storage.types import ReplicaPlacement

    volumes: dict[int, dict] = {}
    ec_present: dict[int, set[int]] = {}
    ec_collection: dict[int, str] = {}
    ec_holders: dict[int, set[str]] = {}
    nodes: list[dict] = []
    for dc in ti.data_center_infos:
        for rack in dc.rack_infos:
            for node in rack.data_node_infos:
                used = cap = 0
                for disk in node.disk_infos.values():
                    used += disk.volume_count
                    cap += disk.max_volume_count
                    for v in disk.volume_infos:
                        rec = volumes.setdefault(v.id, {
                            "id": v.id, "collection": v.collection,
                            "present": 0,
                            "expected": ReplicaPlacement.from_byte(
                                v.replica_placement).copy_count,
                            "read_only": False, "size": 0,
                            "holders": set()})
                        rec["present"] += 1
                        rec["holders"].add(node.id)
                        rec["read_only"] |= v.read_only
                        rec["size"] = max(rec["size"], v.size)
                    for s in disk.ec_shard_infos:
                        ec_present.setdefault(s.id, set()).update(
                            ec_bits.shard_ids(s.ec_index_bits))
                        ec_collection[s.id] = s.collection
                        ec_holders.setdefault(s.id, set()).add(node.id)
                nodes.append({"id": node.id, "age_s": None,
                              "used_slots": used, "max_slots": cap,
                              "rack": rack.id, "dc": dc.id})
    ec_volumes = []
    for vid, ids in sorted(ec_present.items()):
        rec = {"id": vid, "collection": ec_collection.get(vid, ""),
               "present_ids": sorted(ids),
               "holders": ec_holders.get(vid, set()),
               "expected_n": (max(ids) + 1) if ids else 0}
        if expected_n_of is not None:
            got = expected_n_of(vid, sorted(ids))
            if isinstance(got, tuple):  # (n, parity) from a geometry probe
                rec["expected_n"], rec["parity"] = got
            elif got:
                rec["expected_n"] = got
        ec_volumes.append(rec)
    return {"volumes": sorted(volumes.values(), key=lambda v: v["id"]),
            "ec_volumes": ec_volumes, "nodes": nodes,
            "volume_size_limit": volume_size_limit}


class HealthEngine:
    """Master-side scanner: snapshots the live Topology every tick,
    evaluates it, publishes gauges, and journals every severity change
    (per item AND the top-level verdict) as structured events."""

    def __init__(self, topo, parity: int = DEFAULT_PARITY_SHARDS,
                 stale_after_s: float = 15.0,
                 disk_full_ratio: float = 0.95):
        self.topo = topo
        self.parity = parity
        self.stale_after_s = stale_after_s
        self.disk_full_ratio = disk_full_ratio
        # optional () -> [item dicts] merged into every scan's report:
        # the telemetry plane injects burning-SLO items here so the
        # verdict reflects user-facing objectives, not just structure.
        # Extra items ride the same counts/verdict/journal machinery.
        self.extra_items = None
        self._lock = threading.Lock()
        self._last_severity: dict[tuple[str, object], str] = {}
        self._last_read_only: set[int] = set()
        self._last_verdict = OK
        self._last_report: dict | None = None

    def snapshot(self) -> dict:
        """Plain-data view of the live topology (under its lock)."""
        topo = self.topo
        now = time.monotonic()  # ages against DataNode.last_seen
        volumes: dict[int, dict] = {}
        nodes: list[dict] = []
        with topo.lock:
            for vid, locs in topo.volume_locations.items():
                infos = []
                for node in locs.values():
                    for d in node.disks.values():
                        v = d.volumes.get(vid)
                        if v is not None:
                            infos.append(v)
                expected = (infos[0].replica_placement.copy_count
                            if infos else 1)
                volumes[vid] = {
                    "id": vid,
                    "collection": infos[0].collection if infos else "",
                    "present": len(locs), "expected": expected,
                    "read_only": any(v.read_only for v in infos),
                    "size": max((v.size for v in infos), default=0),
                    "holders": set(locs)}
            ec_volumes = []
            for vid, shard_locs in topo.ec_locations.items():
                present = sorted(sid for sid, holders in shard_locs.items()
                                 if holders)
                ec_volumes.append({
                    "id": vid,
                    "collection": topo.ec_collections.get(vid, ""),
                    "present_ids": present,
                    "holders": set().union(*shard_locs.values())
                    if shard_locs else set(),
                    "expected_n": max(topo.ec_expected.get(vid, 0),
                                      (max(present) + 1) if present else 0)})
            for node in topo.nodes.values():
                # slot accounting matches placement's (Disk.free_slots:
                # EC shards consume fractional slots)
                cap = sum(d.max_volume_count for d in node.disks.values())
                free = sum(d.free_slots() for d in node.disks.values())
                nodes.append({"id": node.id,
                              "age_s": now - node.last_seen,
                              "used_slots": cap - free, "max_slots": cap,
                              "rack": node.rack.id if node.rack else "",
                              "dc": (node.rack.dc.id if node.rack
                                     else "")})
        return {"volumes": sorted(volumes.values(), key=lambda v: v["id"]),
                "ec_volumes": sorted(ec_volumes, key=lambda e: e["id"]),
                "nodes": nodes,
                "volume_size_limit": topo.volume_size_limit}

    def scan(self) -> dict:
        """One full pass: evaluate, publish gauges, journal transitions.
        Serialized — the janitor tick and /cluster/health may race."""
        with self._lock:
            snap = self.snapshot()
            report = evaluate(snap, parity=self.parity,
                              stale_after_s=self.stale_after_s,
                              disk_full_ratio=self.disk_full_ratio)
            self._merge_extra_items(report)
            self._publish_gauges(report)
            read_only_now = {v["id"] for v in snap["volumes"]
                             if v.get("read_only")}
            self._journal_transitions(report, read_only_now)
            self._last_report = report
            return report

    def last_report(self) -> dict:
        with self._lock:
            return self._last_report or {}

    # -- internals -----------------------------------------------------------
    def _merge_extra_items(self, report: dict) -> None:
        fn = self.extra_items
        if fn is None:
            return
        try:
            extra = fn() or []
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (a broken provider must not break the structural scan)
            return
        for it in extra:
            sev = it.get("severity", OK)
            report["items"].append(it)
            if sev in report["counts"]:
                report["counts"][sev] += 1
            report["verdict"] = worse(report["verdict"], sev)
        report["items"].sort(key=lambda it: -_RANK[it["severity"]])

    def _publish_gauges(self, report: dict) -> None:
        try:
            from ..stats import (EC_SHARDS_MISSING, NODES_STALE,
                                 REPLICA_DEFICIT, VOLUMES_AT_RISK)
            for sev in SEVERITIES:
                VOLUMES_AT_RISK.set(sev, value=report["counts"][sev])
            EC_SHARDS_MISSING.set(value=report["totals"]["ec_shards_missing"])
            REPLICA_DEFICIT.set(value=report["totals"]["replica_deficit"])
            NODES_STALE.set(value=report["totals"]["nodes_stale"])
            from ..stats import CLUSTER_NODES_BY_DC
            by_dc: dict[str, int] = {}
            for nd in report.get("nodes", ()):
                by_dc[nd.get("dc") or "-"] = \
                    by_dc.get(nd.get("dc") or "-", 0) + 1
            for dc, n in by_dc.items():
                CLUSTER_NODES_BY_DC.set(dc, value=n)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break the scan)
            pass

    def _journal_transitions(self, report: dict,
                             read_only_now: set[int]) -> None:
        from ..ops import events

        cur: dict[tuple[str, object], str] = {}
        for it in report["items"]:
            if it["severity"] != OK:
                cur[(it["kind"], it["id"])] = it["severity"]
        # items that scored OK this pass don't appear in report["items"];
        # anything previously non-OK and now absent recovered (or left
        # the topology entirely — same journal line either way)
        for key, prev in self._last_severity.items():
            if key not in cur:
                events.emit("health.severity", kind=key[0], id=key[1],
                            previous=prev, to=OK)
        for key, sev in cur.items():
            prev = self._last_severity.get(key, OK)
            if sev != prev:
                events.emit(
                    "health.severity",
                    severity=(events.WARN if _RANK[sev] > _RANK[prev]
                              else events.INFO),
                    kind=key[0], id=key[1], previous=prev, to=sev)
        for vid in read_only_now - self._last_read_only:
            events.emit("volume.readonly", vid=vid, read_only=True)
        for vid in self._last_read_only - read_only_now:
            events.emit("volume.readonly", vid=vid, read_only=False)
        if report["verdict"] != self._last_verdict:
            events.emit("health.verdict",
                        severity=(events.WARN
                                  if report["verdict"] != OK
                                  else events.INFO),
                        previous=self._last_verdict,
                        to=report["verdict"],
                        totals=report["totals"])
            log.info("cluster verdict %s -> %s", self._last_verdict,
                     report["verdict"])
        self._last_severity = cur
        self._last_read_only = read_only_now
        self._last_verdict = report["verdict"]
