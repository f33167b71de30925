"""Lifecycle planner: topology + heat → a deterministic transition plan.

Inputs are a topology snapshot (the shell's collect_volume_servers
view) and one heat report per volume server (`/debug/lifecycle`: the
per-volume read counters and last-read/last-write ages the storage
layer keeps, plus per-EC-volume tier state). Output is a pure-data
`LifecyclePlan` — building one performs ZERO mutating RPCs, so
`lifecycle.apply -dryRun` and the status verb may plan freely.

Ordering mirrors the repair planner's admission discipline: transitions
that serve USERS first (promote-on-heat — someone is actively reading
through the remote tier), then the capacity wins (hot→EC), then the
cheap-tier moves (EC→remote); within a class cheapest-bytes-first so a
bounded byte budget heals the most volumes per sweep.

Conservatism: a volume is only planned when EVERY live holder's heat
report agrees it is cold — a missing or unreachable heat report vetoes
the volume rather than guessing (moving warm data down-tier is the
expensive mistake; leaving cold data hot one sweep longer is not).

The port's copy of seaweedfs_tpu/lifecycle/planner.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.log import logger
from . import TIER_EC, TIER_HOT, TIER_REMOTE

log = logger("lifecycle.planner")

KIND_ENCODE = "encode"    # hot -> ec (through the encode pipeline)
KIND_OFFLOAD = "offload"  # ec -> remote (payload behind storage/backend)
KIND_PROMOTE = "promote"  # remote -> ec (pull payload back on heat)
# stamp a policy TTL (DestroyTime) onto an EC volume that lacks one —
# planned every sweep until every holder's .vif carries it, so a stamp
# that fails right after the (irreversible) encode is RETRIED instead
# of silently lost; pre-existing stripes entering a ttl rule pick one
# up too (now + ttl_s at stamp time)
KIND_STAMP = "stamp_ttl"

_PRIORITY = {KIND_PROMOTE: 0, KIND_STAMP: 1, KIND_ENCODE: 2,
             KIND_OFFLOAD: 3}
_EDGES = {KIND_ENCODE: (TIER_HOT, TIER_EC),
          KIND_OFFLOAD: (TIER_EC, TIER_REMOTE),
          KIND_PROMOTE: (TIER_REMOTE, TIER_EC),
          KIND_STAMP: (TIER_EC, TIER_EC)}  # metadata only: no tier move


@dataclass
class Transition:
    kind: str
    vid: int
    collection: str
    bytes_est: int
    reason: str
    # holders the executor must touch (offload/promote run on every
    # holder with payload on the wrong side; encode runs through the
    # shell verb which re-resolves holders itself)
    servers: "list[dict]" = field(default_factory=list)
    remote: str = ""          # backend spec (offload)
    ttl_s: "float | None" = None  # DestroyTime stamp after encode

    @property
    def from_tier(self) -> str:
        return _EDGES[self.kind][0]

    @property
    def to_tier(self) -> str:
        return _EDGES[self.kind][1]

    @property
    def key(self) -> tuple:
        return ("lifecycle", self.vid)


@dataclass
class LifecyclePlan:
    transitions: "list[Transition]" = field(default_factory=list)
    # EC volumes carrying a DestroyTime: the volume servers reap these
    # themselves on the heartbeat tick (fork store.go:389); listed here
    # for operator visibility, never "executed"
    pending_reaps: "list[dict]" = field(default_factory=list)
    skipped_no_heat: "list[int]" = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(t.bytes_est for t in self.transitions)

    def render(self, println) -> None:
        if not self.transitions and not self.pending_reaps:
            println("lifecycle plan: nothing to do")
            return
        println(f"lifecycle plan: {len(self.transitions)} transitions, "
                f"~{self.total_bytes >> 20} MB")
        for t in self.transitions:
            println(f"  {t.from_tier}->{t.to_tier} volume {t.vid} "
                    f"col={t.collection!r} ~{t.bytes_est >> 10} KB "
                    f"({t.reason})")
        for r in self.pending_reaps:
            due = r["due_in_s"]
            println(f"  ec volume {r['vid']} reaps "
                    + (f"in {due:.0f}s" if due > 0 else "now")
                    + " (DestroyTime)")
        if self.skipped_no_heat:
            println(f"  ({len(self.skipped_no_heat)} volumes skipped: "
                    "no heat report from a holder)")


def fetch_heat(env, servers: "list[dict] | None" = None) -> dict:
    """server id -> its /debug/lifecycle payload (absent on fetch
    failure — the planner treats a missing report as a veto). Fetches
    fan out on a small pool: the cron holds the admin lease while this
    runs, so a fleet with a few slow/dead servers must cost
    max(latency), not sum(latency)."""
    import contextvars
    from concurrent.futures import ThreadPoolExecutor

    from ..client import http_util
    if servers is None:
        servers = env.collect_volume_servers()

    def fetch(srv):
        try:
            r = http_util.get(f"http://{srv['id']}/debug/lifecycle",
                              timeout=5)
            if r.ok:
                return srv["id"], r.json()
        except Exception as e:  # noqa: BLE001 — veto, don't guess
            log.debug("heat fetch from %s failed: %s", srv["id"], e)
        return srv["id"], None

    if not servers:
        return {}
    with ThreadPoolExecutor(
            max_workers=min(8, len(servers)),
            thread_name_prefix="lifecycle-heat") as pool:
        results = list(pool.map(
            lambda s: contextvars.copy_context().run(fetch, s), servers))
    return {sid: rep for sid, rep in results if rep is not None}


def build_lifecycle_plan(env, policy, heat: "dict | None" = None,
                         servers: "list[dict] | None" = None,
                         now: "float | None" = None) -> LifecyclePlan:
    """One topology snapshot + one heat sweep → the ordered plan."""
    import time as _time
    if now is None:
        now = _time.time()  # swtpu-lint: disable=wallclock-duration (DestroyTime is persisted wall-clock)
    if servers is None:
        servers = env.collect_volume_servers()
    if heat is None:
        heat = fetch_heat(env, servers)

    # -- index the topology: vid -> holders, split plain vs EC --------------
    vols: dict[int, dict] = {}
    ecs: dict[int, dict] = {}
    for srv in servers:
        for disk in srv["disks"].values():
            for v in disk.volume_infos:
                ent = vols.setdefault(
                    v.id, {"collection": v.collection, "size": 0,
                           "holders": [], "_ids": set()})
                ent["size"] = max(ent["size"], v.size)
                # one holder entry per SERVER: a multi-disk server's
                # shards/copies spread over its disks must not double
                # its heat report, byte estimate, or executor RPCs
                if srv["id"] not in ent["_ids"]:
                    ent["_ids"].add(srv["id"])
                    ent["holders"].append(srv)
            for s in disk.ec_shard_infos:
                # NB: the topology dump names the stripe `id` (master
                # VolumeEcShardInformationMessage), not volume_id
                ent = ecs.setdefault(
                    s.id, {"collection": s.collection, "holders": [],
                           "_ids": set()})
                if srv["id"] not in ent["_ids"]:
                    ent["_ids"].add(srv["id"])
                    ent["holders"].append(srv)

    plan = LifecyclePlan()

    def _heat_of(srv_id: str, table: str, vid: int) -> "dict | None":
        rep = heat.get(srv_id)
        if rep is None:
            return None
        return rep.get(table, {}).get(str(vid))

    # -- hot -> ec -----------------------------------------------------------
    for vid, ent in sorted(vols.items()):
        if vid in ecs:
            continue  # stripe already exists (conversion mid-flight)
        rule = policy.rule_for(ent["collection"])
        if rule is None or rule.ec_after_s is None:
            continue
        if ent["size"] < rule.min_size_bytes:
            continue
        ages = []
        veto = False
        for srv in ent["holders"]:
            h = _heat_of(srv["id"], "volumes", vid)
            if h is None or h.get("tiered"):
                veto = True  # no report, or .dat already tier-moved
                break
            # read counters are in-memory: "no recorded read" only
            # attests quiet for the server's UPTIME, not forever — a
            # read-hot volume must not get encoded right after a
            # restart wiped its counters (the write age survives via
            # needle timestamps / .dat mtime, reads don't)
            read_age = h.get("last_read_age_s")
            if read_age is None:
                read_age = heat.get(srv["id"], {}).get(
                    "uptime_s", float("inf"))
            ages.append((h.get("last_write_age_s"), read_age))
        if veto:
            plan.skipped_no_heat.append(vid)
            continue
        write_age = min((a for a, _ in ages if a is not None),
                        default=None)
        read_age = min(r for _, r in ages)
        if write_age is None or write_age < rule.ec_after_s:
            continue
        if read_age < rule.ec_after_s:
            continue
        plan.transitions.append(Transition(
            KIND_ENCODE, vid, ent["collection"], ent["size"],
            reason=f"writes quiet {write_age:.0f}s, "
                   + (f"reads quiet {read_age:.0f}s"
                      if read_age != float("inf") else "never read"),
            ttl_s=rule.ttl_s))

    # -- ec -> remote and remote -> ec --------------------------------------
    for vid, ent in sorted(ecs.items()):
        rule = policy.rule_for(ent["collection"])
        if rule is None:
            continue
        reports = []
        veto = False
        for srv in ent["holders"]:
            h = _heat_of(srv["id"], "ec_volumes", vid)
            if h is None:
                veto = True
                break
            reports.append((srv, h))
        if veto:
            plan.skipped_no_heat.append(vid)
            continue
        if any(h.get("destroy_time") for _, h in reports):
            dt = max(h.get("destroy_time", 0) for _, h in reports)
            plan.pending_reaps.append({"vid": vid,
                                       "collection": ent["collection"],
                                       "due_in_s": dt - now})
        elif rule.ttl_s is not None:
            # a ttl rule's EC volume lacking a DestroyTime: stamp one
            # (now + ttl_s at execution). Planned EVERY sweep until the
            # holders' .vifs carry it — a stamp that failed right after
            # the irreversible encode retries instead of silently
            # leaking data past its policy expiry.
            plan.transitions.append(Transition(
                KIND_STAMP, vid, ent["collection"], 0,
                reason=f"ttl rule ({rule.ttl_s:.0f}s), no DestroyTime",
                servers=[srv for srv, _ in reports],
                ttl_s=rule.ttl_s))
        # promote-on-heat beats further cooling: an offloaded volume
        # that is being read does not ALSO get planned for offload
        remote_reads = sum(h.get("remote_reads", 0) for _, h in reports)
        offloaded = [(srv, h) for srv, h in reports
                     if h.get("remote_shards")]
        if offloaded and rule.promote_reads and \
                remote_reads >= rule.promote_reads:
            est = sum(len(h["remote_shards"]) * h.get("shard_size", 0)
                      for _, h in offloaded)
            plan.transitions.append(Transition(
                KIND_PROMOTE, vid, ent["collection"], est,
                reason=f"{remote_reads} remote reads >= "
                       f"{rule.promote_reads}",
                servers=[srv for srv, _ in offloaded]))
            continue
        if rule.remote_after_s is None:
            continue
        local = [(srv, h) for srv, h in reports if h.get("local_shards")]
        if not local:
            continue  # fully offloaded already
        read_age = min(h.get("last_read_age_s", 0.0) for _, h in reports)
        if read_age < rule.remote_after_s:
            continue
        est = sum(len(h["local_shards"]) * h.get("shard_size", 0)
                  for _, h in local)
        plan.transitions.append(Transition(
            KIND_OFFLOAD, vid, ent["collection"], est,
            reason=f"reads quiet {read_age:.0f}s",
            servers=[srv for srv, _ in local],
            remote=rule.remote))

    plan.transitions.sort(
        key=lambda t: (_PRIORITY[t.kind], t.bytes_est, t.vid))
    plan.pending_reaps.sort(key=lambda r: r["due_in_s"])
    return plan
