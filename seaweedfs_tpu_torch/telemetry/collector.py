"""Leader-resident fleet collector: scrape -> ring TSDB -> merge -> SLO.

Runs on the raft leader only (same contract as the admin cron:
`notify_leadership` wakes it on election, every cycle gates on
`is_leader()` so a deposed master stops scraping between cycles). Each
cycle, on a jittered interval:

1. scrape every target's /metrics (the shared exposition parser,
   stats/parse.py) into the ring TSDB under the target's node id; the
   master ingests its own registry locally — no self-HTTP;
2. mark targets that failed `stale_after` consecutive scrapes stale —
   their series are kept but excluded from merges/rates until they
   answer again (the same overdue-node semantic as the health plane's
   `nodes_stale`; the union of a health-stale set can be fed in via
   `health_stale_fn`). Transitions emit telemetry.stale/.live events;
3. merge per-node heavy-hitter gauge deltas
   (SeaweedFS_hot_requests/bytes{kind,key}) into cluster-wide
   space-saving sketches;
4. evaluate the SLO policy over the TSDB's windowed rates/histograms
   (telemetry/slo.py): burn-rate gauges, slo.burn/slo.ok events,
   health-plane verdict items.

`snapshot()` is the whole plane's read API — /cluster/telemetry and
`cluster.top` both serve it: target states, merged cross-node
histogram percentiles, cluster top-k, SLO status.

Scrapes are sequential with a short per-target timeout: the fleet
sizes this repo drives (benches/chaos: <= ~6 daemons) make a scrape
pool pure complexity; a dead node costs one timeout per cycle until
its stale mark short-circuits nothing — staleness only affects reads,
scrapes keep probing so recovery is observed.

The port's copy of seaweedfs_tpu/telemetry/collector.py.
"""

from __future__ import annotations

import random
import threading
import time

from ..utils.env import env_float
from ..utils.log import logger
from .topk import SpaceSaving
from .tsdb import RingTSDB

log = logger("telemetry")

DEFAULT_INTERVAL_S = 15.0

# histogram families merged into the /cluster/telemetry percentile
# rollup ("" = all present). Kept explicit so the payload stays
# readable; the TSDB itself ingests every family regardless.
MERGE_FAMILIES = (
    "SeaweedFS_volumeServer_request_seconds",
    "SeaweedFS_volumeServer_stage_seconds",
    "SeaweedFS_filer_request_seconds",
    "SeaweedFS_s3_request_seconds",
    "SeaweedFS_qos_wait_seconds",
    "SeaweedFS_event_loop_lag_seconds",
    "SeaweedFS_pool_queue_wait_seconds",
)

HOT_FAMILIES = ("SeaweedFS_hot_requests", "SeaweedFS_hot_bytes")


class TelemetryCollector:
    def __init__(self, node_id: str, targets_fn,
                 is_leader=lambda: True,
                 interval_s: "float | None" = None,
                 slo_policy=None,
                 local_scrape=None,
                 health_stale_fn=None,
                 stale_after: int = 2,
                 scrape_timeout_s: float = 2.0,
                 topk_capacity: int = 32):
        """targets_fn() -> [{"node": id, "url": "http://.../metrics"}].
        `local_scrape` (callable -> exposition text) ingests this
        process's own registry under `node_id` without an HTTP hop.
        `slo_policy` is a parsed SloPolicy (or None: no objectives).
        `interval_s` None reads SWTPU_TELEMETRY_INTERVAL_S (default
        15 s); <= 0 disables the loop entirely (start() no-ops)."""
        self.node_id = node_id
        self.targets_fn = targets_fn
        self.is_leader = is_leader
        if interval_s is None:
            interval_s = env_float("SWTPU_TELEMETRY_INTERVAL_S",
                                   DEFAULT_INTERVAL_S)
        self.interval_s = interval_s
        self.local_scrape = local_scrape
        self.health_stale_fn = health_stale_fn
        self.stale_after = max(1, stale_after)
        self.scrape_timeout_s = scrape_timeout_s
        self.tsdb = RingTSDB()
        self.slo_engine = None
        if slo_policy is not None and slo_policy.slos:
            from .slo import SloEngine
            self.slo_engine = SloEngine(slo_policy, self.tsdb)
        # cluster-wide heavy hitters, merged from per-node gauge deltas
        self.top_requests = {k: SpaceSaving(topk_capacity)
                             for k in ("volume", "tenant", "method")}
        self.top_bytes = {k: SpaceSaving(topk_capacity)
                          for k in ("volume", "tenant", "method")}
        self._hot_prev: dict[tuple, float] = {}
        # latest per-node continuous-profile summary (profiling/), kept
        # beside the TSDB: folded stacks are not series — merging them
        # is a count sum, not a bucket merge
        self._profiles: dict[str, dict] = {}
        self.profile_top = 200
        self._failures: dict[str, int] = {}
        self._last_scrape: dict[str, float] = {}
        self._last_slo: dict = {}
        self.cycles = 0
        self.resumes = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._cycle_lock = threading.Lock()
        self._thread: "threading.Thread | None" = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self.interval_s <= 0:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-collector")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def notify_leadership(self, is_leader: bool) -> None:
        """Raft role-change hook: a fresh leader scrapes promptly
        instead of waiting out a stale timer. Losing leadership needs
        no action — every cycle is leader-gated."""
        if is_leader:
            self.resumes += 1
            self._wake.set()

    def trigger(self) -> None:
        """One cycle now (tests/bench), serialized with the loop."""
        self._cycle()

    # -- loop -----------------------------------------------------------
    def _jittered(self) -> float:
        return self.interval_s * random.uniform(0.8, 1.2)

    def _loop(self) -> None:
        # jittered initial delay: a restarting master quorum must not
        # stampede the fleet with synchronized first scrapes
        wait = self.interval_s * random.uniform(0.1, 0.5)
        while not self._stop.is_set():
            woke = self._wake.wait(timeout=wait)
            if self._stop.is_set():
                return
            if woke:
                self._wake.clear()
            wait = self._jittered()
            if not self.is_leader():
                continue
            try:
                self._cycle()
            except Exception as e:  # noqa: BLE001 — collector must survive
                log.warning("telemetry cycle failed: %s", e)

    # -- one cycle ------------------------------------------------------
    def _cycle(self) -> None:
        with self._cycle_lock:
            now = time.time()
            targets = self._targets()
            for tgt in targets:
                self._scrape_one(tgt, now)
                self._scrape_profile(tgt)
            self._apply_health_stale()
            self._publish_target_gauges(targets)
            self.tsdb.prune(now)
            if self.slo_engine is not None:
                self._last_slo = self.slo_engine.evaluate(now)
            self.cycles += 1

    def _targets(self) -> list[dict]:
        try:
            targets = list(self.targets_fn() or ())
        except Exception as e:  # noqa: BLE001
            log.warning("telemetry targets_fn failed: %s", e)
            targets = []
        if self.local_scrape is not None and not any(
                t["node"] == self.node_id for t in targets):
            targets.insert(0, {"node": self.node_id, "url": ""})
        return targets

    def _scrape_one(self, tgt: dict, now: float) -> None:
        from ..stats import TELEMETRY_SCRAPES
        from ..stats.parse import parse_exposition
        node = tgt["node"]
        try:
            if not tgt.get("url"):
                text = self.local_scrape()
            else:
                from ..client import http_util
                resp = http_util.get(tgt["url"],
                                     timeout=self.scrape_timeout_s)
                if not resp.ok:
                    raise RuntimeError(f"HTTP {resp.status}")
                text = resp.content.decode()
            families = parse_exposition(text)
        except Exception as e:  # noqa: BLE001 — a dead node is data, not a crash
            TELEMETRY_SCRAPES.inc("error")
            n = self._failures.get(node, 0) + 1
            self._failures[node] = n
            if n == self.stale_after:
                self.tsdb.mark_stale(node)
                self._emit_stale(node, True, str(e))
            return
        was_stale = self.tsdb.is_stale(node)
        self.tsdb.ingest(node, families, now)
        self._merge_hot(node, families)
        self._failures[node] = 0
        self._last_scrape[node] = now
        TELEMETRY_SCRAPES.inc("ok")
        if was_stale:
            self._emit_stale(node, False)

    def _scrape_profile(self, tgt: dict) -> None:
        """Latest continuous-profile summary per target, riding the
        scrape cycle. The profile endpoint shares the metrics port, so
        the URL is derived by swapping the exposition path suffix. A
        failed profile fetch never marks the node stale — /metrics is
        the liveness signal; a daemon with the sampler paused (hz=0)
        still answers with an empty summary."""
        node = tgt["node"]
        try:
            if not tgt.get("url"):
                from ..profiling import default_sampler
                s = default_sampler()
                if s is None:
                    self._profiles.pop(node, None)
                    return
                self._profiles[node] = s.summary(top=self.profile_top)
                return
            base = tgt["url"].rsplit("/", 1)[0]
            from ..client import http_util
            resp = http_util.get(
                f"{base}/debug/profile?mode=summary&top={self.profile_top}",
                timeout=self.scrape_timeout_s)
            if not resp.ok:
                raise RuntimeError(f"HTTP {resp.status}")
            import json
            prof = json.loads(resp.content.decode())
            if isinstance(prof, dict):
                self._profiles[node] = prof
        except Exception as e:  # noqa: BLE001 — profile loss is not node loss
            log.debug("profile scrape %s failed: %s", node, e)

    def _emit_stale(self, node: str, stale: bool, why: str = "") -> None:
        from ..ops import events
        if stale:
            events.emit("telemetry.stale", severity=events.WARN,
                        node=node, error=why,
                        consecutive_failures=self._failures.get(node, 0))
        else:
            events.emit("telemetry.live", node=node)

    def _apply_health_stale(self) -> None:
        """Union in the health plane's overdue-heartbeat view: a node
        the master already counts in nodes_stale should not look fresh
        here just because its HTTP port still answers."""
        if self.health_stale_fn is None:
            return
        try:
            for node in self.health_stale_fn() or ():
                if not self.tsdb.is_stale(node):
                    self.tsdb.mark_stale(node)
                    self._emit_stale(node, True, "health: heartbeat overdue")
        except Exception as e:  # noqa: BLE001
            log.debug("health stale feed failed: %s", e)

    def _publish_target_gauges(self, targets: list[dict]) -> None:
        try:
            from ..stats import TELEMETRY_TARGETS
            stale = self.tsdb.stale_nodes()
            nodes = {t["node"] for t in targets}
            TELEMETRY_TARGETS.set("stale", value=len(nodes & stale))
            TELEMETRY_TARGETS.set("live", value=len(nodes - stale))
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break the cycle)
            pass

    def _merge_hot(self, node: str, families: dict) -> None:
        """Per-node heavy-hitter gauge deltas -> cluster sketches.
        Sketch counts can jump when a key inherits an evicted counter,
        so deltas are clamped at zero — the cluster view is an
        estimate with the same guaranteed-bound flavor as its inputs."""
        for fam_name, sketches in (("SeaweedFS_hot_requests",
                                    self.top_requests),
                                   ("SeaweedFS_hot_bytes",
                                    self.top_bytes)):
            fam = families.get(fam_name)
            if fam is None:
                continue
            for s in fam.samples:
                ld = s.label_dict()
                kind, key = ld.get("kind"), ld.get("key")
                if kind not in sketches or not key:
                    continue
                pk = (node, fam_name, kind, key)
                prev = self._hot_prev.get(pk, 0.0)
                self._hot_prev[pk] = s.value
                delta = s.value - prev
                if delta > 0:
                    sketches[kind].offer(key, delta)

    # -- read API -------------------------------------------------------
    def merged_histograms(self) -> dict:
        """Cumulative cross-node merge per family per label set:
        {family: {label_str: {count, mean, p50, p90, p99}}} from each
        non-stale node's latest scrape."""
        import math

        from .merge import summarize
        out: dict = {}
        for family in MERGE_FAMILIES:
            # group latest bucket samples by labelset-minus-le
            groups: dict[tuple, dict[float, float]] = {}
            sums: dict[tuple, float] = {}
            for node, sname, labels in self.tsdb._matching(
                    family + "_bucket", None, False):
                ld = dict(labels)
                le_raw = ld.pop("le", None)
                if le_raw is None:
                    continue
                pt = self.tsdb.latest(node, sname, labels)
                if pt is None:
                    continue
                le = math.inf if le_raw == "+Inf" else float(le_raw)
                key = tuple(sorted(ld.items()))
                groups.setdefault(key, {})
                groups[key][le] = groups[key].get(le, 0.0) + pt[1]
            for node, sname, labels in self.tsdb._matching(
                    family + "_sum", None, False):
                pt = self.tsdb.latest(node, sname, labels)
                if pt is not None:
                    sums[labels] = sums.get(labels, 0.0) + pt[1]
            if not groups:
                continue
            fam_out = {}
            for key, buckets in sorted(groups.items()):
                label_str = ",".join(f"{k}={v}" for k, v in key) or "all"
                fam_out[label_str] = summarize(
                    sorted(buckets.items()), sums.get(key))
            out[family] = fam_out
        return out

    def top_k(self, limit: int = 10) -> dict:
        return {
            "requests": {k: sk.items(limit)
                         for k, sk in self.top_requests.items()},
            "bytes": {k: sk.items(limit)
                      for k, sk in self.top_bytes.items()},
        }

    def target_states(self) -> list[dict]:
        stale = self.tsdb.stale_nodes()
        out = []
        for tgt in self._targets():
            node = tgt["node"]
            out.append({
                "node": node, "url": tgt.get("url") or "(local)",
                "dc": tgt.get("dc", ""), "rack": tgt.get("rack", ""),
                "stale": node in stale,
                "consecutive_failures": self._failures.get(node, 0),
                "last_scrape_ts": self._last_scrape.get(node),
            })
        return out

    def health_items(self) -> list[dict]:
        """Verdict input for the health plane: burning SLOs."""
        if self.slo_engine is None:
            return []
        return self.slo_engine.health_items()

    def merged_profile(self, top: int = 50) -> dict:
        """Fleet flamegraph: per-node summaries summed by folded stack.
        Stacks beyond `top` collapse into their class's `~other` bucket
        (the same convention the sampler uses for its own bounds), so
        total counts stay exact — cluster.profile's per-class totals
        equal the sum of every node's, regardless of truncation."""
        stale = self.tsdb.stale_nodes()
        nodes: dict[str, dict] = {}
        classes: dict[str, dict] = {}
        stacks: dict[str, int] = {}
        for node, prof in sorted(self._profiles.items()):
            if node in stale:
                continue
            nodes[node] = {"samples": int(prof.get("samples", 0)),
                           "hz": prof.get("hz"),
                           "ticks": int(prof.get("ticks", 0))}
            for cls, st in (prof.get("classes") or {}).items():
                agg = classes.setdefault(cls, {"on_cpu": 0, "waiting": 0})
                agg["on_cpu"] += int(st.get("on_cpu", 0))
                agg["waiting"] += int(st.get("waiting", 0))
            for it in prof.get("stacks") or ():
                key = it.get("stack")
                if not isinstance(key, str):
                    continue
                stacks[key] = stacks.get(key, 0) + int(it.get("count", 0))
        ordered = sorted(stacks.items(), key=lambda kv: (-kv[1], kv[0]))
        kept = dict(ordered[:max(0, top)])
        for key, n in ordered[max(0, top):]:
            parts = key.split(";", 2)
            okey = (f"{parts[0]};{parts[1]};~other" if len(parts) == 3
                    else "other;on_cpu;~other")
            kept[okey] = kept.get(okey, 0) + n
        return {
            "nodes": nodes,
            "samples": sum(n["samples"] for n in nodes.values()),
            "classes": classes,
            "stacks": [{"stack": k, "count": v} for k, v in
                       sorted(kept.items(), key=lambda kv: (-kv[1], kv[0]))],
        }

    def snapshot(self, top_limit: int = 10,
                 include_profile: bool = False) -> dict:
        """The /cluster/telemetry payload."""
        out = {
            "node": self.node_id,
            "leader": bool(self.is_leader()),
            "interval_s": self.interval_s,
            "cycles": self.cycles,
            "targets": self.target_states(),
            "merged": self.merged_histograms(),
            "top": self.top_k(top_limit),
            "slo": self._last_slo or (
                {"policy": None, "status": [], "burning": []}),
        }
        if include_profile:
            out["profile"] = self.merged_profile()
        return out
