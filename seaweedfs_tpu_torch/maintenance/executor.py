"""Repair executor: run a plan under an admission budget.

The throttling half of the repair plane (planner.py orders, this module
bounds). Recovery traffic competes with live reads for the same NICs
and spindles — the warehouse study's point is that unthrottled repair
is itself an outage — so every execution enforces:

  * `max_concurrent` repairs in flight (a thread pool, not a convoy);
  * `max_repairs` admitted per run (the rest journal `repair.skipped`
    reason=budget and stay pending for the next sweep);
  * a per-volume lock — two sweeps (cron tick vs. operator trigger vs.
    `cluster.repair`) never double-repair one volume; the loser skips
    with reason=lock;
  * cooldown-with-backoff after a failed repair: a volume whose repair
    just failed is not retried for `cooldown_s * 2^(fails-1)` (capped),
    so a poisoned stripe can't monopolize the budget — it skips with
    reason=cooldown until the window passes;
  * circuit-breaker-aware peer selection (utils/retry): donor/landing
    candidates are ordered healthy-first, and every RPC burst runs
    inside a span so journal events carry trace ids.

Every decision is journaled: `repair.plan` (one per execution, with the
ordered vids), `repair.start` / `repair.done` / `repair.failed` per
item, and `repair.skipped` with its reason — so an operator watching a
nonzero `SeaweedFS_repairs_pending` gauge can tell "throttled" from
"nothing to do" at /debug/events?type=repair.

Dry-run mode journals the plan and returns without creating a single
stub: zero RPCs, mutating or otherwise.

The port's copy of seaweedfs_tpu/maintenance/executor.py.
"""

from __future__ import annotations

import contextvars
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils.log import logger
from .planner import (ACTION_EC_REBUILD, ACTION_EC_REMOUNT,
                      ACTION_REPLICATE, RepairItem, RepairPlan)

log = logger("repair.executor")

SKIP_COOLDOWN, SKIP_LOCK, SKIP_BUDGET = "cooldown", "lock", "budget"


class _InfoSweep:
    """One VolumeEcShardsInfo sweep shared by the remount and geometry
    probes: ONE topology snapshot for the whole plan (a node death
    degrades many stripes at once) and per-(server, stripe) memoized
    responses, so costing an item never re-issues the RPC its remount
    probe just made while the admin lock is held."""

    def __init__(self, env):
        self.env = env
        self._servers: list = []
        self._memo: dict = {}

    def servers(self) -> list:
        if not self._servers:
            self._servers.extend(self.env.collect_volume_servers())
        return self._servers

    def info(self, srv: dict, vid: int, collection: str):
        """The server's VolumeEcShardsInfo response, or None (dead
        server / not a holder) — memoized either way."""
        from ..pb import volume_server_pb2 as vpb
        from ..utils.rpc import Stub, VOLUME_SERVICE
        key = (srv["id"], vid)
        if key in self._memo:
            return self._memo[key]
        try:
            resp = Stub(self.env.grpc_addr(srv["id"], srv["grpc_port"]),
                        VOLUME_SERVICE).call(
                "VolumeEcShardsInfo",
                vpb.VolumeEcShardsInfoRequest(volume_id=vid,
                                              collection=collection),
                vpb.VolumeEcShardsInfoResponse, timeout=5)
        except Exception:  # noqa: BLE001 — a dead server has no disk
            resp = None
        self._memo[key] = resp
        return resp


def make_probes(env) -> tuple:
    """(probe_remountable, probe_geometry) over ONE shared info sweep —
    what build_plan call sites should use."""
    sweep = _InfoSweep(env)
    return (make_remount_probe(env, sweep), make_geometry_probe(env, sweep))


def make_remount_probe(env, sweep: "_InfoSweep | None" = None):
    """Planner probe: which of an EC volume's missing shards still exist
    ON DISK on live servers? Read-only — VolumeEcShardsInfo reports the
    shard files it can see (mounted or not); nothing is mounted, copied,
    or deleted, so `cluster.repair -dryRun` may run it freely."""
    sweep = sweep or _InfoSweep(env)

    def probe(vid: int, missing: list[int], collection: str) -> dict:
        found: dict[str, list[int]] = {}
        claimed: set[int] = set()
        for srv in sweep.servers():
            info = sweep.info(srv, vid, collection)
            if info is None:
                continue
            sids = sorted(set(info.local_shard_ids) & set(missing) - claimed)
            if sids:
                found[srv["id"]] = sids
                claimed.update(sids)
        return found

    return probe


def make_geometry_probe(env, sweep: "_InfoSweep | None" = None):
    """Planner probe: a volume's sealed erasure geometry — codec, d, p,
    shard_size — straight from a holder's .vif (VolumeEcShardsInfo).
    Read-only; feeds the planner's codec-aware `bytes_moved` costing."""
    sweep = sweep or _InfoSweep(env)

    def probe(vid: int, collection: str) -> "dict | None":
        for srv in sweep.servers():
            info = sweep.info(srv, vid, collection)
            if info is not None and info.data_shards:
                return {"codec": info.codec or "rs",
                        "d": info.data_shards, "p": info.parity_shards,
                        "shard_size": info.shard_size,
                        "dat_size": info.dat_size}
        return None

    return probe


class RepairExecutor:
    """Executes RepairPlans against a live cluster through a shell
    CommandEnv. Long-lived by design: the per-volume locks and failure
    cooldowns live on the instance, so the AdminCron keeps ONE executor
    across sweeps and a stripe that failed to rebuild at sweep N is
    still cooling at sweep N+1."""

    def __init__(self, env, max_concurrent: int = 2,
                 max_repairs: int = 64,
                 cooldown_s: float = 60.0, cooldown_max_s: float = 900.0):
        self.env = env
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_repairs = max(1, int(max_repairs))
        self.cooldown_s = cooldown_s
        self.cooldown_max_s = cooldown_max_s
        self._locks: dict[tuple, threading.Lock] = {}
        self._locks_guard = threading.Lock()
        # key -> (consecutive failures, not-before monotonic time)
        self._cooldown: dict[tuple, tuple[int, float]] = {}

    # -- admission state ------------------------------------------------------
    def _lock_for(self, key: tuple) -> threading.Lock:
        with self._locks_guard:
            lk = self._locks.get(key)
            if lk is None:
                lk = self._locks[key] = threading.Lock()
            return lk

    def _cooling(self, key: tuple) -> float:
        """Seconds of cooldown remaining for a volume (0 = clear)."""
        fails, not_before = self._cooldown.get(key, (0, 0.0))
        return max(0.0, not_before - time.monotonic())

    def _record_failure(self, key: tuple) -> float:
        fails, _ = self._cooldown.get(key, (0, 0.0))
        fails += 1
        delay = min(self.cooldown_max_s,
                    self.cooldown_s * (2 ** (fails - 1)))
        self._cooldown[key] = (fails, time.monotonic() + delay)
        return delay

    def _record_success(self, key: tuple) -> None:
        self._cooldown.pop(key, None)

    # -- execution ------------------------------------------------------------
    def execute(self, plan: RepairPlan, dry_run: bool = False) -> dict:
        """Run the plan. Returns a summary dict:
        {done: [...], failed: [...], skipped: [{key, reason}, ...]}."""
        from ..ops import events
        events.emit("repair.plan", items=len(plan.items),
                    unrepairable=len(plan.unrepairable),
                    verdict=plan.verdict, dry_run=dry_run,
                    order=[{"action": it.action, "vid": it.vid,
                            "severity": it.severity,
                            "distance": it.distance}
                           for it in plan.items])
        summary = {"done": [], "failed": [], "skipped": []}
        if dry_run or not plan.items:
            return summary
        # group per volume, preserving plan order: a remount and a
        # rebuild of the same stripe run back-to-back under one lock,
        # never concurrently
        groups: dict[tuple, list[RepairItem]] = {}
        for it in plan.items:
            groups.setdefault(it.key, []).append(it)
        admitted: list[tuple[tuple, list[RepairItem]]] = []
        budget = self.max_repairs
        for key, its in groups.items():
            cooling = self._cooling(key)
            if cooling > 0:
                self._skip(summary, its, SKIP_COOLDOWN,
                           retry_in_s=round(cooling, 1))
                continue
            # admit in strict plan order, partially if the group is
            # bigger than what's left — a most-at-risk volume must never
            # be starved by its own group size while lower-priority
            # items drain the budget behind it
            take, rest = its[:budget], its[budget:]
            if rest:
                self._skip(summary, rest, SKIP_BUDGET)
            if take:
                budget -= len(take)
                admitted.append((key, take))
        lock = threading.Lock()  # guards summary across workers
        with ThreadPoolExecutor(
                max_workers=self.max_concurrent,
                thread_name_prefix="repair") as pool:
            futs = [pool.submit(contextvars.copy_context().run,
                                self._run_group, key, its, summary, lock)
                    for key, its in admitted]
            for f in futs:
                f.result()
        return summary

    def _skip(self, summary: dict, items: list[RepairItem], reason: str,
              lock: threading.Lock | None = None, **attrs) -> None:
        from ..ops import events
        for it in items:
            events.emit("repair.skipped", severity=events.WARN,
                        reason=reason, action=it.action, kind=it.kind,
                        vid=it.vid, **attrs)
            self._count(it.action, "skipped")
            rec = {"action": it.action, "vid": it.vid, "reason": reason}
            if lock is None:
                summary["skipped"].append(rec)
            else:
                with lock:
                    summary["skipped"].append(rec)

    def _run_group(self, key: tuple, items: list[RepairItem],
                   summary: dict, lock: threading.Lock) -> None:
        vol_lock = self._lock_for(key)
        if not vol_lock.acquire(blocking=False):
            self._skip(summary, items, SKIP_LOCK, lock=lock)
            return
        try:
            for it in items:
                self._run_item(it, summary, lock)
        finally:
            vol_lock.release()

    def _run_item(self, it: RepairItem, summary: dict,
                  lock: threading.Lock) -> None:
        from .. import qos, tracing
        from ..ops import events
        # repair traffic is maintenance-class AT THE SOURCE: the tag
        # rides every HTTP header / gRPC metadata hop below (shard
        # fetches, volume copies, replica writes), so enforcement
        # points anywhere in the cluster schedule this work BEHIND
        # foreground reads and ingest instead of beside them
        with qos.tagged(qos.CLASS_MAINTENANCE), tracing.start_span(
                f"repair.{it.action}", component="repair",
                attrs={"vid": it.vid,
                       "severity": it.severity}) as sp:
            events.emit("repair.start", action=it.action, kind=it.kind,
                        vid=it.vid, severity=it.severity,
                        distance=it.distance)
            t0 = time.perf_counter()
            try:
                detail = self._dispatch(it)
            except Exception as e:  # noqa: BLE001 — one repair, one verdict
                retry_in = self._record_failure(it.key)
                sp.set_error(str(e))
                events.emit("repair.failed", severity=events.ERROR,
                            action=it.action, kind=it.kind, vid=it.vid,
                            error=str(e)[:200],
                            retry_in_s=round(retry_in, 1))
                self._count(it.action, "error")
                log.warning("repair %s vol %s failed (cooling %.0fs): %s",
                            it.action, it.vid, retry_in, e)
                with lock:
                    summary["failed"].append(
                        {"action": it.action, "vid": it.vid,
                         "error": str(e)})
                return
            self._record_success(it.key)
            events.emit("repair.done", action=it.action, kind=it.kind,
                        vid=it.vid,
                        duration_ms=round((time.perf_counter() - t0) * 1e3,
                                          1),
                        **(detail or {}))
            self._count(it.action, "ok")
            self._pending_done(it.severity)
            with lock:
                summary["done"].append({"action": it.action, "vid": it.vid})

    # -- actions --------------------------------------------------------------
    def _dispatch(self, it: RepairItem) -> dict | None:
        if it.action == ACTION_EC_REMOUNT:
            return self._do_remount(it)
        if it.action == ACTION_EC_REBUILD:
            return self._do_ec_rebuild(it)
        if it.action == ACTION_REPLICATE:
            return self._do_replicate(it)
        raise ValueError(f"unknown repair action {it.action!r}")

    def _do_remount(self, it: RepairItem) -> dict:
        """Mount shards straight back from the holder's disk — the
        zero-copy repair for shards unmounted by a crashed move/balance
        while their server stayed up."""
        from ..pb import volume_server_pb2 as vpb
        from ..utils.rpc import Stub, VOLUME_SERVICE
        servers = {s["id"]: s for s in self.env.collect_volume_servers()}
        mounted: dict[str, list[int]] = {}
        errs = []
        for node_id, sids in sorted(it.remount.items()):
            srv = servers.get(node_id)
            if srv is None:
                errs.append(f"{node_id}: no longer registered")
                continue
            try:
                Stub(self.env.grpc_addr(srv["id"], srv["grpc_port"]),
                     VOLUME_SERVICE).call(
                    "VolumeEcShardsMount",
                    vpb.VolumeEcShardsMountRequest(
                        volume_id=it.vid, collection=it.collection,
                        shard_ids=sids),
                    vpb.VolumeEcShardsMountResponse, timeout=60)
                mounted[node_id] = sids
            except Exception as e:  # noqa: BLE001
                errs.append(f"{node_id}: {e}")
        if not mounted:
            raise RuntimeError(
                f"remount of ec {it.vid} shards {it.shard_ids} failed "
                f"everywhere: {'; '.join(errs)}")
        return {"remounted": mounted, "errors": errs or None}

    def _do_ec_rebuild(self, it: RepairItem) -> dict:
        """Delegate to the shell's ec.rebuild for one volume: reconstruct
        on the best holder with ranged survivor fetches, remount. The
        shell command already handles settled-holder polling; its
        byte totals flow into the repair.done journal event so the
        codec's repair-traffic win is visible at /debug/events."""
        from ..shell.ec_commands import cmd_ec_rebuild
        res = cmd_ec_rebuild(self.env, ["-volumeId", str(it.vid)]) or {}
        return {"shards": it.shard_ids,
                "bytes_read": res.get("bytes_read", 0),
                "bytes_written": res.get("bytes_written", 0)}

    def _do_replicate(self, it: RepairItem) -> dict:
        """Copy the volume from a healthy holder to `deficit` servers
        that lack it. Prefers the planner's selection but re-resolves
        against the live topology — holders drift between plan and
        execution — and orders candidates through the breakers."""
        from ..shell.volume_commands import _safe_copy_volume
        from ..utils import retry
        servers = {s["id"]: s for s in self.env.collect_volume_servers()}
        live_holders = [sid for sid, s in servers.items()
                        if any(v.id == it.vid for d in s["disks"].values()
                               for v in d.volume_infos)]
        if not live_holders:
            raise RuntimeError(f"volume {it.vid}: no live holder to copy "
                               "from")
        src_id = next((s for s in it.sources if s in live_holders),
                      None) or retry.order_by_breaker(sorted(live_holders))[0]
        planned = [t for t in it.targets
                   if t in servers and t not in live_holders]
        fallback = retry.order_by_breaker(
            sorted(sid for sid in servers
                   if sid not in live_holders and sid not in planned))
        targets = (planned + fallback)[:it.deficit]
        if not targets:
            raise RuntimeError(
                f"volume {it.vid}: every live server already holds it")
        copied = []
        for dst_id in targets:
            _safe_copy_volume(self.env, it.vid, it.collection,
                              servers[src_id], servers[dst_id],
                              delete_source=False)
            copied.append(dst_id)
        return {"source": src_id, "targets": copied}

    # -- metrics --------------------------------------------------------------
    @staticmethod
    def _count(action: str, result: str) -> None:
        try:
            from ..stats import REPAIRS_TOTAL
            REPAIRS_TOTAL.inc(action, result)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break repair)
            pass

    @staticmethod
    def _pending_done(severity: str) -> None:
        try:
            from ..stats import REPAIRS_PENDING
            if REPAIRS_PENDING.value(severity) > 0:
                REPAIRS_PENDING.add(severity, amount=-1)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break repair)
            pass
