"""Lifecycle executor: run a transition plan under a byte-costed budget.

The throttling half of the lifecycle plane, shaped like the repair
executor it sits beside (maintenance/executor.py): lifecycle traffic is
background by definition, so every run enforces

  * a BYTE budget per run (`max_bytes`) on top of a transition count
    cap — tier moves are priced in the same currency as repairs
    (bytes_moved), and a sweep never moves more than its allowance; the
    rest journal `lifecycle.skipped` reason=budget and stay pending for
    the next sweep (an oversized single transition is admitted only
    when the budget is untouched, the breaker's oversized-request-
    passes-idle rule — otherwise a giant volume could never move);
  * per-volume locks — a cron sweep and an operator `lifecycle.apply`
    never double-move one volume (loser skips reason=lock);
  * cooldown-with-backoff after a failed transition (reason=cooldown),
    so an unreachable remote tier can't monopolize every sweep;
  * maintenance-class QoS tagging around every dispatch — the encode
    reads, shard uploads and promote downloads all yield to foreground
    tenants at every enforcement point they cross.

Every decision is journaled: `lifecycle.plan` per execution, then
`lifecycle.transition` / `lifecycle.failed` / `lifecycle.skipped` per
volume, with `SeaweedFS_lifecycle_transitions_total{from,to}` and
`SeaweedFS_lifecycle_bytes_moved_total{from,to}` metering the flows.
Dry-run journals the plan and returns without one mutating RPC.

The port's copy of seaweedfs_tpu/lifecycle/executor.py. Port-only: a
transition whose turn comes after the env's owner was deposed
(`shell.commands.deposed`, the admin cron's leadership check) is skipped
with reason "leadership lost"; the reference runs the whole plan.
"""

from __future__ import annotations

import contextvars
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils.log import logger
from .planner import (KIND_ENCODE, KIND_OFFLOAD, KIND_PROMOTE, KIND_STAMP,
                      LifecyclePlan, Transition)

log = logger("lifecycle.executor")

SKIP_COOLDOWN, SKIP_LOCK, SKIP_BUDGET = "cooldown", "lock", "budget"
SKIP_DEPOSED = "leadership lost"

DEFAULT_MAX_BYTES = 10 << 30  # 10 GB of tier moves per sweep


class LifecycleExecutor:
    """Executes LifecyclePlans through a shell CommandEnv. Long-lived
    like the repair executor: per-volume locks and failure cooldowns
    live on the instance so the AdminCron keeps ONE across sweeps."""

    def __init__(self, env, max_concurrent: int = 2,
                 max_transitions: int = 16,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 cooldown_s: float = 60.0, cooldown_max_s: float = 900.0):
        self.env = env
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_transitions = max(1, int(max_transitions))
        self.max_bytes = max(1, int(max_bytes))
        self.cooldown_s = cooldown_s
        self.cooldown_max_s = cooldown_max_s
        self._locks: dict[tuple, threading.Lock] = {}
        self._locks_guard = threading.Lock()
        self._cooldown: dict[tuple, tuple[int, float]] = {}

    # -- admission state (repair-executor shape) ----------------------------
    def _lock_for(self, key: tuple) -> threading.Lock:
        with self._locks_guard:
            lk = self._locks.get(key)
            if lk is None:
                lk = self._locks[key] = threading.Lock()
            return lk

    def _cooling(self, key: tuple) -> float:
        _fails, not_before = self._cooldown.get(key, (0, 0.0))
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

    # -- execution -----------------------------------------------------------
    def execute(self, plan: LifecyclePlan, dry_run: bool = False) -> dict:
        """Run the plan. Returns {done, failed, skipped} summaries."""
        from ..ops import events
        events.emit("lifecycle.plan", transitions=len(plan.transitions),
                    pending_reaps=len(plan.pending_reaps),
                    bytes_est=plan.total_bytes, dry_run=dry_run,
                    order=[{"kind": t.kind, "vid": t.vid,
                            "from": t.from_tier, "to": t.to_tier,
                            "bytes_est": t.bytes_est}
                           for t in plan.transitions])
        summary = {"done": [], "failed": [], "skipped": []}
        if dry_run or not plan.transitions:
            return summary
        admitted: list[Transition] = []
        budget_n = self.max_transitions
        budget_b = self.max_bytes
        for t in plan.transitions:
            cooling = self._cooling(t.key)
            if cooling > 0:
                self._skip(summary, t, SKIP_COOLDOWN,
                           retry_in_s=round(cooling, 1))
                continue
            over = budget_n <= 0 or t.bytes_est > budget_b
            # oversized-first-transition rule: an untouched byte budget
            # admits one transition bigger than itself
            if over and not (budget_b == self.max_bytes and budget_n > 0
                             and t.bytes_est > self.max_bytes):
                self._skip(summary, t, SKIP_BUDGET)
                continue
            budget_n -= 1
            budget_b -= t.bytes_est
            admitted.append(t)
        lock = threading.Lock()  # guards summary across workers
        with ThreadPoolExecutor(max_workers=self.max_concurrent,
                                thread_name_prefix="lifecycle") as pool:
            futs = [pool.submit(contextvars.copy_context().run,
                                self._run_one, t, summary, lock)
                    for t in admitted]
            for f in futs:
                f.result()
        return summary

    def _skip(self, summary: dict, t: Transition, reason: str,
              lock: "threading.Lock | None" = None, **attrs) -> None:
        from ..ops import events
        events.emit("lifecycle.skipped", severity=events.WARN,
                    reason=reason, kind=t.kind, vid=t.vid,
                    bytes_est=t.bytes_est, **attrs)
        rec = {"kind": t.kind, "vid": t.vid, "reason": reason}
        if lock is None:
            summary["skipped"].append(rec)
        else:
            with lock:
                summary["skipped"].append(rec)

    def _run_one(self, t: Transition, summary: dict,
                 lock: threading.Lock) -> None:
        from .. import qos, tracing
        from ..ops import events
        from ..shell.commands import deposed
        if deposed(self.env):
            self._skip(summary, t, SKIP_DEPOSED, lock=lock)
            return
        vol_lock = self._lock_for(t.key)
        if not vol_lock.acquire(blocking=False):
            self._skip(summary, t, SKIP_LOCK, lock=lock)
            return
        try:
            # maintenance-class at the source: the tag rides every HTTP
            # header / gRPC metadata hop below, so the encode's reads,
            # the shard uploads and the promote downloads all admit
            # BEHIND foreground tenants wherever they land
            with qos.tagged(qos.CLASS_MAINTENANCE), tracing.start_span(
                    f"lifecycle.{t.kind}", component="lifecycle",
                    attrs={"vid": t.vid, "from": t.from_tier,
                           "to": t.to_tier}) as sp:
                t0 = time.perf_counter()
                try:
                    moved = self._dispatch(t)
                except Exception as e:  # noqa: BLE001 — one move, one verdict
                    retry_in = self._record_failure(t.key)
                    sp.set_error(str(e))
                    events.emit("lifecycle.failed", severity=events.ERROR,
                                kind=t.kind, vid=t.vid,
                                error=str(e)[:200],
                                retry_in_s=round(retry_in, 1))
                    log.warning("lifecycle %s vol %s failed "
                                "(cooling %.0fs): %s",
                                t.kind, t.vid, retry_in, e)
                    with lock:
                        summary["failed"].append(
                            {"kind": t.kind, "vid": t.vid,
                             "error": str(e)})
                    return
                self._record_success(t.key)
                events.emit("lifecycle.transition", kind=t.kind,
                            vid=t.vid, collection=t.collection,
                            **{"from": t.from_tier, "to": t.to_tier},
                            bytes_moved=moved,
                            duration_ms=round(
                                (time.perf_counter() - t0) * 1e3, 1))
                self._count(t.from_tier, t.to_tier, moved)
                with lock:
                    summary["done"].append(
                        {"kind": t.kind, "vid": t.vid,
                         "bytes_moved": moved})
        finally:
            vol_lock.release()

    # -- actions -------------------------------------------------------------
    def _dispatch(self, t: Transition) -> int:
        if t.kind == KIND_ENCODE:
            return self._do_encode(t)
        if t.kind == KIND_OFFLOAD:
            return self._do_offload(t)
        if t.kind == KIND_PROMOTE:
            return self._do_promote(t)
        if t.kind == KIND_STAMP:
            return self._do_stamp(t)
        raise ValueError(f"unknown lifecycle transition {t.kind!r}")

    def _do_encode(self, t: Transition) -> int:
        """hot→ec through the shell verb: the overlapped device encode
        pipeline plus the placement core's rack-safe spread, exactly
        what an operator's ec.encode does. A rule TTL is NOT stamped
        here — the encode is irreversible and the stamp must stay
        retryable, so the planner emits a separate stamp_ttl transition
        every sweep until the .vifs carry the DestroyTime."""
        from ..shell.ec_commands import cmd_ec_encode
        cmd_ec_encode(self.env, ["-volumeId", str(t.vid)])
        return t.bytes_est

    def _do_stamp(self, t: Transition) -> int:
        """Stamp DestroyTime = now + ttl_s onto EVERY holder's .vif via
        the authenticated gRPC verb (the stamp rides the cluster token
        like any control-plane RPC, so guarded clusters work); the
        existing reap path (fork store.go:389) then retires the stripe
        on schedule. ANY holder failing fails the transition — the next
        sweep re-plans it (the planner keys on destroy_time == 0)."""
        from ..pb import volume_server_pb2 as vpb
        from ..utils.rpc import Stub, VOLUME_SERVICE
        if not t.servers:
            raise RuntimeError(
                f"no registered holders to stamp DestroyTime on {t.vid}")
        at = time.time() + (t.ttl_s or 0.0)  # swtpu-lint: disable=wallclock-duration (DestroyTime is persisted wall-clock)
        errs = []
        for srv in t.servers:
            try:
                # VolumeTailReceiverRequest reuse (see the proto tiering
                # note): since_ns carries the DestroyTime instant in ns
                Stub(self.env.grpc_addr(srv["id"], srv["grpc_port"]),
                     VOLUME_SERVICE).call(
                    "VolumeEcShardsSetDestroyTime",
                    vpb.VolumeTailReceiverRequest(
                        volume_id=t.vid, since_ns=int(at * 1e9),
                        source_volume_server=t.collection),
                    vpb.VolumeTailReceiverResponse, timeout=30)
            except Exception as e:  # noqa: BLE001
                errs.append(f"{srv['id']}: {e}")
        if errs:
            raise RuntimeError(
                f"DestroyTime stamp incomplete for {t.vid}: "
                f"{'; '.join(errs)}")
        return 0

    def _per_holder(self, t: Transition, method: str, req) -> int:
        from ..pb import volume_server_pb2 as vpb
        from ..utils.rpc import Stub, VOLUME_SERVICE
        resp_cls = (vpb.VolumeTierMoveDatToRemoteResponse
                    if method.endswith("ToRemote")
                    else vpb.VolumeTierMoveDatFromRemoteResponse)
        moved = 0
        errs = []
        for srv in t.servers:
            try:
                resp = Stub(self.env.grpc_addr(srv["id"],
                                               srv["grpc_port"]),
                            VOLUME_SERVICE).call(
                    method, req, resp_cls, timeout=600)
                moved += int(resp.processed)
            except Exception as e:  # noqa: BLE001
                errs.append(f"{srv['id']}: {e}")
        if errs:
            # partial tier state is safe (each holder is independently
            # consistent) but the transition is not done: fail it so
            # cooldown + the next sweep finish the stragglers
            raise RuntimeError(
                f"{method} incomplete for volume {t.vid} "
                f"({moved} bytes moved): {'; '.join(errs)}")
        return moved

    def _do_offload(self, t: Transition) -> int:
        from ..pb import volume_server_pb2 as vpb
        return self._per_holder(
            t, "VolumeEcShardsTierMoveToRemote",
            vpb.VolumeTierMoveDatToRemoteRequest(
                volume_id=t.vid, collection=t.collection,
                destination_backend_name=t.remote))

    def _do_promote(self, t: Transition) -> int:
        from ..pb import volume_server_pb2 as vpb
        return self._per_holder(
            t, "VolumeEcShardsTierMoveFromRemote",
            vpb.VolumeTierMoveDatFromRemoteRequest(
                volume_id=t.vid, collection=t.collection))

    # -- metrics -------------------------------------------------------------
    @staticmethod
    def _count(from_tier: str, to_tier: str, nbytes: int) -> None:
        if from_tier == to_tier:
            return  # metadata-only (stamp_ttl): no tier move to meter
        try:
            from ..stats import LIFECYCLE_BYTES_MOVED, LIFECYCLE_TRANSITIONS
            LIFECYCLE_TRANSITIONS.inc(from_tier, to_tier)
            LIFECYCLE_BYTES_MOVED.inc(from_tier, to_tier, amount=nbytes)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break a tier move)
            pass
