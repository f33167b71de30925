"""The shared QoS scheduler core both tiers enforce through (the port's
copy of seaweedfs_tpu/qos/scheduler.py; its metrics go to the port's
`stats`, its events to the port's `ops/events`). One difference: a pump
pass that ends with a head waiting only for its tenant's round-robin
deficit runs the next pass at once. The reference waits its 0.5 s idle tick
between such passes, so a head costing n quanta waits n ticks (a 32 MiB
read under the default 64 KiB quantum, ~2 min, alone on the node); the
deficit still grows a quantum a visit, so the order of grants is the
reference's.

One `QosScheduler` instance lives on each enforcement point (volume
server, S3 gateway). Admission of one request walks three mechanisms:

  1. hierarchical token buckets — the tenant's request+byte buckets,
     nested under the class's and the node's. All-or-nothing: a grant
     debits every level, a miss refunds what it took and yields an ETA;
  2. weighted-fair queueing — a request that can't be granted NOW
     queues per (tenant, class); a pump thread drains queues with
     deficit round-robin (byte-costed quanta scaled by tenant weight)
     so a tenant's share under contention tracks its policy weight,
     not its offered load;
  3. priority classes — queues are served interactive > ingest >
     maintenance, and maintenance is only served at all when no
     foreground work is queued (plus a starvation grace so a repair
     can't be parked forever).

Sheds are explicit and costed: a request whose wait would exceed its
class's max_wait_s (or whose tenant queue is full) fails fast with
`QosShed` carrying a Retry-After estimate from the blocking bucket —
the enforcement points turn that into 503 + Retry-After, matching real
S3's SlowDown contract.

The scheduler is loop-agnostic and thread-safe: async handlers await
`admit()`, gRPC handler threads call `admit_sync()`, and internal
replica hops use `no_shed=True` (charge the buckets, never block —
the primary hop already paid, and shedding a replica write would turn
throttling into data-loss risk).

Everything observable: per-tenant request/byte/shed counters (bounded
tenant label via the policy's max_tenants + "~other" overflow), queue
depth gauges, a wait histogram with trace exemplars, `qos.shed` /
`qos.throttle` journal events, and a full live dump for /debug/qos.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

from ..utils.log import logger
from . import CLASS_INGEST, CLASS_INTERACTIVE, CLASS_MAINTENANCE, CLASSES, \
    OVERFLOW_TENANT
from .policy import BucketSpec, QosPolicy, TenantSpec, parse_policy

log = logger("qos")

_FOREGROUND = (CLASS_INTERACTIVE, CLASS_INGEST)
# pump idle tick: bounds how stale a time-based grant can go even if a
# notify is lost, and doubles as the policy-file mtime poll period
_IDLE_TICK_S = 0.5
# journal rate limit: at most one qos.shed / qos.throttle event per
# tenant per second (a shed storm is exactly when the ring must not be
# 100% qos events; the counters carry the true rate)
_EVENT_INTERVAL_S = 1.0


class QosShed(Exception):
    """Request refused by admission control. `retry_after_s` is the
    bucket ETA the 503's Retry-After header advertises."""

    def __init__(self, tenant: str, klass: str, reason: str,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"qos shed tenant={tenant} class={klass}: {reason} "
            f"(retry in ~{retry_after_s:.1f}s)")
        self.tenant = tenant
        self.klass = klass
        self.reason = reason
        self.retry_after_s = max(0.1, retry_after_s)

    @property
    def retry_after_header(self) -> str:
        return str(max(1, math.ceil(self.retry_after_s)))


class TokenBucket:
    """Monotonic-clock token bucket. rate 0 = unlimited (no state).
    NOT self-locking — the scheduler's lock covers every access."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(1.0, float(rate))
        self.tokens = self.burst
        self._last = now

    def _refill(self, now: float) -> None:
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now

    def eta(self, n: float, now: float) -> float:
        """Seconds until n tokens are available (0 = now). A cost larger
        than the whole burst is grantable at full bucket (the classic
        oversized-packet rule), so eta targets min(n, burst)."""
        if self.rate <= 0:
            return 0.0
        self._refill(now)
        need = min(n, self.burst) - self.tokens
        # float refill arithmetic leaves ~1e-15 residues; a "wait" that
        # small is a rounding artifact, not a throttle decision
        return need / self.rate if need > 1e-9 else 0.0

    def take(self, n: float, now: float) -> float:
        """Debit n if available; returns 0.0 on success else the ETA
        (nothing debited)."""
        wait = self.eta(n, now)
        if wait > 0:
            return wait
        if self.rate > 0:
            self.tokens -= n  # may go negative on an oversized cost
        return 0.0

    def force(self, n: float, now: float) -> None:
        """Unconditional debit (post-facto byte charges, no_shed hops):
        tokens may go negative, pushing future ETAs out — long-term
        rate stays honest even when the cost is only known after."""
        if self.rate > 0:
            self._refill(now)
            self.tokens -= n

    def refund(self, n: float) -> None:
        if self.rate > 0:
            self.tokens = min(self.burst, self.tokens + n)


class _BucketPair:
    """Request-count + byte buckets for one level of the hierarchy,
    plus that level's inflight cap."""

    __slots__ = ("req", "byt", "max_inflight", "inflight")

    def __init__(self, spec: BucketSpec, now: float, inflight: int = 0):
        self.req = (TokenBucket(spec.rps, spec.burst, now)
                    if spec.rps else None)
        self.byt = (TokenBucket(spec.bytes_per_s, spec.burst_bytes, now)
                    if spec.bytes_per_s else None)
        self.max_inflight = spec.max_inflight
        self.inflight = inflight

    def at_cap(self) -> bool:
        return bool(self.max_inflight) and \
            self.inflight >= self.max_inflight

    def eta(self, cost: float, now: float) -> float:
        wait = self.req.eta(1, now) if self.req else 0.0
        if self.byt is not None:
            if cost > 0:
                wait = max(wait, self.byt.eta(cost, now))
            else:
                # size-unknown requests (reads post-charge their
                # response) still honor byte DEBT: once post-facto
                # charges drove the bucket negative, nothing more runs
                # until the debt repays at the configured rate
                self.byt._refill(now)
                if self.byt.tokens < 0:
                    wait = max(wait, -self.byt.tokens / self.byt.rate)
        return wait

    def take(self, cost: float, now: float) -> None:
        if self.req:
            self.req.tokens -= 1
        if self.byt and cost > 0:
            self.byt.tokens -= cost

    def refund(self, cost: float) -> None:
        if self.req:
            self.req.refund(1)
        if self.byt and cost > 0:
            self.byt.refund(cost)

    def force(self, cost: float, now: float) -> None:
        if self.req:
            self.req.force(1, now)
        if self.byt and cost > 0:
            self.byt.force(cost, now)


class _Tenant:
    __slots__ = ("name", "spec", "pair", "deficit", "admitted", "shed",
                 "bytes")

    def __init__(self, name: str, spec: TenantSpec, now: float,
                 inflight: int = 0):
        self.name = name
        self.spec = spec
        self.pair = _BucketPair(spec, now, inflight)
        self.deficit: dict[str, float] = {k: 0.0 for k in CLASSES}
        self.admitted = 0
        self.shed = 0
        self.bytes = 0


class _Waiter:
    __slots__ = ("tenant", "klass", "cost", "enq", "deadline", "notify",
                 "done")

    def __init__(self, tenant: str, klass: str, cost: float, enq: float,
                 deadline: float, notify):
        self.tenant = tenant
        self.klass = klass
        self.cost = cost
        self.enq = enq
        self.deadline = deadline
        self.notify = notify  # called with a Grant or a QosShed
        self.done = False


class Grant:
    """One admitted request. Hold for the request's lifetime; `charge`
    debits bytes discovered after admission (GET response sizes);
    `release` frees the inflight slots and wakes the pump. Usable as a
    context manager. A disabled scheduler hands out inert grants."""

    __slots__ = ("_sched", "tenant", "klass", "_released")

    def __init__(self, sched: "QosScheduler | None", tenant: str = "",
                 klass: str = ""):
        self._sched = sched
        self.tenant = tenant
        self.klass = klass
        self._released = False

    def charge(self, nbytes: int) -> None:
        if self._sched is not None and nbytes > 0:
            self._sched._charge(self.tenant, self.klass, nbytes)

    def release(self) -> None:
        if self._sched is not None and not self._released:
            self._released = True
            self._sched._release(self.tenant, self.klass)

    def __enter__(self) -> "Grant":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


_NOOP_GRANT = Grant(None)


class QosScheduler:
    """See module docstring. One instance per enforcement point."""

    def __init__(self, policy: "dict | QosPolicy | None" = None,
                 clock=time.monotonic, name: str = "qos"):
        self._clock = clock
        self.name = name
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tenants: dict[str, _Tenant] = {}
        self._queues: dict[tuple[str, str], deque] = {}  # (tenant, class)
        self._rr: dict[str, deque] = {k: deque() for k in CLASSES}
        # tenant currently mid-service per class: a shared-bucket stall
        # resumes HERE next pass without re-crediting its deficit, so a
        # rate-limited round still walks the whole rotation instead of
        # re-serving whoever happens to sit at the head on every refill
        self._mid: dict[str, "str | None"] = {k: None for k in CLASSES}
        self._classes: dict[str, _BucketPair] = {}
        self._node: _BucketPair | None = None
        self._policy = QosPolicy(enabled=False)
        self._pump: threading.Thread | None = None
        self._stopping = False
        self._file: str | None = None
        self._file_mtime = 0.0
        self._last_event: dict[tuple[str, str], float] = {}
        self.shed_total = 0
        self.admitted_total = 0
        # the last pass left a head waiting only for round-robin deficit
        self._deficit_stalled = False
        if policy is not None:
            self.load(policy)

    # -- policy lifecycle ----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._policy.enabled

    def load(self, policy: "dict | QosPolicy | None") -> None:
        """(Re)apply a policy document — the hot-reload entry point
        (POST /debug/qos, the /etc/qos watcher, -qosPolicy mtime poll).
        Queued waiters survive; bucket levels reset to full burst;
        inflight counts carry over so caps stay accurate across a
        reload."""
        pol = (policy if isinstance(policy, QosPolicy)
               else parse_policy(policy))
        now = self._clock()
        start_pump = False
        with self._lock:
            inflight = {n: t.pair.inflight for n, t in self._tenants.items()}
            cls_inflight = {k: p.inflight for k, p in self._classes.items()}
            node_inflight = self._node.inflight if self._node else 0
            self._policy = pol
            self._tenants = {}
            self._classes = {
                k: _BucketPair(pol.class_spec(k), now,
                               cls_inflight.get(k, 0))
                for k in CLASSES}
            self._node = _BucketPair(pol.node, now, node_inflight)
            for name in list(inflight) + list(pol.tenants):
                if name not in self._tenants:
                    self._tenants[name] = _Tenant(
                        name, pol.tenant_spec(name), now,
                        inflight.get(name, 0))
            if (pol.enabled or self._file) and self._pump is None \
                    and not self._stopping:
                start_pump = True
            self._cond.notify_all()
        if start_pump:
            self._start_pump()
        log.info("%s: policy %s (%d named tenants)", self.name,
                 "enabled" if pol.enabled else "disabled",
                 len(pol.tenants))

    def attach_file(self, path: str) -> None:
        """Load policy from a JSON file and hot-reload it whenever the
        file's mtime moves (checked on the pump's idle tick)."""
        self._file = path
        self._reload_file(initial=True)
        with self._lock:
            need = self._pump is None and not self._stopping
        if need:
            self._start_pump()

    def _reload_file(self, initial: bool = False) -> None:
        import json
        import os
        path = self._file
        if not path:
            return
        try:
            mtime = os.stat(path).st_mtime
        except OSError as e:
            if initial:
                log.warning("%s: policy file %s unreadable (%s); "
                            "qos disabled", self.name, path, e)
                self.load(None)
            return
        if not initial and mtime == self._file_mtime:
            return
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            self.load(doc)
            self._file_mtime = mtime
            if not initial:
                log.info("%s: policy reloaded from %s", self.name, path)
        except (ValueError, OSError) as e:
            # a broken edit must not tear down the running policy
            log.error("%s: policy file %s rejected: %s", self.name, path, e)
            self._file_mtime = mtime

    def close(self) -> None:
        """Stop the pump and shed every queued waiter (shutdown)."""
        with self._lock:
            self._stopping = True
            waiters = [w for q in self._queues.values() for w in q
                       if not w.done]
            for q in self._queues.values():
                q.clear()
            self._cond.notify_all()
        for w in waiters:
            w.done = True
            w.notify(QosShed(w.tenant, w.klass, "scheduler shutdown", 1.0))
        pump = self._pump
        if pump is not None:
            pump.join(timeout=5.0)
            self._pump = None

    # -- admission -----------------------------------------------------------
    async def admit(self, tenant: str, klass: str, cost: int = 0,
                    no_shed: bool = False) -> Grant:
        """Async admission (the HTTP handlers' entry point). Returns a
        Grant, raising QosShed when refused. `no_shed` charges the
        buckets but never queues or refuses (internal replica hops)."""
        if not self._policy.enabled:
            return _NOOP_GRANT
        if no_shed:
            return self._admit_forced(tenant, klass, cost)
        import asyncio
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def notify(res):
            def _set():
                if fut.done():
                    # the awaiting task was cancelled (client gone
                    # while throttled): the granted slots must go back
                    # or the inflight caps leak shut one by one
                    if isinstance(res, Grant):
                        res.release()
                    return
                if isinstance(res, BaseException):
                    fut.set_exception(res)
                else:
                    fut.set_result(res)
            try:
                loop.call_soon_threadsafe(_set)
            except RuntimeError:  # loop already closed
                if isinstance(res, Grant):
                    res.release()

        self._submit(tenant, klass, cost, notify)
        return await fut

    def admit_sync(self, tenant: str, klass: str, cost: int = 0,
                   timeout: "float | None" = None) -> Grant:
        """Blocking admission for thread-based callers (gRPC handlers
        serving maintenance-tagged survivor reads)."""
        if not self._policy.enabled:
            return _NOOP_GRANT
        box: list = []
        ev = threading.Event()
        abandoned = [False]
        nlock = threading.Lock()

        def notify(res):
            with nlock:
                if abandoned[0]:
                    # caller timed out and left: hand the slots back
                    if isinstance(res, Grant):
                        res.release()
                    return
                box.append(res)
                ev.set()

        self._submit(tenant, klass, cost, notify)
        cap = (timeout if timeout is not None
               else self._policy.class_spec(klass).max_wait_s + 10.0)
        if not ev.wait(cap):
            with nlock:
                if not box:
                    abandoned[0] = True
                    raise QosShed(tenant, klass,
                                  "admission wait timed out", 1.0)
        res = box[0]
        if isinstance(res, BaseException):
            raise res
        return res

    def _submit(self, tenant: str, klass: str, cost: float, notify) -> None:
        """Shared admission entry: fast-path grant, immediate shed, or
        enqueue. `notify` fires exactly once with a Grant or QosShed."""
        if klass not in CLASSES:
            klass = CLASS_INGEST
        now = self._clock()
        result = None
        with self._lock:
            if self._stopping or not self._policy.enabled:
                result = _NOOP_GRANT
            else:
                t = self._resolve_locked(tenant, now)
                key = (t.name, klass)
                own_q = self._queues.get(key)
                # fast path only when nothing of same-or-higher priority
                # is queued ANYWHERE: a tenant must not sneak tokens past
                # competitors already waiting in its class (that is the
                # WFQ bypass the DRR exists to prevent), and a lower
                # class must not sneak past queued foreground work —
                # but interactive may fast-path past queued ingest
                fast_ok = not self._queued_at_or_above_locked(klass)
                if fast_ok and t.pair.at_cap() is False:
                    wait, inflight_blocked = self._eta_locked(t, klass,
                                                              cost, now)
                    if wait == 0.0 and not inflight_blocked:
                        self._take_locked(t, klass, cost, now)
                        self._count(t.name, klass, "admitted", cost)
                        result = Grant(self, t.name, klass)
                if result is None:
                    spec = self._policy.class_spec(klass)
                    wait, inflight_blocked = self._eta_locked(t, klass,
                                                              cost, now)
                    depth = len(own_q) if own_q else 0
                    if t.spec.max_queue and depth >= t.spec.max_queue:
                        result = self._shed_locked(
                            t, klass, "queue full", max(wait, 1.0))
                    elif wait > spec.max_wait_s and not inflight_blocked:
                        # can't possibly be served in time: fail fast
                        # with an honest Retry-After instead of parking
                        result = self._shed_locked(
                            t, klass, "rate limited", wait)
                    else:
                        w = _Waiter(t.name, klass, cost, now,
                                    now + spec.max_wait_s, notify)
                        self._queues.setdefault(key, deque()).append(w)
                        if t.name not in self._rr[klass]:
                            self._rr[klass].append(t.name)
                        self._gauge_depth(t.name)
                        self._cond.notify_all()
        if result is not None:
            notify(result)

    def _admit_forced(self, tenant: str, klass: str, cost: float) -> Grant:
        """Charge-and-go: debit every bucket level (tokens may go
        negative, delaying FUTURE admissions) and take the inflight
        slots, but never wait and never refuse."""
        now = self._clock()
        with self._lock:
            if not self._policy.enabled:
                return _NOOP_GRANT
            t = self._resolve_locked(tenant, now)
            t.pair.force(cost, now)
            cls = self._classes.get(klass)
            if cls is not None:
                cls.force(cost, now)
            if self._node is not None:
                self._node.force(cost, now)
            t.pair.inflight += 1
            if cls is not None:
                cls.inflight += 1
            if self._node is not None:
                self._node.inflight += 1
            self._count(t.name, klass, "admitted", cost)
            return Grant(self, t.name, klass)

    # -- bucket walk (all under self._lock) ----------------------------------
    def _resolve_locked(self, name: str, now: float) -> _Tenant:
        name = name or "default"
        t = self._tenants.get(name)
        if t is not None:
            return t
        pol = self._policy
        if name not in pol.tenants and len(self._tenants) >= pol.max_tenants:
            name = OVERFLOW_TENANT
            t = self._tenants.get(name)
            if t is not None:
                return t
        t = self._tenants[name] = _Tenant(name, pol.tenant_spec(name), now)
        return t

    def _eta_locked(self, t: _Tenant, klass: str, cost: float,
                    now: float) -> tuple[float, bool]:
        """(max bucket ETA, blocked-on-inflight?) across the hierarchy."""
        cls = self._classes.get(klass)
        wait = t.pair.eta(cost, now)
        inflight = t.pair.at_cap()
        if cls is not None:
            wait = max(wait, cls.eta(cost, now))
            inflight = inflight or cls.at_cap()
        if self._node is not None:
            wait = max(wait, self._node.eta(cost, now))
            inflight = inflight or self._node.at_cap()
        return wait, inflight

    def _take_locked(self, t: _Tenant, klass: str, cost: float,
                     now: float) -> None:
        """Debit every level + take the inflight slots (caller verified
        availability via _eta_locked under the same lock hold)."""
        cls = self._classes.get(klass)
        t.pair.take(cost, now)
        t.pair.inflight += 1
        if cls is not None:
            cls.take(cost, now)
            cls.inflight += 1
        if self._node is not None:
            self._node.take(cost, now)
            self._node.inflight += 1
        t.admitted += 1
        t.bytes += int(cost)
        self.admitted_total += 1

    def _shed_locked(self, t: _Tenant, klass: str, reason: str,
                     wait: float) -> QosShed:
        t.shed += 1
        self.shed_total += 1
        self._count(t.name, klass, "shed", 0)
        shed = QosShed(t.name, klass, reason, wait)
        self._event_locked("qos.shed", t.name, klass, reason=reason,
                           retry_after_s=round(shed.retry_after_s, 2))
        return shed

    def _foreground_queued_locked(self) -> bool:
        return any(q for (name, klass), q in self._queues.items()
                   if klass in _FOREGROUND)

    def _queued_at_or_above_locked(self, klass: str) -> bool:
        cutoff = CLASSES.index(klass) if klass in CLASSES else len(CLASSES)
        return any(q for (name, k), q in self._queues.items()
                   if k in CLASSES and CLASSES.index(k) <= cutoff)

    # -- release / post-charge ----------------------------------------------
    def _release(self, tenant: str, klass: str) -> None:
        with self._lock:
            t = self._tenants.get(tenant)
            if t is not None and t.pair.inflight > 0:
                t.pair.inflight -= 1
            cls = self._classes.get(klass)
            if cls is not None and cls.inflight > 0:
                cls.inflight -= 1
            if self._node is not None and self._node.inflight > 0:
                self._node.inflight -= 1
            self._cond.notify_all()

    def _charge(self, tenant: str, klass: str, nbytes: int) -> None:
        now = self._clock()
        with self._lock:
            t = self._tenants.get(tenant)
            if t is None:
                return
            if t.pair.byt is not None:
                t.pair.byt.force(nbytes, now)
            cls = self._classes.get(klass)
            if cls is not None and cls.byt is not None:
                cls.byt.force(nbytes, now)
            if self._node is not None and self._node.byt is not None:
                self._node.byt.force(nbytes, now)
            t.bytes += nbytes
        try:
            from ..stats import QOS_BYTES
            QOS_BYTES.inc(tenant, klass, amount=nbytes)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break admission)
            pass

    # -- the pump: WFQ drain + deadline sheds --------------------------------
    def _start_pump(self) -> None:
        with self._lock:
            if self._pump is not None or self._stopping:
                return
            self._pump = threading.Thread(
                target=self._pump_loop, daemon=True,
                name=f"qos-pump-{self.name}")
            self._pump.start()

    def _pump_loop(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
                grants, sheds, next_dl = self._schedule_locked()
                if not grants and not sheds and not self._deficit_stalled:
                    now = self._clock()
                    wait = _IDLE_TICK_S
                    if next_dl is not None:
                        wait = min(wait, max(0.0, next_dl - now) + 0.001)
                    self._cond.wait(timeout=wait)
            # notify OUTSIDE the lock: grant callbacks hop onto event
            # loops and shed callbacks may log
            for w, grant in grants:
                w.notify(grant)
            for w, shed in sheds:
                w.notify(shed)
            if self._file:
                self._reload_file()

    def _schedule_locked(self):
        """One WFQ pass. Returns ([(waiter, Grant)], [(waiter, QosShed)],
        next_deadline|None)."""
        now = self._clock()
        grants: list = []
        sheds: list = []
        next_dl: "float | None" = None
        quantum = float(self._policy.quantum_bytes)
        self._deficit_stalled = False

        # 1) deadline sheds, every class (expired waiters must clear
        #    even in classes the grant pass won't reach)
        for key in list(self._queues):
            q = self._queues[key]
            while q and q[0].deadline <= now:
                w = q.popleft()
                w.done = True
                t = self._tenants.get(w.tenant)
                if t is not None:
                    wait, _ = self._eta_locked(t, w.klass, w.cost, now)
                    sheds.append((w, self._shed_locked(
                        t, w.klass, "queued past max_wait",
                        max(wait, 1.0))))
                else:  # tenant state vanished in a reload
                    sheds.append((w, QosShed(w.tenant, w.klass,
                                             "queued past max_wait", 1.0)))
            if not q:
                del self._queues[key]
                self._gauge_depth(key[0])

        fg_queued = self._foreground_queued_locked()
        for klass in CLASSES:
            rotation = self._rr[klass]
            # prune tenants with nothing queued in this class
            for _ in range(len(rotation)):
                name = rotation[0]
                if self._queues.get((name, klass)):
                    rotation.rotate(-1)
                else:
                    rotation.popleft()
            if not rotation:
                continue
            if klass == CLASS_MAINTENANCE and fg_queued:
                # maintenance yields to queued foreground work — unless
                # its head waiter has aged past the starvation grace
                grace = 0.5 * self._policy.class_spec(klass).max_wait_s
                heads = [self._queues[(n, klass)][0] for n in rotation]
                if not any(now - w.enq >= grace for w in heads):
                    dl = min(w.enq + grace for w in heads)
                    next_dl = dl if next_dl is None else min(next_dl, dl)
                    continue
            # DRR: walk the rotation, each tenant gaining one
            # weight-scaled quantum per visit and draining its head
            # while deficit + buckets allow. A SHARED bucket (class or
            # node level) running dry stalls the whole class — stop and
            # resume at this very tenant with its remaining deficit on
            # the next pass (self._mid), so the refill trickle is split
            # by weight across the rotation instead of feeding whoever
            # sits at the head. Tenant-level stalls just skip that
            # tenant.
            visits = 0
            while rotation and visits <= len(rotation):
                name = rotation[0]
                q = self._queues.get((name, klass))
                if not q:
                    rotation.popleft()
                    if self._mid[klass] == name:
                        self._mid[klass] = None
                    continue
                t = self._tenants.get(name)
                if t is None:
                    t = self._resolve_locked(name, now)
                if self._mid[klass] != name:
                    t.deficit[klass] += quantum * (t.spec.weight / 10.0)
                    self._mid[klass] = name
                stalled_shared = False
                while q:
                    w = q[0]
                    unit = max(float(w.cost), 1.0)
                    if unit > t.deficit[klass]:
                        # another visit credits another quantum: the pump
                        # runs it now instead of an idle tick later
                        self._deficit_stalled = True
                        break
                    wait, inflight_blocked = self._eta_locked(
                        t, klass, w.cost, now)
                    if inflight_blocked or wait > 0:
                        if wait > 0:
                            dl = now + wait
                            next_dl = (dl if next_dl is None
                                       else min(next_dl, dl))
                        # a stall the TENANT's own limits didn't cause
                        # is the shared-capacity stall we must resume at
                        t_wait = t.pair.eta(w.cost, now)
                        stalled_shared = not (t.pair.at_cap()
                                              or t_wait >= wait > 0)
                        break
                    q.popleft()
                    w.done = True
                    t.deficit[klass] -= unit
                    self._take_locked(t, klass, w.cost, now)
                    self._count(name, klass, "queued", w.cost)
                    self._observe_wait(klass, now - w.enq)
                    self._throttle_event_locked(t, klass, now - w.enq)
                    grants.append((w, Grant(self, name, klass)))
                if not q:
                    self._queues.pop((name, klass), None)
                    t.deficit[klass] = 0.0
                self._gauge_depth(name)
                if stalled_shared:
                    break  # resume at this tenant, deficit retained
                # tenant's turn is over (queue drained, deficit spent,
                # or its own limits stalled it): move to the next
                self._mid[klass] = None
                if self._queues.get((name, klass)):
                    rotation.rotate(-1)
                elif rotation and rotation[0] == name:
                    rotation.popleft()
                visits += 1
        return grants, sheds, next_dl

    # -- observability --------------------------------------------------------
    def _count(self, tenant: str, klass: str, outcome: str,
               cost: float) -> None:
        try:
            from ..stats import QOS_BYTES, QOS_REQUESTS
            QOS_REQUESTS.inc(tenant, klass, outcome)
            if cost > 0 and outcome != "shed":
                QOS_BYTES.inc(tenant, klass, amount=cost)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break admission)
            pass

    def _observe_wait(self, klass: str, wait: float) -> None:
        try:
            from ..stats import QOS_WAIT_SECONDS
            QOS_WAIT_SECONDS.observe(klass, value=wait)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break admission)
            pass

    def _gauge_depth(self, tenant: str) -> None:
        try:
            from ..stats import QOS_QUEUE_DEPTH
            depth = sum(len(q) for (n, _k), q in self._queues.items()
                        if n == tenant)
            QOS_QUEUE_DEPTH.set(tenant, value=depth)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break admission)
            pass

    def _event_locked(self, etype: str, tenant: str, klass: str,
                      **attrs) -> None:
        """Rate-limited journal emit (one per tenant per second per
        event type; the counters carry the true rates)."""
        now = self._clock()
        key = (etype, tenant)
        if now - self._last_event.get(key, -_EVENT_INTERVAL_S) \
                < _EVENT_INTERVAL_S:
            return
        self._last_event[key] = now
        try:
            from ..ops import events
            events.emit(etype, severity=events.WARN, tenant=tenant,
                        klass=klass, node=self.name, **attrs)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (journal must never break admission)
            pass

    def _throttle_event_locked(self, t: _Tenant, klass: str,
                               waited: float) -> None:
        spec = self._policy.class_spec(klass)
        if waited >= max(0.25, 0.25 * spec.max_wait_s):
            self._event_locked("qos.throttle", t.name, klass,
                               waited_ms=round(waited * 1e3, 1))

    def debug_payload(self) -> dict:
        """Live scheduler state for /debug/qos: policy summary, node and
        class buckets, per-tenant tokens/inflight/queue/counters."""
        now = self._clock()

        def pair(p: "_BucketPair | None") -> dict:
            if p is None:
                return {}
            out: dict = {"inflight": p.inflight}
            if p.max_inflight:
                out["max_inflight"] = p.max_inflight
            if p.req is not None:
                p.req._refill(now)
                out["req_tokens"] = round(p.req.tokens, 2)
                out["rps"] = p.req.rate
            if p.byt is not None:
                p.byt._refill(now)
                out["byte_tokens"] = round(p.byt.tokens)
                out["bytes_per_s"] = p.byt.rate
            return out

        with self._lock:
            pol = self._policy
            tenants = []
            for name, t in sorted(self._tenants.items()):
                queued = {k: len(self._queues.get((name, k), ()))
                          for k in CLASSES
                          if self._queues.get((name, k))}
                tenants.append({
                    "tenant": name, "weight": t.spec.weight,
                    "admitted": t.admitted, "shed": t.shed,
                    "bytes": t.bytes, "queued": queued,
                    **pair(t.pair)})
            return {
                "enabled": pol.enabled,
                "policy": {"max_tenants": pol.max_tenants,
                           "quantum_bytes": pol.quantum_bytes,
                           "named_tenants": sorted(pol.tenants),
                           "file": self._file or None},
                "node": pair(self._node),
                "classes": {k: {"max_wait_s":
                                pol.class_spec(k).max_wait_s,
                                **pair(self._classes.get(k))}
                            for k in CLASSES},
                "tenants": tenants,
                "totals": {"admitted": self.admitted_total,
                           "shed": self.shed_total},
            }
