"""Shared fault-tolerance layer: retries, deadlines, circuit breakers (the
port's copy of the JAX package's utils/retry.py, with its own breaker table).

The Facebook warehouse-cluster study (PAPERS: arxiv 1309.0186) shows the
dominant failure mode in a real cluster is the *transiently* unavailable
node — a machine that drops off for seconds to minutes and comes back.
Every cross-node hop (client→master, client→volume, filer→volume,
replication fan-out, EC shard fan-out) therefore goes through this one
module instead of failing on the first error:

    from ..utils import retry
    resp = retry.retry_call(lambda: do_rpc(), op="assign",
                            peer="10.0.0.2:9333")

Semantics:
  * exponential backoff with FULL jitter (delay ~ U(0, min(cap, base*2^n))
    — the AWS architecture-blog scheme that avoids retry synchronization);
  * an overall deadline per logical operation (a retried call never takes
    longer than `policy.deadline` wall seconds) on top of the caller's
    per-attempt transport timeout;
  * a process-wide retry BUDGET (token bucket refilled by successes) so a
    widespread outage degrades into fast failures instead of a
    retry storm that multiplies the overload;
  * a per-peer CIRCUIT BREAKER (closed → open after N consecutive
    failures → half-open probe after a cooldown → closed on probe
    success), so hot paths stop burning connect timeouts on a peer that
    is known-dead, and recovery is detected by a single cheap probe.

Observability: every retry increments `retry_attempts_total{op}`, every
breaker transition updates `breaker_state{peer}` and
`breaker_transitions_total{peer,to}` in the prometheus registry
(stats/metrics.py), so operators can watch recovery behavior live.

Breakers are advisory for multi-target callers: `order_by_breaker()`
sorts candidate peers healthy-first but never hides the last candidate —
a request must always have at least one peer to try, otherwise an
open breaker could make an operation impossible instead of merely slow.

Env knobs (read once, overridable via configure()):
    SWTPU_RETRY_MAX_ATTEMPTS   default 3
    SWTPU_RETRY_BASE_DELAY     default 0.05  (seconds)
    SWTPU_RETRY_MAX_DELAY      default 2.0
    SWTPU_RETRY_DEADLINE       default 15.0  (overall, per logical op)
    SWTPU_BREAKER_THRESHOLD    default 5     (consecutive failures)
    SWTPU_BREAKER_COOLDOWN     default 2.0   (seconds open before probe)
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, replace

from .env import env_float as _env_float
from .env import env_int as _env_int
from .log import logger

log = logger("retry")


@dataclass(frozen=True)
class RetryPolicy:
    """One logical operation's retry envelope. `attempt_timeout` is a
    HINT callers pass to their transport (http/grpc timeout=...) — a
    synchronous call can't be interrupted from outside portably."""
    max_attempts: int = _env_int("SWTPU_RETRY_MAX_ATTEMPTS", 3)
    base_delay: float = _env_float("SWTPU_RETRY_BASE_DELAY", 0.05)
    max_delay: float = _env_float("SWTPU_RETRY_MAX_DELAY", 2.0)
    deadline: float = _env_float("SWTPU_RETRY_DEADLINE", 15.0)
    attempt_timeout: float = 10.0

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay before retry number `attempt` (1-based)."""
        cap = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        return random.uniform(0.0, cap)

    def with_(self, **kw) -> "RetryPolicy":
        return replace(self, **kw)


DEFAULT_POLICY = RetryPolicy()
# Data-plane reads want snappier failover than the default envelope
READ_POLICY = RetryPolicy(max_attempts=3, deadline=20.0)
# Mutations retried around a fresh assign (submit loops) back off gently
WRITE_POLICY = RetryPolicy(max_attempts=4, deadline=30.0)


class RetryBudget:
    """Token bucket limiting the cluster-wide retry amplification: each
    success deposits `refill_per_success` tokens (capped), each retry
    withdraws one. When the bucket is dry, callers fail fast instead of
    multiplying an overload (the gRPC retry-throttling scheme)."""

    def __init__(self, capacity: float = 100.0,
                 refill_per_success: float = 0.2):
        self.capacity = capacity
        self.refill = refill_per_success
        self._tokens = capacity
        self._lock = threading.Lock()

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + self.refill)

    def withdraw(self) -> bool:
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def reset(self) -> None:
        with self._lock:
            self._tokens = self.capacity


BUDGET = RetryBudget()

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
_STATE_VALUE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class BreakerOpenError(ConnectionError):
    """Fast failure: the peer's circuit is open (known-dead, cooling)."""

    def __init__(self, peer: str, remaining: float):
        super().__init__(f"circuit open for {peer} "
                         f"({remaining:.1f}s until probe)")
        self.peer = peer


class CircuitBreaker:
    """Per-peer circuit: closed → open after `threshold` CONSECUTIVE
    failures; after `cooldown` seconds one half-open probe is allowed
    through; probe success re-closes, probe failure re-opens (reference
    idiom: weed S3 gateway's per-action breaker + the classic
    Nygard state machine)."""

    def __init__(self, peer: str,
                 threshold: int | None = None,
                 cooldown: float | None = None):
        self.peer = peer
        self.threshold = (threshold if threshold is not None
                          else _env_int("SWTPU_BREAKER_THRESHOLD", 5))
        self.cooldown = (cooldown if cooldown is not None
                         else _env_float("SWTPU_BREAKER_COOLDOWN", 2.0))
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        # lock held by caller
        if self._state == to:
            return
        came_from = self._state
        self._state = to
        try:
            from ..stats import BREAKER_STATE, BREAKER_TRANSITIONS
            BREAKER_STATE.set(self.peer, value=_STATE_VALUE[to])
            BREAKER_TRANSITIONS.inc(self.peer, to)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break IO)
            pass
        try:
            # journal the transition so /debug/events answers "which
            # peer tripped, when, and on whose request" (the event
            # carries the active trace id) next to the
            # breaker_transitions_total counter it mirrors
            from ..ops import events
            events.emit(f"breaker.{to}",
                        severity=(events.WARN if to == OPEN
                                  else events.INFO),
                        peer=self.peer, previous=came_from,
                        failures=self._failures)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (the journal must never break IO)
            pass
        log.info("breaker %s -> %s", self.peer, to)

    def would_allow(self) -> bool:
        """allow() without the side effects (no transition, no probe slot
        consumed) — for ORDERING candidates, not gating a request."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                return time.monotonic() - self._opened_at >= self.cooldown
            return not self._probe_inflight

    def allow(self) -> bool:
        """May a request go to this peer right now? Open circuits admit
        exactly ONE probe per cooldown window (half-open)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = time.monotonic()
            if self._state == OPEN:
                if now - self._opened_at < self.cooldown:
                    return False
                self._transition(HALF_OPEN)
                self._probe_inflight = True
                return True
            # HALF_OPEN: only the single in-flight probe
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def remaining_cooldown(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.cooldown
                       - (time.monotonic() - self._opened_at))

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: back to a full cooldown
                self._probe_inflight = False
                self._opened_at = time.monotonic()
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and self._failures >= self.threshold:
                self._opened_at = time.monotonic()
                self._transition(OPEN)

    def trip(self) -> None:
        """Force-open (chaos harness / tests / operator drills)."""
        with self._lock:
            self._failures = self.threshold
            self._opened_at = time.monotonic()
            self._probe_inflight = False
            self._transition(OPEN)

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            self._transition(CLOSED)


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker(peer: str) -> CircuitBreaker:
    """The process-wide breaker for a peer address (shared by every hop
    that talks to it — an HTTP read learning a node is dead saves the
    next gRPC call the connect timeout too)."""
    with _breakers_lock:
        br = _breakers.get(peer)
        if br is None:
            br = _breakers[peer] = CircuitBreaker(peer)
        return br


def all_breakers() -> dict[str, str]:
    """peer -> state snapshot (debug endpoints, chaos invariants)."""
    with _breakers_lock:
        return {p: b.state for p, b in _breakers.items()}


def reset_breakers() -> None:
    """Forget every peer (test isolation between fixtures)."""
    with _breakers_lock:
        _breakers.clear()
    BUDGET.reset()


def order_by_breaker(peers: list, key=None) -> list:
    """Candidates sorted healthy-first: closed/probe-ready breakers keep
    their relative order ahead of cooling-open ones. Never drops a peer —
    an all-open list is returned unchanged so the caller still has a
    last-resort attempt (availability beats purity on the read path).
    `key(p)` maps a candidate to its breaker peer string (default str)."""
    key = key or (lambda p: p if isinstance(p, str) else str(p))
    healthy, cooling = [], []
    for p in peers:
        (healthy if breaker(key(p)).would_allow() else cooling).append(p)
    return healthy + cooling


def retry_call(fn, *, op: str, peer: str | None = None,
               policy: RetryPolicy = DEFAULT_POLICY,
               retryable=None, budget: RetryBudget | None = None):
    """Run `fn` with the full envelope: breaker gate, bounded attempts,
    full-jitter backoff, overall deadline, retry budget.

    `retryable(exc) -> bool` classifies failures; default: everything
    retries. Non-retryable errors propagate immediately (they still count
    against the peer's breaker — a peer answering garbage is as useless
    as a dead one is NOT true for application errors, so callers should
    classify; transport-level callers usually leave the default)."""
    from .. import tracing
    budget = budget if budget is not None else BUDGET
    br = breaker(peer) if peer else None
    deadline = time.monotonic() + policy.deadline
    last_err: Exception | None = None
    for attempt in range(1, policy.max_attempts + 1):
        if br is not None and not br.allow():
            # annotate the active span: a fast-failed request
            # self-explains as "the peer's circuit was open"
            tracing.add_event("breaker_open", op=op, peer=peer,
                              state=br.state)
            raise BreakerOpenError(peer, br.remaining_cooldown())
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 — classified below
            last_err = e
            if retryable is not None and not retryable(e):
                if br is not None:
                    br.record_failure()
                raise
            if br is not None:
                br.record_failure()
            if attempt >= policy.max_attempts:
                break
            delay = policy.backoff(attempt)
            if time.monotonic() + delay > deadline:
                break  # the envelope is spent: fail now, not later
            if not budget.withdraw():
                log.warning("retry budget exhausted for %s; failing fast",
                            op)
                break
            try:
                from ..stats import RETRY_ATTEMPTS
                RETRY_ATTEMPTS.inc(op)
            except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break IO)
                pass
            tracing.add_event(
                "retry", op=op, attempt=attempt,
                delay_ms=round(delay * 1e3, 2),
                error=str(e)[:200],
                **({"peer": peer, "breaker": br.state} if br is not None
                   else {}))
            time.sleep(delay)
            continue
        if br is not None:
            br.record_success()
        budget.deposit()
        return result
    raise last_err if last_err is not None else RuntimeError(
        f"{op}: no attempts made")
