"""End-to-end distributed tracing for the multi-hop data plane.

The port's copy of seaweedfs_tpu/tracing/trace.py. The architecture is
client → master assign → volume PUT (with replication fan-out), filer →
blob IO, and EC shard fan-out; counters make recovery behavior countable
(retry_attempts_total, breaker_state) but do not tie one slow or degraded
request to the hops, retries, and shard fetches that composed it. This
module does: W3C-`traceparent`-style
trace context carried in a contextvar, injected/extracted as an HTTP
header (client/http_util.py, the aiohttp/fastweb servers) and as gRPC
metadata (utils/rpc.py), with finished spans recorded into a bounded
per-process ring buffer served at /debug/traces on every status server.

Design notes:

* The context IS the span: `start_span()` parents on the contextvar's
  current span (or an extracted remote `SpanContext`), sets itself
  current for the `with` body, and records itself on exit. asyncio tasks
  and `asyncio.to_thread` copy contextvars automatically; plain
  thread-pool fan-outs (the EC degraded-read pool) wrap their submits in
  `contextvars.copy_context().run`.
* Sampling is decided once at the root (`SWTPU_TRACE_SAMPLE`, default
  1.0) and inherited by every child, local or remote. Rate 0 (tracing
  disabled) injects NOTHING — no header, no metadata — leaving the
  wire byte-identical to a build without tracing; under fractional
  rates an unsampled trace propagates the 00 flag so downstream nodes
  inherit the decision instead of re-rolling it.
* Spans are recorded as plain dicts so /debug/traces is a json.dumps
  away; the ring buffer (SWTPU_TRACE_BUFFER spans, default 4096) bounds
  memory no matter the request rate, counting what it evicts.
* A root span slower than SWTPU_TRACE_SLOW_MS logs ONE structured line
  with its trace id — the grep-able handle into /debug/traces.

Reference precedent: the Facebook warehouse study (arXiv:1309.0186)
found EC repair traffic dominating cluster networks only via
per-operation measurement; the span-per-shard-fetch here makes a
degraded read show its n−k missing children directly.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..utils.env import env_float as _env_float
from ..utils.env import env_int as _env_int
from ..utils.log import logger

log = logger("trace")

TRACEPARENT_HEADER = "traceparent"

_ZERO_TRACE = "0" * 32
_ZERO_SPAN = "0" * 16

# caps keeping one hostile/buggy span from bloating the buffer
_MAX_ATTRS = 32
_MAX_EVENTS = 64


@dataclass(frozen=True)
class SpanContext:
    """The propagated identity: what crosses process boundaries."""
    trace_id: str          # 32 lowercase hex chars
    span_id: str           # 16 lowercase hex chars
    sampled: bool = True

    def to_traceparent(self) -> str:
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")


def parse_traceparent(value: str) -> "SpanContext | None":
    """W3C trace-context: version-trace_id-parent_id-flags. Unknown
    versions parse leniently (spec: treat as 00 if the four fields
    look right); malformed input returns None rather than raising."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    trace_id, span_id = parts[1].lower(), parts[2].lower()
    if trace_id == _ZERO_TRACE or span_id == _ZERO_SPAN:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
        flags = int(parts[3][:2], 16)
    except ValueError:
        return None
    return SpanContext(trace_id, span_id, bool(flags & 0x01))


# -- configuration -----------------------------------------------------------

_sample_rate = _env_float("SWTPU_TRACE_SAMPLE", 1.0)
_slow_ms = _env_float("SWTPU_TRACE_SLOW_MS", 0.0)


def configure(sample: float | None = None,
              slow_ms: float | None = None) -> None:
    """Runtime override of the env knobs (tests, operator drills)."""
    global _sample_rate, _slow_ms
    if sample is not None:
        _sample_rate = float(sample)
    if slow_ms is not None:
        _slow_ms = float(slow_ms)


def sample_rate() -> float:
    return _sample_rate


# -- span --------------------------------------------------------------------

_current: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "swtpu_current_span", default=None)


class Span:
    """One timed operation. Use via `start_span(...)` as a context
    manager; `end()` is idempotent for manual lifecycles."""

    __slots__ = ("name", "component", "context", "parent_id", "start_ns",
                 "end_ns", "attrs", "events", "status", "_token")

    def __init__(self, name: str, component: str, context: SpanContext,
                 parent_id: str, attrs: "dict | None"):
        self.name = name
        self.component = component
        self.context = context
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attrs = dict(attrs) if attrs else {}
        self.events: list[dict] = []
        self.status = "ok"
        self._token = None

    # -- recording -----------------------------------------------------------
    def set_attr(self, key: str, value) -> None:
        if len(self.attrs) < _MAX_ATTRS or key in self.attrs:
            self.attrs[key] = value

    def add_event(self, name: str, **attrs) -> None:
        if len(self.events) < _MAX_EVENTS:
            self.events.append({"name": name, "ts_ns": time.time_ns(),
                                **attrs})

    def set_error(self, exc_or_msg) -> None:
        self.status = "error"
        self.set_attr("error", str(exc_or_msg)[:400])

    @property
    def duration_ms(self) -> float:
        end = self.end_ns or time.time_ns()
        return (end - self.start_ns) / 1e6

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                # an abandoned generator may be finalized by the GC on a
                # different thread/context than the one that entered it
                pass
            self._token = None
        if exc is not None and self.status == "ok":
            self.set_error(exc)
        self.end()
        return False

    def end(self) -> None:
        if self.end_ns:
            return
        self.end_ns = time.time_ns()
        if self.context.sampled:
            BUFFER.add(self)
        if (_slow_ms > 0 and not self.parent_id and self.context.sampled
                and self.duration_ms >= _slow_ms):
            # sampled-only: an unsampled root never reaches the buffer,
            # so logging its trace id would be a dangling pointer
            # one structured line per over-threshold ROOT span: the
            # grep-able pointer into /debug/traces?trace_id=...
            import json as _json
            log.warning("slow-span %s", _json.dumps({
                "trace_id": self.context.trace_id,
                "span_id": self.context.span_id,
                "name": self.name, "component": self.component,
                "duration_ms": round(self.duration_ms, 3),
                "status": self.status, "events": len(self.events),
                "attrs": {k: str(v) for k, v in self.attrs.items()},
            }, default=str))

    def to_dict(self) -> dict:
        return {
            "trace_id": self.context.trace_id,
            "span_id": self.context.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "component": self.component,
            "start_ns": self.start_ns,
            "duration_ms": round(self.duration_ms, 3),
            "status": self.status,
            "attrs": self.attrs,
            "events": self.events,
        }


def _new_id(nbytes: int) -> str:
    # random.getrandbits is plenty for correlation ids and ~20x cheaper
    # than os.urandom on this hot path
    return f"{random.getrandbits(nbytes * 8):0{nbytes * 2}x}"


class _NoopSpan(Span):
    """Shared do-nothing span returned when tracing is fully disabled
    (rate 0): no allocation, no contextvar churn, nothing recorded —
    disabled means disabled, even on the ~100us assign fast path."""

    def __init__(self):
        super().__init__("noop", "",
                         SpanContext(_ZERO_TRACE, _ZERO_SPAN, False),
                         "", None)

    def set_attr(self, key, value):
        pass

    def add_event(self, name, **attrs):
        pass

    def set_error(self, exc_or_msg):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def end(self):
        pass


_NOOP = _NoopSpan()


def start_span(name: str, *, component: str = "",
               child_of: "SpanContext | None" = None,
               attrs: "dict | None" = None) -> Span:
    """Create a span parented on `child_of` (an extracted remote context)
    or, failing that, the current in-process span; otherwise start a new
    trace, rolling the sampling dice once for its whole tree. Rate 0
    short-circuits to a shared no-op span — zero per-request cost."""
    if _sample_rate <= 0:
        return _NOOP
    parent_ctx: SpanContext | None = child_of
    if parent_ctx is None:
        cur = _current.get()
        if cur is not None:
            parent_ctx = cur.context
    if parent_ctx is not None:
        ctx = SpanContext(parent_ctx.trace_id, _new_id(8),
                          parent_ctx.sampled)
        parent_id = parent_ctx.span_id
    else:
        sampled = _sample_rate > 0 and (_sample_rate >= 1.0
                                        or random.random() < _sample_rate)
        ctx = SpanContext(_new_id(16), _new_id(8), sampled)
        parent_id = ""
    return Span(name, component, ctx, parent_id, attrs)


# -- context helpers ---------------------------------------------------------

def current_span() -> "Span | None":
    return _current.get()


def current_trace_id() -> str:
    """Trace id of the active SAMPLED span ('' otherwise) — the exemplar
    hook for stats/metrics.py histograms."""
    sp = _current.get()
    if sp is not None and sp.context.sampled:
        return sp.context.trace_id
    return ""


def current_ids() -> tuple[str, str]:
    """(trace_id, span_id) of the active span for log correlation —
    unlike exemplars, logs keep ids even for unsampled spans."""
    sp = _current.get()
    if sp is None:
        return "", ""
    return sp.context.trace_id, sp.context.span_id


def add_event(name: str, **attrs) -> None:
    """Annotate the active span (no-op without one) — the retry envelope
    uses this so a slow request self-explains."""
    sp = _current.get()
    if sp is not None:
        sp.add_event(name, **attrs)


def injectable() -> str:
    """traceparent value to put on the wire, or '' when nothing should
    be added. Rate 0 (tracing disabled) injects NOTHING, leaving
    requests byte-identical to an untraced build. Under fractional
    sampling an unsampled trace still propagates its context with the
    00 flag — otherwise every downstream node would re-roll the dice
    and record fragmented mid-path root traces, blowing the effective
    rate past what was configured."""
    sp = _current.get()
    if sp is None:
        return ""
    if sp.context.sampled:
        return sp.context.to_traceparent()
    if _sample_rate > 0:
        return sp.context.to_traceparent()  # flags=00: inherited no
    return ""


def inject(headers: "dict | None") -> "dict | None":
    """Return `headers` with traceparent added (copying if needed)."""
    tp = injectable()
    if not tp:
        return headers
    headers = dict(headers) if headers else {}
    headers[TRACEPARENT_HEADER] = tp
    return headers


def extract(headers) -> "SpanContext | None":
    """Parse the inbound traceparent from any dict-like with .get
    (fastweb Headers, aiohttp CIMultiDict, plain dict)."""
    if headers is None:
        return None
    return parse_traceparent(headers.get(TRACEPARENT_HEADER) or "")


# -- ring buffer + /debug/traces --------------------------------------------

class TraceBuffer:
    """Bounded per-process store of finished sampled spans."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity or _env_int("SWTPU_TRACE_BUFFER", 4096)
        self._spans: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(d)
        try:
            from ..stats import TRACE_SPANS
            TRACE_SPANS.inc(span.component or "unknown")
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break IO)
            pass

    def snapshot(self, trace_id: str = "", min_ms: float = 0.0,
                 limit: int = 500) -> list[dict]:
        """Newest-first matching spans."""
        with self._lock:
            spans = list(self._spans)
        out = []
        for d in reversed(spans):
            if len(out) >= limit:
                break
            if trace_id and d["trace_id"] != trace_id:
                continue
            if min_ms and d["duration_ms"] < min_ms:
                continue
            out.append(d)
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


BUFFER = TraceBuffer()


def debug_traces_payload(query: dict) -> dict:
    """The shared /debug/traces response body: JSON spans, filterable by
    ?trace_id=...&min_ms=...&limit=... (served by the master, volume,
    filer, and S3 status servers)."""
    trace_id = (query.get("trace_id") or "").lower()
    try:
        min_ms = float(query.get("min_ms") or 0.0)
    except ValueError:
        min_ms = 0.0
    try:
        limit = max(0, min(int(query.get("limit") or 500), 5000))
    except ValueError:
        limit = 500
    spans = BUFFER.snapshot(trace_id=trace_id, min_ms=min_ms, limit=limit)
    return {"count": len(spans), "buffered": len(BUFFER),
            "dropped": BUFFER.dropped, "sample_rate": _sample_rate,
            "spans": spans}
