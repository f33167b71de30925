"""Cluster event journal: a bounded ring of structured state transitions
(the port's copy of the JAX package's ops/events.py).

Metrics make recovery *countable* and spans make requests *traceable*,
but neither answers the operator's follow-up to a
bad health verdict: "what CHANGED, and when?". This module is the
system's flight recorder: every interesting control-plane transition —
node join/leave, volume grow/readonly, EC encode/rebuild start/finish,
circuit breaker open/close, health severity changes — lands here as one
structured event, correlated with the active trace so an event found at
/debug/events pivots straight into /debug/traces?trace_id=...

Design mirrors tracing/trace.py's TraceBuffer deliberately:

* per-process ring buffer (SWTPU_EVENT_BUFFER events, default 4096)
  bounds memory no matter the event rate, counting what it evicts;
* events are plain dicts so /debug/events is a json.dumps away;
* every event carries a process-monotonic `seq`, so pollers tail the
  journal with /debug/events?since=<last_seq> without missing or
  re-reading anything the ring still holds;
* `emit()` must never break the caller: journal failures are swallowed
  the same way metrics failures are in the hot paths.

The Facebook warehouse study (PAPERS arXiv:1309.0186) found that repair
load and at-risk stripe population move on *minute* timescales after a
node event — which is exactly the correlation this journal exists to
expose: a `node.leave` followed by `health.severity` transitions and,
later, `ec.rebuild.finish` + recovery back to OK.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.env import env_int as _env_int
from ..utils.log import logger

log = logger("events")

# severity levels an event may carry (informational; the health plane's
# item severities are attrs on health.* events, not event severities)
INFO, WARN, ERROR = "info", "warn", "error"


class EventJournal:
    """Bounded per-process store of structured cluster events."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity or _env_int("SWTPU_EVENT_BUFFER", 4096)
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0

    def emit(self, etype: str, severity: str = INFO, **attrs) -> dict:
        """Record one event. Attrs are flattened into the event dict's
        `attrs`; the active trace (if any) is captured for correlation,
        and the event is mirrored onto the active span so a trace found
        first self-explains too (event<->trace linking both ways)."""
        trace_id = span_id = ""
        try:
            from .. import tracing
            trace_id, span_id = tracing.current_ids()
            tracing.add_event(etype, **attrs)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (correlation must never break emit)
            pass
        with self._lock:
            self._seq += 1
            ev = {"seq": self._seq, "ts_ns": time.time_ns(),
                  "type": etype, "severity": severity,
                  "trace_id": trace_id, "span_id": span_id,
                  "attrs": attrs}
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
        return ev

    def snapshot(self, since: int = 0, etype: str = "",
                 limit: int = 500) -> list[dict]:
        """Matching events in seq order (ascending). `since` excludes
        events with seq <= since (tail-polling cursor); `etype` is a
        prefix match so `breaker` catches breaker.open/close alike.
        When more than `limit` match, the NEWEST `limit` are returned —
        a fresh reader wants the recent past, a tailing reader's
        `since` keeps it below the limit anyway."""
        with self._lock:
            events = list(self._events)
        out = [ev for ev in events
               if ev["seq"] > since
               and (not etype or ev["type"].startswith(etype))]
        return out[-limit:] if limit else out

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def clear(self) -> None:
        """Test isolation only — operators get a ring, not an eraser."""
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


JOURNAL = EventJournal()


def emit(etype: str, severity: str = INFO, **attrs) -> None:
    """Module-level convenience: record onto the process journal,
    swallowing ANY failure — an event must never break the operation
    that emitted it (same contract as metrics)."""
    try:
        JOURNAL.emit(etype, severity=severity, **attrs)
    except Exception as e:  # noqa: BLE001
        try:
            log.warning("event emit %s failed: %s", etype, e)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (last resort: logging itself failed)
            pass


def debug_events_payload(query: dict) -> dict:
    """The shared /debug/events response body: JSON events filterable by
    ?since=<seq>&type=<prefix>&limit=N (served by the master, volume,
    filer, and S3 status servers; each process journals its own plane)."""
    try:
        since = max(0, int(query.get("since") or 0))
    except ValueError:
        since = 0
    etype = (query.get("type") or "").strip()
    try:
        limit = max(0, min(int(query.get("limit") or 500), 5000))
    except ValueError:
        limit = 500
    events = JOURNAL.snapshot(since=since, etype=etype, limit=limit)
    return {"count": len(events), "buffered": len(JOURNAL),
            "dropped": JOURNAL.dropped, "last_seq": JOURNAL.last_seq,
            "events": events}
