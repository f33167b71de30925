"""Flight recorder: a bounded per-node ring of the requests worth
explaining — the slowest and the errored.

Metrics say "p99 regressed"; traces say "this one request did X" but
only if someone was tracing it. The flight recorder closes the gap the
way ops/events.py does for control-plane transitions: every request
envelope offers its outcome, and the recorder keeps the ones that were
slow (>= SWTPU_FLIGHT_SLOW_MS wire-to-wire) or errored (5xx) in a
deque(maxlen=SWTPU_FLIGHT_BUFFER). Each entry carries everything the
postmortem needs without reproduction:

* the stage timeline (recv_parse/queue_wait/auth_admit/store/
  serialize_flush, milliseconds),
* trace_id/span_id — resolve the full span tree at /debug/traces,
* qos class, cache hit/miss, and the *conditions at admit*: event-loop
  lag and executor queue depths (was THIS request slow, or was the node
  drowning?).

Correlation runs both ways, exactly like the event journal: entries
capture the active trace ids, and record() mirrors a `flight.recorded`
event into the active span so a trace read shows "this request was
captured". Served at `/debug/flight?min_ms=&type=&limit=`, slowest
first.

The port's copy of seaweedfs_tpu/profiling/flight.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.env import env_float, env_int

DEFAULT_CAPACITY = 256
DEFAULT_SLOW_MS = 5.0


class FlightRecorder:
    def __init__(self, capacity: "int | None" = None,
                 slow_ms: "float | None" = None):
        self.capacity = (env_int("SWTPU_FLIGHT_BUFFER", DEFAULT_CAPACITY)
                         if capacity is None else int(capacity))
        self.slow_ms = (env_float("SWTPU_FLIGHT_SLOW_MS", DEFAULT_SLOW_MS)
                        if slow_ms is None else float(slow_ms))
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, duration_s: float, status: int = 200,
               path: str = "", stages: "dict | None" = None,
               qos_class: str = "", cache=None,
               loop_lag_s: "float | None" = None,
               queue_depths: "dict | None" = None,
               node: str = "") -> "dict | None":
        """Offer one finished request; returns the entry if admitted.
        Cheap on the fast path: everything below the threshold returns
        after two float compares."""
        duration_ms = duration_s * 1e3
        errored = status >= 500
        if duration_ms < self.slow_ms and not errored:
            return None
        from .. import tracing
        trace_id, span_id = tracing.current_ids()
        entry = {
            "ts": time.time(),  # display timestamp only, never math
            "kind": kind, "path": path, "status": int(status),
            "duration_ms": round(duration_ms, 3),
            "why": "error" if errored else "slow",
            "stages_ms": {k: round(v * 1e3, 3)
                          for k, v in (stages or {}).items()},
            "trace_id": trace_id, "span_id": span_id,
            "qos_class": qos_class, "cache": cache,
            "loop_lag_ms": (round(loop_lag_s * 1e3, 3)
                            if loop_lag_s is not None else None),
            "queue_depths": dict(queue_depths or {}),
            "node": node,
        }
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)
        try:
            from ..stats import FLIGHT_RECORDS
            FLIGHT_RECORDS.inc(entry["why"])
            # the other direction of the correlation: the active span
            # learns it was captured (same pattern as events.emit)
            tracing.add_event("flight.recorded", seq=entry["seq"],
                              kind=kind, duration_ms=entry["duration_ms"])
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (accounting must never fail the request)
            pass
        return entry

    def snapshot(self, min_ms: float = 0.0, kind: str = "",
                 limit: int = 50) -> list[dict]:
        """Matching entries, slowest first."""
        with self._lock:
            entries = list(self._ring)
        if min_ms > 0:
            entries = [e for e in entries if e["duration_ms"] >= min_ms]
        if kind:
            entries = [e for e in entries
                       if e["kind"] == kind or e["kind"].startswith(kind)]
        entries.sort(key=lambda e: (-e["duration_ms"], -e["seq"]))
        return entries[:max(0, int(limit))]

    def recorded(self) -> int:
        with self._lock:
            return self._seq

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# process-wide recorder, mirroring ops/events.JOURNAL: per-node in real
# deployments (one daemon per process), shared in in-process tests
FLIGHT = FlightRecorder()


def record(kind: str, duration_s: float, **kw) -> None:
    """Swallowing wrapper for request envelopes: flight recording must
    never fail or slow the request being recorded."""
    try:
        FLIGHT.record(kind, duration_s, **kw)
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (observability must not break the data path)
        pass


def debug_flight_payload(query: dict) -> tuple[int, dict]:
    """The /debug/flight payload: (http_status, body). Malformed
    filters are a 400, not a stack trace."""
    import math
    try:
        min_ms = float(query.get("min_ms", "0") or 0)
        limit = int(query.get("limit", "50") or 50)
    except (TypeError, ValueError) as e:
        return 400, {"error": f"bad query: {e}"}
    if not math.isfinite(min_ms) or min_ms < 0:
        return 400, {"error": "min_ms must be finite and >= 0"}
    limit = min(max(0, limit), 1000)
    kind = (query.get("type") or "").strip()
    return 200, {
        "capacity": FLIGHT.capacity,
        "slow_ms": FLIGHT.slow_ms,
        "recorded": FLIGHT.recorded(),
        "entries": FLIGHT.snapshot(min_ms=min_ms, kind=kind, limit=limit),
    }
