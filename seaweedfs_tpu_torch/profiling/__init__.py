"""Continuous profiling & flight-recorder plane.

The port's copy of seaweedfs_tpu/profiling/ (no JAX in it): the same
instruments, env knobs (SWTPU_PROFILE_HZ, SWTPU_FLIGHT_SLOW_MS, ...) and
`/debug/profile` / `/debug/flight` contracts, metered into the port's
`stats`, so a JAX-package telemetry collector reads a port server as it
reads its own. The port's volume server carries all three; the master and
the other daemons are not ported yet.

Three cooperating instruments, wired into every daemon (master, volume,
filer, S3):

* `sampler.ContinuousSampler` — always-on 19 Hz folded-stack sampler
  with thread-class attribution (event_loop/read_pool/writer_pool/
  grpc/raft/other) and an on-CPU vs waiting split, served at
  `/debug/profile?mode=continuous|summary`;
* `lag.LoopLagMonitor` / `lag.MonitoredPool` — event-loop lag probing
  and executor queue accounting, feeding the volume server's
  `queue_wait` stage and the flight recorder's at-admit context;
* `flight.FlightRecorder` — a bounded ring of the slowest/errored
  requests with stage timelines and trace correlation, served at
  `/debug/flight`.

`handle_profile_query()` below is the ONE implementation of the
`/debug/profile` HTTP contract all four daemons share (the four
hand-rolled copies diverged until the volume server shipped the
endpoint unguarded): query validation, the seconds clamp, mode
dispatch, and the runtime hz control. Each daemon keeps its own
transport + operator gate and delegates everything else here.
"""

from __future__ import annotations

import json as _json

from .flight import FLIGHT, FlightRecorder, debug_flight_payload
from .flight import record as record_flight
from .lag import LoopLagMonitor, MonitoredPool
from .sampler import (THREAD_CLASSES, ContinuousSampler, acquire_sampler,
                      classify_thread, default_sampler, release_sampler)

__all__ = [
    "THREAD_CLASSES", "ContinuousSampler", "acquire_sampler",
    "classify_thread", "default_sampler", "release_sampler",
    "LoopLagMonitor", "MonitoredPool",
    "FLIGHT", "FlightRecorder", "record_flight", "debug_flight_payload",
    "handle_profile_query",
]

DEFAULT_MAX_SECONDS = 30.0

_TEXT = "text/plain; charset=utf-8"
_JSON = "application/json"


def _err(msg: str) -> tuple[int, str, str]:
    return 400, _JSON, _json.dumps({"error": msg})


def handle_profile_query(query: dict) -> tuple[int, str, str]:
    """Shared /debug/profile implementation -> (status, content_type,
    body). Callers gate it behind their operator auth and run it OFF
    the event loop (the capture mode blocks for `seconds`).

    Modes:
      (none)            N-second capture (utils/profiling.cpu_profile);
                        `seconds` validated — malformed/NaN/<=0 -> 400,
                        clamped at SWTPU_PROFILE_MAX_SECONDS (a typo'd
                        seconds=1e9 must not pin an executor thread for
                        the daemon's lifetime)
      mode=continuous   the always-on sampler's collapsed-flamegraph text
      mode=summary      the sampler's JSON summary (telemetry collector)
      hz=N              retune the sampler's rate (0 pauses); combines
                        with any mode, alone returns a JSON ack
    """
    import math

    from ..utils.env import env_float

    mode = (query.get("mode") or "").strip()
    hz_ack = None
    if "hz" in query:
        try:
            hz = float(query["hz"])
        except (TypeError, ValueError):
            return _err("hz must be a number")
        if not math.isfinite(hz) or hz < 0:
            return _err("hz must be finite and >= 0")
        s = default_sampler() or acquire_sampler()
        s.set_hz(hz)
        if hz > 0 and not s.running:
            s.start()
        hz_ack = s.hz

    if mode == "continuous":
        s = default_sampler()
        if s is None:
            return (200, _TEXT,
                    "# continuous sampler not running "
                    "(SWTPU_PROFILE_HZ=0 or daemon not started)\n")
        return 200, _TEXT, s.collapsed()

    if mode == "summary":
        try:
            top = int(query.get("top", "200") or 200)
        except (TypeError, ValueError):
            return _err("top must be an integer")
        s = default_sampler()
        if s is None:
            payload = {"hz": 0.0, "ticks": 0, "samples": 0,
                       "classes": {}, "stacks": []}
        else:
            payload = s.summary(top=min(max(1, top), 2000))
        return 200, _JSON, _json.dumps(payload)

    if mode not in ("", "capture"):
        return _err(f"unknown mode {mode!r}")

    if hz_ack is not None and "seconds" not in query:
        # a pure rate retune must not also trigger a 5 s capture
        return 200, _JSON, _json.dumps({"ok": True, "hz": hz_ack})

    raw = query.get("seconds", "5")
    try:
        secs = float(raw)
    except (TypeError, ValueError):
        return _err(f"seconds must be a number, got {raw!r}")
    if not math.isfinite(secs) or secs <= 0:
        # NaN slips through min/max comparisons — reject it explicitly
        return _err("seconds must be finite and > 0")
    secs = min(secs, env_float("SWTPU_PROFILE_MAX_SECONDS",
                               DEFAULT_MAX_SECONDS))
    from ..utils import profiling as capture
    return 200, _TEXT, capture.cpu_profile(secs)
