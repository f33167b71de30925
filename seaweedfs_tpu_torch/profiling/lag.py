"""Event-loop lag probes and queue-accounted executor pools.

Two instruments that turn "the loop felt slow" into numbers:

* `LoopLagMonitor` — a periodic `loop.call_later` probe: schedule a
  callback `interval` out, measure how late it actually fires. That
  lateness IS event-loop queueing — every handler admitted while the
  loop is `lag` behind waited roughly that long between parse and
  handler entry. Feeds `SeaweedFS_event_loop_lag_seconds{loop}` and
  exposes `last_lag_s` so the volume server can stamp loop-lag-at-admit
  into stage accounting and flight-recorder entries.

* `MonitoredPool` — a ThreadPoolExecutor whose submit() accounts queue
  depth (submitted-not-yet-started, `SeaweedFS_pool_queue_depth{pool}`)
  and queue wait (submit -> worker pickup,
  `SeaweedFS_pool_queue_wait_seconds{pool}`). The volume server's read
  pools ride on it; depth-at-admit lands in flight entries.

Label values are fixed small sets ("volume"/"master"/"filer"/"s3",
"read"/"ec_read"/"grpc") — NEVER per-port — so several servers in one test
process share series via delta accounting, and stats/expo_lint.py can
hold a tier-style cardinality ceiling over both labels.

The port's copy of seaweedfs_tpu/profiling/lag.py.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils.env import env_float

DEFAULT_PROBE_INTERVAL_S = 0.25


class LoopLagMonitor:
    def __init__(self, loop_name: str, interval_s: "float | None" = None):
        self.name = loop_name
        self.interval_s = (env_float("SWTPU_LOOP_PROBE_S",
                                     DEFAULT_PROBE_INTERVAL_S)
                           if interval_s is None else float(interval_s))
        self._loop = None
        self._handle = None
        self._expected = 0.0
        self._last_lag_s = 0.0
        self._probes = 0
        self._closed = False

    def attach(self, loop) -> None:
        """Install the probe on `loop` (call from the loop's thread —
        the serve loops' on_loop hook does)."""
        self._loop = loop
        self._closed = False
        self._expected = loop.time() + self.interval_s
        self._handle = loop.call_later(self.interval_s, self._tick)

    def _tick(self) -> None:
        loop = self._loop
        if loop is None or self._closed:
            return
        # lateness beyond the asked-for delay = time the loop spent on
        # other callbacks before reaching this one = queueing
        lag = max(0.0, loop.time() - self._expected)
        self._last_lag_s = lag
        self._probes += 1
        try:
            from ..stats import EVENT_LOOP_LAG
            EVENT_LOOP_LAG.observe(self.name, value=lag)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never stall the loop)
            pass
        if not loop.is_closed():
            self._expected = loop.time() + self.interval_s
            self._handle = loop.call_later(self.interval_s, self._tick)

    @property
    def last_lag_s(self) -> float:
        """Most recent probe's lag — 'how far behind was the loop just
        now': stamped into stage accounting / flight entries at admit."""
        return self._last_lag_s

    @property
    def probes(self) -> int:
        return self._probes

    def close(self) -> None:
        self._closed = True
        h, self._handle = self._handle, None
        if h is not None:
            try:
                h.cancel()
            except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (loop may already be torn down)
                pass


class MonitoredPool(ThreadPoolExecutor):
    """ThreadPoolExecutor with queue-depth and queue-wait accounting.

    `pool_label` is the {pool} metric label (closed set); depth uses
    gauge deltas so same-labelled pools in one process compose."""

    def __init__(self, pool_label: str, max_workers: "int | None" = None,
                 thread_name_prefix: str = ""):
        super().__init__(max_workers=max_workers,
                         thread_name_prefix=thread_name_prefix)
        self.pool_label = pool_label
        self._queued = 0
        self._qlock = threading.Lock()

    def queued(self) -> int:
        """Tasks submitted but not yet picked up by a worker."""
        return self._queued

    def submit(self, fn, /, *args, **kwargs):
        t_q = time.perf_counter()
        with self._qlock:
            self._queued += 1
        try:
            from ..stats import POOL_QUEUE_DEPTH
            POOL_QUEUE_DEPTH.add(self.pool_label, amount=1)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never fail a submit)
            pass

        def run():
            with self._qlock:
                self._queued -= 1
            try:
                from ..stats import POOL_QUEUE_DEPTH, POOL_QUEUE_WAIT
                POOL_QUEUE_DEPTH.add(self.pool_label, amount=-1)
                POOL_QUEUE_WAIT.observe(self.pool_label,
                                        value=time.perf_counter() - t_q)
            except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (accounting must never fail the task)
                pass
            return fn(*args, **kwargs)

        try:
            return super().submit(run)
        except BaseException:
            # submit refused (shutdown): roll the depth accounting back
            with self._qlock:
                self._queued -= 1
            try:
                from ..stats import POOL_QUEUE_DEPTH
                POOL_QUEUE_DEPTH.add(self.pool_label, amount=-1)
            except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except
                pass
            raise
