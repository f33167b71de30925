"""Stage timers: the layer boundaries of a hot path as histograms that
are always on, and as ranges on a device capture's own clock.

`with stage("ec.gather", EC_DEGRADED_READ_SECONDS, "gather"):` reads
`time.perf_counter()` at entry and exit and observes the seconds into the
histogram under the given labels. Only while a torch.profiler capture of
this process runs (`utils/profiling.start_device_trace`), it also enters
`torch.profiler.record_function(name)`, so the stage lands in the Chrome
trace as a `user_annotation` range beside the card's kernels and copies.
The test of a running capture is one module attribute, read without a
lock; no ring span is recorded (the spans of tracing/trace.py stay as
they are).

`with shard_fetch(role):` times one remote EC shard fetch on its calling
thread the same way, divided: SeaweedFS_ec_shard_fetch_seconds{role}
whole, and SeaweedFS_ec_shard_fetch_phase_seconds{role, phase} as `first`
(the call issued to the first response message in hand, which the peer
client marks by joining its stream with `joined`) and `rest` (that
message to the joined bytes), on one clock,
so first + rest is the whole; SeaweedFS_ec_shard_fetch_cpu_seconds{role},
the calling thread's `time.thread_time()` across the fetch. (A survivor
fetch's wait for an ec_read pool thread before it is
SeaweedFS_pool_queue_wait_seconds{pool="ec_read"}.) In a capture the fetch
is the range `ec.fetch`, holding `ec.fetch.first` then `ec.fetch.rest`.
"""

from __future__ import annotations

import threading
import time

from ..stats import (EC_SHARD_FETCH_CPU_SECONDS, EC_SHARD_FETCH_PHASE_SECONDS,
                     EC_SHARD_FETCH_SECONDS)
from ..utils import profiling

# per thread: the open shard_fetch (`fetch`)
_local = threading.local()


def _open_range(name: str):
    import torch
    r = torch.profiler.record_function(name)
    r.__enter__()
    return r


class stage:
    """Context manager timing one stage into `hist` under `labels`."""

    __slots__ = ("name", "hist", "labels", "t0", "_range")

    def __init__(self, name: str, hist, *labels: str):
        self.name = name
        self.hist = hist
        self.labels = labels
        self._range = None

    def __enter__(self) -> "stage":
        if profiling.capturing:
            self._range = _open_range(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.hist.observe(*self.labels, value=time.perf_counter() - self.t0)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False


class shard_fetch:
    """Context manager timing one remote shard fetch of `role` (survivor or
    direct) on the calling thread, divided at its first response
    message."""

    __slots__ = ("role", "t0", "t1", "c0", "_ranges")

    def __init__(self, role: str):
        self.role = role
        self.t1 = None
        self._ranges = None

    def __enter__(self) -> "shard_fetch":
        _local.fetch = self
        if profiling.capturing:
            self._ranges = [_open_range("ec.fetch"),
                            _open_range("ec.fetch.first")]
        self.c0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def first_message(self) -> None:
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter()
        if self._ranges is not None:
            self._ranges.pop().__exit__(None, None, None)
            self._ranges.append(_open_range("ec.fetch.rest"))

    def __exit__(self, exc_type, exc, tb) -> bool:
        t2 = time.perf_counter()
        cpu = time.thread_time() - self.c0
        _local.fetch = None
        t1 = t2 if self.t1 is None else self.t1
        EC_SHARD_FETCH_SECONDS.observe(self.role, value=t2 - self.t0)
        EC_SHARD_FETCH_PHASE_SECONDS.observe(self.role, "first",
                                             value=t1 - self.t0)
        EC_SHARD_FETCH_PHASE_SECONDS.observe(self.role, "rest", value=t2 - t1)
        EC_SHARD_FETCH_CPU_SECONDS.observe(self.role, value=cpu)
        if self._ranges is not None:
            while self._ranges:
                self._ranges.pop().__exit__(exc_type, exc, tb)
            self._ranges = None
        return False


def joined(chunks) -> bytes:
    """The chunks of a response stream joined, the first one's arrival
    ending `first` of the shard_fetch open on this thread, if any."""
    parts = []
    for chunk in chunks:
        if not parts:
            fetch = getattr(_local, "fetch", None)
            if fetch is not None:
                fetch.first_message()
        parts.append(chunk)
    return b"".join(parts)
