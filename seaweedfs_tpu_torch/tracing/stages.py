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
"""

from __future__ import annotations

import time

from ..utils import profiling


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
            import torch
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.hist.observe(*self.labels, value=time.perf_counter() - self.t0)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False
