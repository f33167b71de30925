"""Profiling triggers (reference: pprof on -debug.port via net/http/pprof,
command/imports.go:4 + grace.SetupProfiling).

Port of seaweedfs_tpu/utils/profiling.py. Two modes, for a daemon's
status server to wire in:

* `cpu_profile(seconds=N)` — sample every thread's stack for N seconds
  and return hottest lines/stacks (pprof's /debug/pprof/profile analogue).
* `start_device_trace()` — the counterpart of the reference's
  `start_jax_profiler`: one torch.profiler capture (CPU activity, and the
  card's kernels and copies through CUPTI where CUDA is present); returns
  where the Chrome trace is written when `stop_device_trace()` ends it.
"""

from __future__ import annotations

import io
import os
import tempfile
import threading
import time

_lock = threading.Lock()
_trace_lock = threading.Lock()
_trace = None  # (profiler, trace path) of the running capture


def cpu_profile(seconds: float = 5.0, top: int = 60,
                interval: float = 0.005) -> str:
    """Statistical whole-process profile: sample every thread's stack via
    sys._current_frames() for `seconds`, aggregate by frame. cProfile only
    traces the calling thread, which here would just be sleeping — sampling
    sees ALL threads, like pprof's CPU profile."""
    import sys
    from collections import Counter

    seconds = min(max(seconds, 0.1), 120.0)
    if not _lock.acquire(blocking=False):
        return "another profile is already running\n"
    try:
        me = threading.get_ident()
        leaf: Counter = Counter()
        stacks: Counter = Counter()
        samples = 0
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                samples += 1
                code = frame.f_code
                leaf[f"{code.co_filename}:{frame.f_lineno} "
                     f"({code.co_name})"] += 1
                parts = []
                f = frame
                depth = 0
                while f is not None and depth < 12:
                    parts.append(f.f_code.co_name)
                    f = f.f_back
                    depth += 1
                stacks[" <- ".join(parts)] += 1
            time.sleep(interval)
        out = io.StringIO()
        out.write(f"# sampled {samples} thread-frames over {seconds}s "
                  f"(interval {interval * 1e3:.0f} ms); cumulative view\n\n")
        out.write("== hottest lines ==\n")
        for line, n in leaf.most_common(top):
            out.write(f"{n / max(samples, 1):6.1%}  {line}\n")
        out.write("\n== hottest stacks ==\n")
        for stack, n in stacks.most_common(top // 3):
            out.write(f"{n / max(samples, 1):6.1%}  {stack}\n")
        return out.getvalue()
    finally:
        _lock.release()


def start_device_trace(out_dir: "str | None" = None) -> str:
    """Start one torch.profiler capture (CPU activity, and the card's
    kernels and copies where CUDA is present) in the calling thread and
    return the path of the Chrome trace that stop_device_trace writes.
    A second start while one capture runs raises: the profiler is one per
    process."""
    global _trace
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(out_dir or tempfile.gettempdir(),
                        f"device_trace_{os.getpid()}_{time.time_ns()}.json")
    with _trace_lock:
        if _trace is not None:
            raise RuntimeError("a device trace is already being captured")
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _trace = (prof, path)
    return path


def stop_device_trace() -> str:
    """End the running capture, write its Chrome trace and return where."""
    global _trace
    with _trace_lock:
        if _trace is None:
            raise RuntimeError("no device trace is being captured")
        prof, path = _trace
        _trace = None
    prof.stop()
    prof.export_chrome_trace(path)
    return path
