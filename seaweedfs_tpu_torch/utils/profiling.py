"""Profiling triggers (reference: pprof on -debug.port via net/http/pprof,
command/imports.go:4 + grace.SetupProfiling).

Port of seaweedfs_tpu/utils/profiling.py. Two modes, for a daemon's
status server to wire in:

* `cpu_profile(seconds=N)` — sample every thread's stack for N seconds
  and return hottest lines/stacks (pprof's /debug/pprof/profile analogue).
* `start_device_trace()` — the counterpart of the reference's
  `start_jax_profiler`: one torch.profiler capture (CPU activity, and the
  card's kernels and copies through CUPTI where CUDA is present, or
  required with `cuda=True`); returns where the Chrome trace is written
  when `stop_device_trace()` ends it. The volume server's
  `/debug/jax-profiler` route drives the pair.
"""

from __future__ import annotations

import functools
import io
import os
import tempfile
import threading
import time

_lock = threading.Lock()
_trace_lock = threading.Lock()
_trace = None  # (profiler, trace path, holds the card's activity) if running
# True while a capture runs: tracing.stage reads it, without a lock, to
# decide whether a stage also opens a range in the capture
capturing = False


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


# Kernels a capture of the card launches first, before it is handed to the
# caller. In a process that has run much work on the card, about half the
# captures hold every launch's API record but lose the card's records of
# their first launches (the first 40 of 64 one-stripe K1 kernels in
# scripts/trace_probe.py --smoke-phases, the first 19-20 of 64 degraded
# GETs in chip_smoke.py phase 16), whichever thread starts, stops or
# launches, and with or without a second's wait after the start. These
# kernels take that loss in place of the caller's.
TRACE_WARMUP_KERNELS = 256


def _capture_cpu(fn):
    """`fn`'s CPU on the calling thread counted as class `capture` of
    SeaweedFS_process_thread_cpu_seconds_total (profiling/threadcpu), not
    as its thread's: a capture's start and stop are not the work of the
    thread that serves the request."""
    @functools.wraps(fn)
    def counted(*args, **kwargs):
        from ..profiling.threadcpu import CAPTURE, THREAD_CPU
        with THREAD_CPU.counted_as(CAPTURE):
            return fn(*args, **kwargs)
    return counted


@_capture_cpu
def start_device_trace(out_dir: "str | None" = None,
                       cuda: bool = False) -> str:
    """Start one torch.profiler capture (CPU activity, and the card's
    kernels and copies where CUDA is present) in the calling thread and
    return the path of the Chrome trace that stop_device_trace writes.
    A capture of the card first runs TRACE_WARMUP_KERNELS tiny kernels of
    its own (they show in the trace). With `cuda`, a capture that cannot
    hold the card's activity (no card, or a profiler without CUDA
    activity) raises instead of starting one that would lack the kernels.
    A second start while one capture runs raises: the profiler is one per
    process. It records every thread's host ops and ranges, not only the
    starting thread's: a server's stages run on its pool threads."""
    global _trace, capturing
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda_activity = torch.profiler.ProfilerActivity.CUDA
    if torch.cuda.is_available() and \
            cuda_activity in torch.profiler.supported_activities():
        activities.append(cuda_activity)
    elif cuda:
        raise RuntimeError("a device trace of the card was asked for, but "
                           "the profiler cannot capture CUDA activity here")
    path = os.path.join(out_dir or tempfile.gettempdir(),
                        f"device_trace_{os.getpid()}_{time.time_ns()}.json")
    with _trace_lock:
        if _trace is not None:
            raise RuntimeError("a device trace is already being captured")
        prof = torch.profiler.profile(
            activities=activities,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True))
        prof.start()
        _trace = (prof, path, cuda_activity in activities)
        capturing = True
    if cuda_activity in activities:
        x = torch.zeros(1, device="cuda")
        for _ in range(TRACE_WARMUP_KERNELS):
            x.add_(1)
        torch.cuda.synchronize()
    return path


def device_trace_path() -> "str | None":
    """Where the running capture will write its trace; None when idle."""
    with _trace_lock:
        return _trace[1] if _trace is not None else None


@_capture_cpu
def stop_device_trace() -> str:
    """End the running capture, write its Chrome trace and return where.
    A capture of the card first waits for every kernel and copy queued on
    it, from any thread: a launch still running at the stop would be
    missing from the trace."""
    global _trace, capturing
    with _trace_lock:
        if _trace is None:
            raise RuntimeError("no device trace is being captured")
        prof, path, on_card = _trace
        _trace = None
        capturing = False
    if on_card:
        import torch
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)
    return path
