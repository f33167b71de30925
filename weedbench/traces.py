"""Reading the Chrome traces that each server's torch.profiler capture
writes (the servers' /debug/jax-profiler route): the device's busy time,
kernel time by name, and the longest idle gaps with what the host was
doing in them."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")


@dataclass
class Trace:
    label: str
    busy_s: float = 0.0
    kernel_s: "dict[str, float]" = field(default_factory=dict)
    device_s: "dict[str, float]" = field(default_factory=dict)
    gaps: "list[tuple[str, float]]" = field(default_factory=list)
    device_events: int = 0


def _union(intervals) -> "list[tuple[float, float]]":
    out: "list[list[float]]" = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(path: str, label: str, warmup_kernels: int,
         window: "tuple[float, float, float] | None" = None,
         top_gaps: int = 10) -> Trace:
    """Summarise one capture over the window. The capture opens with
    `warmup_kernels` launches of one small kernel of its own, synchronised
    before the start request returns; that leading run is left out, and
    its end anchors the trace's clock: `window` is (the monotonic time the
    start request returned, the window's start, its end), and only device
    work inside the window counts, clipped to it."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["dur"]), e.get("name", ""),
                        cat))
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e["dur"]), e.get("name", "")))
    del events
    dev.sort()
    kernels = [i for i, ev in enumerate(dev) if ev[3] == "kernel"]
    lo, hi = float("-inf"), float("inf")
    # the capture's own launches: a fill, then `warmup_kernels` adds of one
    # name; everything up to the last of that run is left out
    for j in range(min(4, len(kernels))):
        run = kernels[j:j + warmup_kernels]
        if len(run) == warmup_kernels and \
                len({dev[i][2] for i in run}) == 1:
            last = run[-1]
            if window is not None:
                anchor = dev[last][0] + dev[last][1]
                ret, t0, t1 = window
                lo = anchor + (t0 - ret) * 1e6
                hi = anchor + (t1 - ret) * 1e6
            dev = dev[last + 1:]
            break
    clipped = []
    for ts, dur, name, cat in dev:
        a, b = max(ts, lo), min(ts + dur, hi)
        if b > a:
            clipped.append((a, b - a, name, cat))
    t = Trace(label, device_events=len(clipped))
    for ts, dur, name, cat in clipped:
        t.device_s[name] = t.device_s.get(name, 0.0) + dur / 1e6
        if cat == "kernel":
            t.kernel_s[name] = t.kernel_s.get(name, 0.0) + dur / 1e6
    busy = _union((ts, ts + dur) for ts, dur, _, _ in clipped)
    t.busy_s = sum(b - a for a, b in busy) / 1e6
    prev = lo if lo > float("-inf") else (busy[0][0] if busy else 0.0)
    end = hi if hi < float("inf") else (busy[-1][1] if busy else 0.0)
    gaps = []
    for a, b in busy:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    if end > prev:
        gaps.append((end - prev, prev, end))
    gaps.sort(reverse=True)
    host.sort()
    for width, a, b in gaps[:top_gaps]:
        best, name = 0.0, "no host op traced"
        for ts, dur, hname in host:
            if ts >= b:
                break
            over = min(b, ts + dur) - max(a, ts)
            if over > best:
                best, name = over, hname
        t.gaps.append((f"{label}: {name}", width / 1e6))
    return t


def kernel_time(traces: "list[Trace]", *fragments: str) -> float:
    """Seconds of kernels whose name holds any of `fragments`."""
    return sum(s for t in traces for name, s in t.kernel_s.items()
               if any(f in name for f in fragments))


def breakdown(traces: "list[Trace]") -> dict:
    ops: "dict[str, float]" = {}
    for t in traces:
        for name, s in t.device_s.items():
            ops[name] = ops.get(name, 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted((g for t in traces for g in t.gaps),
                  key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def capture_start(run) -> None:
    """Before the window of a `--trace 1` run: every live server's
    /metrics, then its device capture."""
    from . import promstat
    c = run.cluster
    run.data["scrape_before"] = {r: promstat.parse(t)
                                 for r, t in c.scrape().items()}
    run.data["trace_started"] = c.trace_start()


def capture_end(run) -> None:
    """After the window: stop the captures, read them over the window,
    and take the /metrics deltas."""
    from seaweedfs_tpu_torch.utils import profiling

    from . import promstat
    c = run.cluster
    paths = c.trace_stop()
    after = {r: promstat.parse(t) for r, t in c.scrape().items()}
    before = run.data["scrape_before"]
    run.scrape_delta = {r: promstat.delta(before[r], after[r])
                        for r in after}
    started = run.data["trace_started"]
    run.traces = [read(pth, r, profiling.TRACE_WARMUP_KERNELS,
                       (started[r], run.t_start,
                        run.t_start + run.window_s))
                  for r, pth in paths.items()]
    for pth in paths.values():
        os.remove(pth)
