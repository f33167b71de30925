"""Continuous sampling profiler: always-on fleet flamegraphs.

The port's copy of seaweedfs_tpu/profiling/sampler.py, with two more
thread classes: `ec_read`, the port volume server's degraded-read pool
(`ec-read-<port>` threads), and `ec_run`, an EC needle read's per-read
fan-out (`ec-run-<vid>` threads), which the reference counts under
read_pool and other; and one more waiting frame: an idle
ThreadPoolExecutor worker, whose innermost Python frame is
`thread.py:_worker` (it parks in the C `SimpleQueue.get`), samples as
waiting; the reference counts it on-CPU.

The reference answers "where is the CPU going?" with `net/http/pprof`
on -debug.port (command/imports.go:4) — a continuous, low-overhead
sampler every Go daemon carries. The Python analogue here is a
background thread that walks `sys._current_frames()` at
`SWTPU_PROFILE_HZ` (default 19 Hz — prime, so the sampler cannot
lockstep with the 2 s heartbeat, 15 s telemetry scrape or any other
round-interval periodic work) into a bounded folded-stack aggregate.

Each sampled thread is attributed twice before its stack is folded:

* a **thread class** from a closed set (event_loop / read_pool /
  writer_pool / grpc / raft / other), derived from the thread-name
  conventions every pool in this tree already follows (`vs-read-*`,
  `swtpu-ec-writer-*`, `grpc-worker*`, `raft-*`, `*-http*`);
* an **on-CPU vs waiting** split from a leaf-frame heuristic: a thread
  whose innermost Python frame is a known blocking primitive
  (threading.Event.wait, selectors.select, queue.get, ssl read, ...)
  is parked, not burning CPU — exactly the distinction the ROADMAP's
  queueing-inflated recv_parse number was missing.

The aggregate is served at `/debug/profile?mode=continuous` as
collapsed-flamegraph text (`class;state;frame;frame;... count` — feed
it straight to flamegraph.pl / speedscope), and as JSON at
`?mode=summary` for the telemetry collector's fleet merge. Memory is
bounded: at most SWTPU_PROFILE_MAX_STACKS distinct stacks; overflow
collapses into a per-class `~other` bucket so total sample counts stay
exact (the fleet merge sums counts — silent truncation would lie).

Daemons share one process-wide sampler via acquire_sampler() /
release_sampler() refcounting (tests start several servers in one
process; N servers must not mean N sampling threads).
"""

from __future__ import annotations

import os
import sys
import threading
import time

from ..utils.env import env_float, env_int

THREAD_CLASSES = ("event_loop", "read_pool", "ec_read", "ec_run",
                  "writer_pool", "grpc", "raft", "other")

DEFAULT_HZ = 19.0  # prime: cannot lockstep with round periodic work

# thread-name substring -> class, first match wins; every pool in the
# tree names its threads (vs-read-, swtpu-ec-writer-, grpc-worker,
# raft-rpc/raft-<addr>, vs-http-/master-http/filer-http-/s3-http-)
_NAME_RULES = (
    ("vs-read-", "read_pool"),
    # the port's degraded-read fan-out pool (`ec-read-<port>`): a class of
    # its own, so a profile tells survivor gathers from needle reads
    ("ec-read-", "ec_read"),
    # EcVolume.read_logical's per-read fan-out threads (`ec-run-<vid>`):
    # the direct fetches and the reconstruct's gather, stage and K1 calls
    ("ec-run-", "ec_run"),
    ("ec-degraded-read", "read_pool"),
    ("swtpu-ec-writer", "writer_pool"),
    ("chunk-upload-", "writer_pool"),
    ("stream-write-", "writer_pool"),
    ("grpc-worker", "grpc"),
    ("raft", "raft"),
    ("-http", "event_loop"),
    ("asyncio_", "event_loop"),  # the loops' default run_in_executor pool
)

# leaf-frame heuristic for "parked, not running": the innermost Python
# frame of a blocked thread is the stdlib wrapper around the C-level
# wait (Event.wait ends in threading.py:wait, an idle executor worker
# in queue.py:get, a selector loop in selectors.py:select, ...)
_WAIT_FILES = {"threading.py", "selectors.py", "socket.py", "queue.py",
               "ssl.py", "subprocess.py", "connection.py",
               "synchronize.py", "popen_fork.py"}
_WAIT_FUNCS = {"wait", "acquire", "select", "poll", "accept", "recv",
               "recv_into", "recvfrom", "read", "readinto", "get",
               "join", "_wait_for_tstate_lock", "flush", "sleep"}


def classify_thread(name: str) -> str:
    for needle, cls in _NAME_RULES:
        if needle in name:
            return cls
    return "other"


# innermost frames that park in C with no stdlib Python wrapper below them:
# an idle ThreadPoolExecutor worker blocks in SimpleQueue.get (C) straight
# from concurrent/futures/thread.py:_worker (a running work item's own
# frames sit below _worker, so _worker innermost is always the wait)
_WAIT_FRAMES = {("thread.py", "_worker")}


def _is_waiting(frame) -> bool:
    code = frame.f_code
    base = os.path.basename(code.co_filename)
    return ((code.co_name in _WAIT_FUNCS and base in _WAIT_FILES)
            or (base, code.co_name) in _WAIT_FRAMES)


def _fold(frame, max_depth: int) -> str:
    """Innermost frame -> `file.py:func;...` root-to-leaf folded stack."""
    parts: list[str] = []
    f = frame
    while f is not None and len(parts) < max_depth:
        code = f.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:{code.co_name}")
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


class ContinuousSampler:
    def __init__(self, hz: "float | None" = None,
                 max_stacks: "int | None" = None, max_depth: int = 48):
        self._hz = (env_float("SWTPU_PROFILE_HZ", DEFAULT_HZ)
                    if hz is None else float(hz))
        self._max_stacks = (env_int("SWTPU_PROFILE_MAX_STACKS", 4000)
                            if max_stacks is None else int(max_stacks))
        self._max_depth = max_depth
        self._agg: dict[str, int] = {}
        self._samples = 0          # total thread-samples in the aggregate
        self._ticks = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._names: dict[int, str] = {}  # tid -> name, refreshed lazily

    # -- lifecycle -------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def hz(self) -> float:
        return self._hz

    def set_hz(self, hz: float) -> None:
        """Runtime rate control: 0 pauses sampling (the bench's A/B
        overhead phases toggle this on a live cluster), capped well
        below anything that could matter for overhead."""
        self._hz = min(max(0.0, float(hz)), 250.0)

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="swtpu-profiler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None

    # -- sampling loop ---------------------------------------------------
    def _run(self) -> None:
        next_t = time.monotonic()
        while not self._stop.is_set():
            hz = self._hz
            if hz <= 0:
                # paused: park cheaply, re-anchor the schedule on resume
                self._stop.wait(0.25)
                next_t = time.monotonic()
                continue
            self._sample_once()
            next_t += 1.0 / hz
            delay = next_t - time.monotonic()
            if delay <= 0:
                # fell behind (GIL-starved under load): skip, don't burst
                next_t = time.monotonic()
            else:
                self._stop.wait(delay)

    def _thread_names(self, tids) -> dict[int, str]:
        names = self._names
        if any(tid not in names for tid in tids):
            names = {t.ident: t.name for t in threading.enumerate()
                     if t.ident is not None}
            self._names = names
        return names

    def _sample_once(self) -> None:
        me = threading.get_ident()
        frames = sys._current_frames()
        names = self._thread_names(frames.keys())
        per_cs: dict[tuple[str, str], int] = {}
        with self._lock:
            self._ticks += 1
            for tid, frame in frames.items():
                if tid == me:
                    continue
                cls = classify_thread(names.get(tid, ""))
                state = "waiting" if _is_waiting(frame) else "on_cpu"
                key = f"{cls};{state};{_fold(frame, self._max_depth)}"
                if key not in self._agg and \
                        len(self._agg) >= self._max_stacks:
                    # bounded aggregate: overflow collapses per class so
                    # totals stay exact for the fleet merge
                    key = f"{cls};{state};~other"
                self._agg[key] = self._agg.get(key, 0) + 1
                self._samples += 1
                ck = (cls, state)
                per_cs[ck] = per_cs.get(ck, 0) + 1
        try:
            from ..stats import PROFILE_SAMPLES
            for (cls, state), n in per_cs.items():
                PROFILE_SAMPLES.inc(cls, state, amount=n)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never kill the sampler)
            pass

    # -- read API --------------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._agg.clear()
            self._samples = 0
            self._ticks = 0

    def collapsed(self, min_count: int = 1) -> str:
        """Collapsed-flamegraph text: one `stack count` line per folded
        stack, prefixed by the class;state attribution frames."""
        with self._lock:
            items = sorted(self._agg.items(),
                           key=lambda kv: (-kv[1], kv[0]))
            hz, ticks, samples = self._hz, self._ticks, self._samples
        lines = [f"# swtpu continuous profile: {samples} thread-samples "
                 f"over {ticks} ticks at {hz:g} Hz "
                 f"(folded: class;state;frames... count)"]
        lines += [f"{k} {n}" for k, n in items if n >= min_count]
        return "\n".join(lines) + "\n"

    def summary(self, top: int = 200) -> dict:
        """JSON summary for the telemetry collector's fleet merge.
        Stacks beyond `top` roll into their class's `~other` line so
        per-node counts still sum exactly cluster-wide."""
        with self._lock:
            items = sorted(self._agg.items(),
                           key=lambda kv: (-kv[1], kv[0]))
            hz, ticks, samples = self._hz, self._ticks, self._samples
        classes: dict[str, dict[str, int]] = {}
        for key, n in items:
            cls, state, _, = key.split(";", 2)
            c = classes.setdefault(cls, {"on_cpu": 0, "waiting": 0})
            c[state] = c.get(state, 0) + n
        stacks: dict[str, int] = {}
        for key, n in items:
            if len(stacks) < top or key in stacks:
                stacks[key] = stacks.get(key, 0) + n
            else:
                cls, state, _ = key.split(";", 2)
                okey = f"{cls};{state};~other"
                stacks[okey] = stacks.get(okey, 0) + n
        return {"hz": hz, "ticks": ticks, "samples": samples,
                "classes": classes,
                "stacks": [{"stack": k, "count": n}
                           for k, n in stacks.items()]}


# -- process-wide default sampler (refcounted across daemons) ------------
_default: "ContinuousSampler | None" = None
_refs = 0
_ref_lock = threading.Lock()


def acquire_sampler() -> ContinuousSampler:
    """Daemon start(): share one sampling thread per process no matter
    how many servers a test or combo binary runs in it."""
    global _default, _refs
    with _ref_lock:
        if _default is None:
            _default = ContinuousSampler()
        _refs += 1
        if not _default.running and _default.hz > 0:
            _default.start()
        return _default


def release_sampler() -> None:
    """Daemon stop(): the last daemon out joins the sampler thread (the
    aggregate is kept for postmortem reads)."""
    global _refs
    with _ref_lock:
        _refs = max(0, _refs - 1)
        if _refs == 0 and _default is not None:
            _default.stop()


def default_sampler() -> "ContinuousSampler | None":
    return _default
