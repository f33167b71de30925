"""CPU seconds of this process's threads by thread class, always on.

A server that serves /metrics calls `THREAD_CPU.install()` as it starts;
a process that does not (a client, the shell, the mount) keeps neither
the scrape hook nor the thread wrapper below. When /metrics is scraped (a
stats scrape hook), `ThreadCpu.refresh` reads the user + system time of
each Python thread's task from /proc/self/task/<native_id>/stat and adds
its growth since it was last read to
SeaweedFS_process_thread_cpu_seconds_total{class}, the class being
`sampler.classify_thread` of the thread's name. A Python thread started
after `install()` also reads its own CPU clock as it ends: `install()`
wraps `threading.Thread._bootstrap_inner`, the frame every `threading`
thread runs its target under, so the thread counts itself after its
target returns, and is then forgotten. So threads that live shorter than
the time between two scrapes (an EC read's per-read fan-out, gRPC's
channel-spin threads) are counted whole, and a server that nobody scrapes
keeps nothing of the threads that ended. (A `threading.setprofile` hook would do the
same without touching `threading`, but on CPython 3.12 each profile
function set and removed re-instruments every running function, which
slows every thread of a server that starts threads by the hundred.)

A block run under `counted_as(cls)` is counted as `cls` on whatever
thread runs it: a device capture's own start and stop are `capture`
(utils/profiling), so a traced run's export does not read as the HTTP
plane's CPU.

What the process used (/proc/self/stat, read after the threads) beyond
every Python thread's count is class `native`: the tasks with no Python
thread (gRPC core, the CUDA driver, torch's own pools), those that ended
between two scrapes included, which no read after their end can class.
The family only grows, and at each scrape its classes sum to the
process's CPU. Where /proc cannot be read nothing is counted, and the
family is absent: never a zero that was not read.

Port-only: the JAX package has no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from .sampler import classify_thread

NATIVE = "native"
CAPTURE = "capture"

_TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _task_seconds(tid: int) -> "float | None":
    """User + system seconds of task `tid` of this process, or None where
    it cannot be read (ended, or no /proc)."""
    try:
        with open(f"/proc/self/task/{tid}/stat", "rb") as f:
            fields = f.read().rsplit(b")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / _TICK
    except (OSError, IndexError, ValueError):
        return None


def _process_seconds() -> "float | None":
    """User + system seconds of this process, every task that ended
    included."""
    try:
        with open("/proc/self/stat", "rb") as f:
            fields = f.read().rsplit(b")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / _TICK
    except (OSError, IndexError, ValueError):
        return None


def _task_ids() -> "list[int] | None":
    """The ids of this process's tasks, or None where /proc cannot tell."""
    try:
        return [int(t) for t in os.listdir("/proc/self/task")]
    except (OSError, ValueError):
        return None


def _python_threads() -> "dict[int, threading.Thread]":
    """{native_id: thread} of this process's Python threads."""
    return {t.native_id: t for t in threading.enumerate()}


class ThreadCpu:
    """The process's thread CPU, counted by class into `counter`."""

    def __init__(self, counter):
        self.counter = counter
        self._lock = threading.Lock()
        # held across a refresh, which lists the threads before it reads
        # and counts them
        self._refreshing = threading.Lock()
        # (tid, id of its Thread) -> the seconds of it already counted, of
        # live threads: a tid reused by a new thread starts from nothing,
        # and a read in whole ticks after a finer one of the thread's own
        # clock adds nothing
        self._counted: dict[tuple, float] = {}
        # the keys of threads that counted themselves at their end while a
        # refresh ran, which may have listed them alive: that refresh
        # counts them no more, and clears the set
        self._ended: set = set()
        self._total = 0.0  # every class's count
        # without /proc nothing is counted, not even a thread's own clock
        self._readable = _task_ids() is not None

    def _add(self, key: tuple, cls: str, seconds: float) -> None:
        base = self._counted.get(key, 0.0)
        if seconds > base:
            self.counter.inc(cls, amount=seconds - base)
            self._total += seconds - base
            self._counted[key] = seconds

    def refresh(self) -> None:
        """Count each Python thread's growth since it was last read, and
        the process's beyond them as `native`."""
        with self._refreshing:
            tids = _task_ids()
            if tids is None:
                return
            threads = _python_threads()
            read = [(tid, threads[tid], _task_seconds(tid))
                    for tid in tids if tid in threads]
            process = _process_seconds()
            if process is None:
                return
            with self._lock:
                for tid, thread, seconds in read:
                    key = (tid, id(thread))
                    if seconds is not None and key not in self._ended:
                        self._add(key, classify_thread(thread.name), seconds)
                self._ended.clear()
                # forget a thread once its task is gone: a thread that was
                # running before install() never counts itself at its end
                live = set(tids)
                for key in [k for k in self._counted if k[0] not in live]:
                    del self._counted[key]
                if process > self._total:
                    self.counter.inc(NATIVE, amount=process - self._total)
                    self._total = process

    def note_self(self, cls: str,
                  thread: "threading.Thread | None" = None) -> None:
        """Count the calling thread's growth now, as class `cls`, from its
        own CPU clock (finer than /proc's ticks). `thread`: the calling
        thread's object."""
        if not self._readable:
            return
        seconds = time.thread_time()
        key = (threading.get_native_id(),
               id(thread or threading.current_thread()))
        with self._lock:
            self._add(key, cls, seconds)

    def note_end(self, thread: threading.Thread) -> None:
        """Count the calling thread's last growth as it ends, from its own
        clock (a system call where /proc would cost a file's open and read
        on every thread's end), and forget it. `thread`, its object, has
        left threading's table."""
        if not self._readable:
            return
        seconds = time.thread_time()
        key = (threading.get_native_id(), id(thread))
        # no refresh running: none listed this thread, and none to come
        # will, so nothing of it needs keeping
        idle = self._refreshing.acquire(blocking=False)
        try:
            with self._lock:
                self._add(key, classify_thread(thread.name), seconds)
                self._counted.pop(key, None)
                if not idle:
                    self._ended.add(key)
        finally:
            if idle:
                self._refreshing.release()

    @contextlib.contextmanager
    def counted_as(self, cls: str):
        """Count the calling thread's CPU inside the block as class `cls`
        rather than its thread's."""
        thread = threading.current_thread()
        self.note_self(classify_thread(thread.name), thread)
        try:
            yield
        finally:
            self.note_self(cls, thread)

    def install(self) -> None:
        """Count at every /metrics scrape, and read each Python thread
        started from now on as it ends: where a server starts serving
        /metrics. Once a process: a Python without the wrapped method
        leaves the threads that end between scrapes to `native`."""
        from ..stats import register_scrape_hook
        register_scrape_hook(self.refresh)
        inner = getattr(threading.Thread, "_bootstrap_inner", None)
        if inner is None or getattr(inner, "_counts_cpu", False):
            return
        tracker = self

        def _bootstrap_inner(thread):
            try:
                inner(thread)
            finally:
                try:
                    tracker.note_end(thread)
                except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (a thread's end must never raise)
                    pass
        _bootstrap_inner._counts_cpu = True
        threading.Thread._bootstrap_inner = _bootstrap_inner


def _tracker() -> ThreadCpu:
    from ..stats import PROCESS_THREAD_CPU
    return ThreadCpu(PROCESS_THREAD_CPU)


THREAD_CPU = _tracker()
