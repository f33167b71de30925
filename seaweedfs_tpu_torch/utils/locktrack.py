"""Runtime lock-order / race detector (opt-in: SWTPU_LOCKCHECK=1).

The static half of the concurrency plane (devtools/swtpu_lint.py) reads
source; this module watches what the process actually DOES: it wraps
`threading.Lock` / `RLock` / `Condition` with tracking proxies that
record, per thread, the order in which locks are acquired while other
locks are held. Those orderings form a global directed graph; a cycle in
that graph is a potential ABBA deadlock — two threads that interleave at
the wrong moment will block each other forever, even if every individual
test run happens to get lucky. This is the lockdep / TSan lock-order
idea, scoped to what a Python storage daemon needs:

* **cycle findings** — acquiring B while holding A adds edge A→B; if
  B…→A already exists, the cycle is recorded once with both acquisition
  stacks, and the process keeps running (detection, not enforcement);
* **long-hold findings** — a lock held longer than
  SWTPU_LOCKCHECK_HOLD_MS (default 100 ms) was almost certainly held
  across blocking I/O — the runtime mirror of the linter's
  `io-under-lock` rule;
* zero cost when disabled: nothing is patched unless `install()` runs
  (the package `__init__` calls it when SWTPU_LOCKCHECK=1, so any
  entry point — pytest, `python -m seaweedfs_tpu_torch`, a server run
  in a subprocess — is covered by exporting one env var).

Findings surface three ways: `/debug/locks` on the volume server, a
process-exit stderr report, and `findings()` for tests.

Graph nodes are lock *instances* (two per-volume locks created at the
same line are different nodes — nesting them is not a self-deadlock),
labeled with their creation site for reporting. The node population is
capped (SWTPU_LOCKCHECK_MAX_LOCKS, default 4096); beyond the cap new
locks are still real locks, just untracked, and the report says how
many were dropped.

Findings are scoped to locks this package can fix: a cycle or long hold is
reported only when at least one participating lock was created from
seaweedfs_tpu_torch code (or explicitly named via Lock(name=...)). Once
install() patches the factories, stdlib and third-party internals
(ThreadPoolExecutor's shutdown locks, grpc server plumbing) get tracked
too — their orderings stay in the graph so a mixed ours/stdlib cycle is
still caught, but a cycle purely inside library internals is their
bug report, not ours.

asyncio locks participate too: `install()` additionally patches
`asyncio.Lock` / `asyncio.Condition` with tracking proxies. Nodes are
lock instances (an asyncio lock is inherently bound to one event loop,
so the graph is naturally keyed per loop); held stacks are per-TASK
rather than per-thread — task A holding Lock X across an await while
task B holds Y and awaits X forms exactly the ABBA edges the thread
proxies record, which is how single-threaded cooperative scheduling
deadlocks. Cycles that mix thread locks and asyncio locks land in the
same global graph and the same reporter.

The port's copy of seaweedfs_tpu/utils/locktrack.py. Its package test
matches whole path components: a lock is the port's when it was created
in a file under the seaweedfs_tpu_torch directory, and a bare prefix
match would also count a sibling directory whose name starts the same.
"""

from __future__ import annotations

import asyncio
import atexit
import os
import sys
import threading
import time
import traceback
import weakref
import _thread

from .env import env_float as _env_float
from .env import env_int as _env_int

_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_CONDITION = threading.Condition
_ORIG_ASYNC_LOCK = asyncio.Lock
_ORIG_ASYNC_CONDITION = asyncio.Condition

_STACK_DEPTH = 6  # frames kept per acquisition site
# locks created under this root are "ours" for finding attribution; the
# separator keeps a sibling whose name extends it (seaweedfs_tpu_torch2/)
# out
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG_PREFIX = _PKG_ROOT + os.sep


def enabled() -> bool:
    return os.environ.get("SWTPU_LOCKCHECK") == "1"


class _State:
    """All tracker bookkeeping, guarded by one RAW (untracked) lock so
    the tracker can never participate in the graphs it builds."""

    def __init__(self):
        self.guard = _thread.allocate_lock()
        self.hold_threshold_s = _env_float("SWTPU_LOCKCHECK_HOLD_MS",
                                           100.0) / 1000.0
        self.max_locks = _env_int("SWTPU_LOCKCHECK_MAX_LOCKS", 4096)
        self.locks_created = 0
        self.locks_dropped = 0
        # edges[(id_a, id_b)] = {"from","to","count","stack"} (first seen)
        self.edges: dict[tuple[int, int], dict] = {}
        self.adj: dict[int, set[int]] = {}
        self.names: dict[int, str] = {}
        self.own: set[int] = set()   # created from repo code / named
        # lock_id -> count of releases by a thread that never acquired
        # it (cross-thread handoff); the owner purges its stale entry
        # at its next lock operation
        self.orphans: dict[int, int] = {}
        self.cycles: list[dict] = []
        self._cycle_keys: set[tuple] = set()
        self.long_holds: list[dict] = []
        self._hold_keys: set[tuple] = set()

    def reset(self) -> None:
        with self.guard:
            self.edges.clear()
            self.adj.clear()
            self.orphans.clear()
            self.cycles.clear()
            self._cycle_keys.clear()
            self.long_holds.clear()
            self._hold_keys.clear()
            self.locks_dropped = 0


_state = _State()
_tls = threading.local()


def _held_stack() -> list:
    """This thread's stack of (lock_id, name, t_acquired, site, tag) —
    tag is the owning task id for sync locks acquired inside a task."""
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _site(skip: int = 3) -> str:
    """file:line of the acquiring frame, skipping tracker frames."""
    f = sys._getframe(skip)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:  # pragma: no cover
        return "?"
    return f"{os.path.relpath(f.f_code.co_filename)}:{f.f_lineno}"


def _stack(skip: int = 3) -> list[str]:
    frames = traceback.extract_stack(sys._getframe(skip))
    out = [f"{os.path.relpath(fr.filename)}:{fr.lineno} in {fr.name}"
           for fr in frames
           if fr.filename != __file__][-_STACK_DEPTH:]
    return out


def _path_exists(src: int, dst: int) -> list[int] | None:
    """DFS over the order graph (guard held): path src -> dst, or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _state.adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _purge_orphans(held: list) -> None:
    """Drop entries for locks a DIFFERENT thread has since released
    (legal for Lock: acquire-here, release-there handoff). Without this
    the stale entry manufactures false ordering edges from every later
    acquisition in the original thread."""
    if not _state.orphans:  # racy peek is fine; guard taken below
        return
    with _state.guard:
        i = len(held) - 1
        while i >= 0:
            n = _state.orphans.get(held[i][0])
            if n:
                if n == 1:
                    del _state.orphans[held[i][0]]
                else:
                    _state.orphans[held[i][0]] = n - 1
                held.pop(i)
            i -= 1


_async_held: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_async_held_guard = _thread.allocate_lock()


def _async_stack(create: bool = True) -> "list | None":
    """The CURRENT TASK's stack of held asyncio locks (None outside a
    task). The per-thread stack cannot serve here: every task on a loop
    shares one thread, but each holds locks independently across
    awaits."""
    try:
        task = asyncio.current_task()
    except RuntimeError:
        task = None
    if task is None:
        return None
    with _async_held_guard:
        held = _async_held.get(task)
        if held is None and create:
            held = _async_held[task] = []
    return held


def _current_task_id() -> "int | None":
    try:
        task = asyncio.current_task()
    except RuntimeError:
        return None
    return id(task) if task is not None else None


def _enter_tracker() -> bool:
    """Per-thread reentrancy gate around every instrumentation section.

    Recording allocates (stack captures, edge dicts), and any
    allocation can trigger a GC that runs arbitrary `__del__` code —
    grpc's channel destructor, for one — which acquires locks of its
    own. Those locks are tracked too, so without this gate the nested
    instrumentation re-enters the NON-reentrant `_state.guard` the
    outer section still holds and the thread self-deadlocks (then the
    whole process convoys behind it). While the gate is closed the
    real lock operations proceed untouched; only the recording is
    skipped — an acquisition the tracker never saw is already a legal
    state everywhere below (depth-0 releases record nothing, unmatched
    releases ride the orphan machinery)."""
    if getattr(_tls, "busy", False):
        return False
    _tls.busy = True
    return True


def _exit_tracker() -> None:
    _tls.busy = False


def _record_acquired(lock_id: int, name: str) -> None:
    """Called with the real lock already held (success path only)."""
    if not _enter_tracker():
        return
    try:
        held = _held_stack()
        _purge_orphans(held)
        # a sync lock taken while THIS task holds an asyncio lock orders
        # after it (same execution flow, different stack); the acquisition
        # is tagged with the owning task so the reverse direction can tell
        # this task's sync locks from another task's held-across-an-await
        _note_acquired(held, lock_id, name,
                       cross_held=_async_stack(create=False),
                       tag=_current_task_id())
    finally:
        _exit_tracker()


def _add_edge(prev_id: int, prev_name: str, lock_id: int,
              name: str) -> None:
    """Record ordering edge prev -> this; closing a reverse path that
    touches one of OUR locks is the cycle finding."""
    key = (prev_id, lock_id)
    with _state.guard:
        ent = _state.edges.get(key)
        if ent is not None:
            ent["count"] += 1
            return
        # new edge: before adding prev -> this, check whether the
        # REVERSE ordering is already on record — that is the cycle
        path = _path_exists(lock_id, prev_id)
        _state.edges[key] = {
            "from": prev_name, "to": name, "count": 1,
            "stack": _stack(),
        }
        _state.adj.setdefault(prev_id, set()).add(lock_id)
        if path is not None and any(n in _state.own for n in path):
            # path is this-lock -> ... -> prev; the new edge
            # prev -> this closes the loop. Cycles entirely
            # inside stdlib/third-party locks are not reported
            # (we can't fix them); one repo lock in the loop is
            # enough to make it ours.
            names = [_state.names.get(n, "?") for n in path]
            ckey = tuple(sorted(set(names)))
            if ckey not in _state._cycle_keys:
                _state._cycle_keys.add(ckey)
                rev = _state.edges.get((path[0], path[1])
                                       if len(path) > 1 else key)
                _state.cycles.append({
                    "locks": names,
                    "thread": threading.current_thread().name,
                    "stack": _stack(),
                    "reverse_stack": (rev or {}).get("stack", []),
                })


def _note_acquired(held: list, lock_id: int, name: str,
                   cross_held: "list | None" = None,
                   tag: "int | None" = None) -> None:
    """Edge recording against an explicit held stack (per-thread for
    threading locks, per-task for asyncio locks — one shared graph).
    `cross_held` is the OTHER domain's stack for the same execution
    flow: a sync lock taken inside a task that holds an asyncio lock
    (or vice versa) is a real ordering, even though the two live on
    different stacks. `tag` rides the held entry (the owning task id
    for sync locks acquired inside a task) so cross-domain consumers
    can filter out locks that belong to a DIFFERENT task."""
    t_now = time.monotonic()
    if held:
        _add_edge(held[-1][0], held[-1][1], lock_id, name)
    if cross_held:
        prev_id, prev_name = cross_held[-1][0], cross_held[-1][1]
        if prev_id != lock_id and not (held and held[-1][0] == prev_id):
            _add_edge(prev_id, prev_name, lock_id, name)
    held.append((lock_id, name, t_now, _site(), tag))


def _record_released(lock_id: int) -> None:
    if not _enter_tracker():
        return
    try:
        held = _held_stack()
        _purge_orphans(held)
        if _note_released(held, lock_id):
            return
        # not held by this thread: a handoff release — flag it so the
        # acquiring thread clears its stale entry at its next lock op
        with _state.guard:
            _state.orphans[lock_id] = _state.orphans.get(lock_id, 0) + 1
    finally:
        _exit_tracker()


def _note_released(held: list, lock_id: int) -> bool:
    """Pop the lock from an explicit held stack; False when this stack
    never saw the acquisition (thread handoff / foreign-task release)."""
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == lock_id:
            _, name, t_acq, site, _tag = held.pop(i)
            dt = time.monotonic() - t_acq
            if dt > _state.hold_threshold_s and lock_id in _state.own:
                key = (name, site)
                with _state.guard:
                    if key not in _state._hold_keys:
                        _state._hold_keys.add(key)
                        _state.long_holds.append({
                            "lock": name, "site": site,
                            "held_ms": round(dt * 1e3, 1),
                            "thread": threading.current_thread().name,
                        })
                    else:
                        for h in _state.long_holds:
                            if (h["lock"], h["site"]) == key:
                                h["held_ms"] = max(h["held_ms"],
                                                   round(dt * 1e3, 1))
            return True
    return False


def _creator_is_ours() -> bool:
    """Was the lock constructed from repo code (vs library internals)?"""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    return f is not None and f.f_code.co_filename.startswith(_PKG_PREFIX)


def _register_node(name: str, own: bool) -> "tuple[int, bool]":
    """Allot a graph node. The key is a serial, not id(): a collected
    lock's id gets recycled and would inherit the dead lock's history."""
    if not _enter_tracker():
        # minted from inside a tracker section (a GC-run destructor):
        # taking the guard here would deadlock — leave it untracked
        return 0, False
    try:
        with _state.guard:
            _state.locks_created += 1
            node_id = _state.locks_created
            tracked = _state.locks_created <= _state.max_locks
            if tracked:
                _state.names[node_id] = name
                if own:
                    _state.own.add(node_id)
            else:
                _state.locks_dropped += 1
        return node_id, tracked
    finally:
        _exit_tracker()


class TrackedLock:
    """Drop-in `threading.Lock`/`RLock` proxy feeding the order graph."""

    __slots__ = ("_lock", "_name", "_id", "_tracked", "_reentrant")

    def __init__(self, reentrant: bool = False, name: str | None = None):
        self._lock = _ORIG_RLOCK() if reentrant else _ORIG_LOCK()
        self._reentrant = reentrant
        self._name = name or f"{'RLock' if reentrant else 'Lock'}" \
                             f"@{_site(2)}"
        # an explicit name or a creation site inside the package makes
        # findings about this lock OURS to report (vs library internals)
        self._id, self._tracked = _register_node(
            self._name, name is not None or _creator_is_ours())

    # -- depth bookkeeping for reentrant proxies ------------------------------
    def _depth_map(self) -> dict:
        m = getattr(_tls, "depth", None)
        if m is None:
            m = _tls.depth = {}
        return m

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got and self._tracked:
            if self._reentrant:
                m = self._depth_map()
                d = m.get(self._id, 0)
                m[self._id] = d + 1
                if d == 0:
                    _record_acquired(self._id, self._name)
            else:
                _record_acquired(self._id, self._name)
        return got

    def release(self):
        if self._tracked:
            if self._reentrant:
                m = self._depth_map()
                d = m.get(self._id, 0)
                if d == 1:
                    m.pop(self._id, None)
                    _record_released(self._id)
                elif d > 1:
                    m[self._id] = d - 1
                # d == 0: an acquisition the tracker never saw — record
                # nothing (an over-release raises from the real RLock
                # below; recording would plant a phantom orphan)
            else:
                _record_released(self._id)
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    def _at_fork_reinit(self):
        # stdlib internals (concurrent.futures.thread, threading) call
        # this on the locks they create via the patched factories
        self._lock._at_fork_reinit()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover
        return f"<TrackedLock {self._name}>"

    # threading.Condition probes these on its inner lock; delegating
    # keeps Condition(TrackedRLock()) fully functional
    def _is_owned(self):
        if self._reentrant:
            return self._lock._is_owned()
        return self._lock.locked()

    def _release_save(self):
        if self._reentrant:
            depth = 0
            if self._tracked:
                m = self._depth_map()
                depth = m.pop(self._id, 0)
                if depth > 0:
                    _record_released(self._id)
            return self._lock._release_save(), depth
        self.release()
        return None

    def _acquire_restore(self, state):
        if self._reentrant:
            saved, depth = state
            self._lock._acquire_restore(saved)
            # restore the SAVED recursion depth: the real RLock is back
            # at count N, and pinning the proxy to 1 would make the
            # trailing N-1 releases look like phantom cross-thread
            # orphans, silently purging live held-stack entries
            if self._tracked and depth > 0:
                self._depth_map()[self._id] = depth
                _record_acquired(self._id, self._name)
            return
        self.acquire()


class TrackedAsyncLock:
    """Drop-in `asyncio.Lock` proxy feeding the same order graph.

    An asyncio lock is bound to one event loop, so graph nodes stay
    naturally loop-scoped; acquisition order is tracked per TASK — the
    cooperative-scheduling deadlock is task A holding X across an await
    while task B holds Y and awaits X, and those are exactly the edges a
    per-task held stack records. Supports the `threading.Condition`-free
    subset asyncio.Condition drives (acquire/release/locked)."""

    __slots__ = ("_lock", "_name", "_id", "_tracked")

    def __init__(self, name: str | None = None):
        self._lock = _ORIG_ASYNC_LOCK()
        self._name = name or f"asyncio.Lock@{_site(2)}"
        self._id, self._tracked = _register_node(
            self._name, name is not None or _creator_is_ours())

    async def acquire(self):
        got = await self._lock.acquire()
        if got and self._tracked and _enter_tracker():
            try:
                held = _async_stack()
                if held is not None:
                    # only sync locks THIS task acquired are
                    # predecessors: a lock another task holds across an
                    # await sits on the same thread stack but belongs
                    # to a different flow — borrowing it would
                    # fabricate ordering edges (and phantom deadlock
                    # findings)
                    tid = _current_task_id()
                    mine = [e for e in _held_stack() if e[4] == tid]
                    _note_acquired(held, self._id, self._name,
                                   cross_held=mine)
            finally:
                _exit_tracker()
        return got

    def release(self):
        if self._tracked and _enter_tracker():
            try:
                held = _async_stack(create=False)
                if held is not None:
                    # a release from a task that never acquired (legal
                    # for asyncio.Lock) records nothing — no cross-task
                    # orphan machinery needed, the acquirer's entry
                    # dies with its task's weakref
                    _note_released(held, self._id)
            finally:
                _exit_tracker()
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    async def __aenter__(self):
        await self.acquire()
        return None  # asyncio.Lock's contract: aenter yields None

    async def __aexit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover
        return f"<TrackedAsyncLock {self._name}>"


def Lock(name: str | None = None) -> TrackedLock:
    return TrackedLock(reentrant=False, name=name)


def RLock(name: str | None = None) -> TrackedLock:
    return TrackedLock(reentrant=True, name=name)


def Condition(lock=None):
    return _ORIG_CONDITION(lock if lock is not None else RLock())


class TrackedAsyncCondition(_ORIG_ASYNC_CONDITION):
    """asyncio.Condition over a tracked default lock. A real subclass —
    not a factory — so `isinstance(c, asyncio.Condition)` and
    `class X(asyncio.Condition)` keep working while the patch is live
    (the threading patch never had that hazard because threading.Lock
    is already a factory function in CPython; asyncio.Lock is a
    class). The base duck-types its lock (delegates acquire/release/
    locked), so the tracked proxy slots straight in."""

    def __init__(self, lock=None):
        super().__init__(lock if lock is not None else TrackedAsyncLock())


# patched in as asyncio.Lock must stay class-like for the same reason;
# TrackedAsyncLock already accepts the optional name kwarg
AsyncLock = TrackedAsyncLock
AsyncCondition = TrackedAsyncCondition


_installed = False


def install() -> bool:
    """Patch threading.Lock/RLock/Condition AND asyncio.Lock/Condition
    with the tracking proxies. Everything constructed afterwards —
    including Event/Queue internals and aiohttp handler coordination —
    participates. Idempotent; returns whether the patch is active."""
    global _installed
    if _installed:
        return True
    _installed = True
    threading.Lock = Lock
    threading.RLock = RLock
    threading.Condition = Condition
    asyncio.Lock = AsyncLock
    asyncio.locks.Lock = AsyncLock
    asyncio.Condition = AsyncCondition
    asyncio.locks.Condition = AsyncCondition
    atexit.register(_exit_report)
    return True


def uninstall() -> None:
    """Restore the original factories (test isolation). Locks already
    created keep working — they proxy real primitives."""
    global _installed
    if not _installed:
        return
    _installed = False
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    threading.Condition = _ORIG_CONDITION
    asyncio.Lock = _ORIG_ASYNC_LOCK
    asyncio.locks.Lock = _ORIG_ASYNC_LOCK
    asyncio.Condition = _ORIG_ASYNC_CONDITION
    asyncio.locks.Condition = _ORIG_ASYNC_CONDITION
    try:
        atexit.unregister(_exit_report)
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (shutdown best-effort)
        pass


def installed() -> bool:
    return _installed


def reset() -> None:
    """Clear findings + graph (test isolation between scenarios)."""
    _state.reset()


def findings() -> dict:
    """Snapshot for /debug/locks, the exit report, and test asserts."""
    with _state.guard:
        return {
            "enabled": _installed,
            "locks_tracked": min(_state.locks_created, _state.max_locks),
            "locks_untracked": _state.locks_dropped,
            "edges": len(_state.edges),
            "hold_threshold_ms": round(_state.hold_threshold_s * 1e3, 1),
            "cycles": [dict(c) for c in _state.cycles],
            "long_holds": sorted((dict(h) for h in _state.long_holds),
                                 key=lambda h: -h["held_ms"]),
        }


def debug_locks_payload(query: dict | None = None) -> dict:
    """The shared /debug/locks response body. `?edges=1` adds the raw
    order graph (big); default keeps the payload to the verdicts."""
    out = findings()
    if query and str(query.get("edges", "")) in ("1", "true"):
        with _state.guard:
            out["edge_list"] = [dict(e) for e in _state.edges.values()]
    return out


def _exit_report() -> None:
    rep = findings()
    if not rep["cycles"] and not rep["long_holds"]:
        return
    w = sys.stderr.write
    w("\n== locktrack report (SWTPU_LOCKCHECK=1) ==\n")
    for c in rep["cycles"]:
        w(f"POTENTIAL DEADLOCK: lock-order cycle {' -> '.join(c['locks'])} "
          f"(thread {c['thread']})\n")
        for line in c["stack"]:
            w(f"    {line}\n")
        if c["reverse_stack"]:
            w("  reverse ordering first seen at:\n")
            for line in c["reverse_stack"]:
                w(f"    {line}\n")
    for h in rep["long_holds"][:20]:
        w(f"LONG HOLD: {h['lock']} held {h['held_ms']}ms at {h['site']} "
          f"(thread {h['thread']}) — blocking call under a lock?\n")
    w(f"== {len(rep['cycles'])} cycle(s), {len(rep['long_holds'])} "
      f"long hold(s); {rep['edges']} orderings observed ==\n")
