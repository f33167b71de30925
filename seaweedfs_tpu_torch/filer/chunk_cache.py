"""Tiered chunk cache + prefetching reader cache for the read path.

Reference: weed/util/chunk_cache/chunk_cache.go (mem tier over bounded
on-disk tiers, consulted on every filer/mount/S3 chunk read) and
weed/filer/reader_cache.go (bounded concurrent prefetch of upcoming chunks
with single-flight downloads).

Design here: one `ChunkCache` with a byte-bounded in-memory LRU and an
optional byte-bounded disk tier (chunk files under a cache dir, LRU by
access order, survives process restarts via a directory scan); one
`ReaderCache` that serves fetch-through reads with single-flight dedup and
prefetches the next chunks of a file onto a small thread pool. The filer
HTTP read path, the S3 gateway (which reads through the filer), FUSE
reads, and the remote FilerClient all share these types.

The port's copy of seaweedfs_tpu/filer/chunk_cache.py, unchanged (the S3
gateway and FUSE reads it names come with later slices of the port).
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

from ..utils.log import logger

log = logger("chunk-cache")


def iter_windows(chunks, offset: int, size: int, fetch, fetch_many=None,
                 prefetch=None, window_views: int = 4):
    """Yield [offset, offset+size) of a chunked file as a sequence of
    byte windows of up to `window_views` resolved ChunkViews each.

    `fetch(fid, upcoming)` returns one chunk's stored bytes (a
    ReaderCache read; `upcoming` are prefetch hints). With `fetch_many`
    (ReaderCache.read_many) each window's blobs are gathered
    CONCURRENTLY — cold chunks fan out on the reader pool with
    single-flight dedup — and `prefetch` (ReaderCache.prefetch) is
    kicked for the NEXT window before this window's gather, so the cold
    fan-out overlaps the caller writing the current window out. Peak
    memory is O(window_views x chunk_size), never O(size).

    Windows tile the request exactly (gaps between visible intervals
    yield zeros, like a sparse read), so concatenating them is
    byte-identical to `assemble_window` — which is implemented on top of
    this generator."""
    from .chunks import read_views

    views = list(read_views(chunks, offset, size))
    end = offset + size
    beyond = [c.file_id for c in chunks if c.offset >= end][:4]
    if not views:
        if size > 0:
            yield bytes(size)
        return
    windows = [views[i:i + window_views]
               for i in range(0, len(views), window_views)]
    cur = offset
    for w, wviews in enumerate(windows):
        nxt = ([v.file_id for v in windows[w + 1]]
               if w + 1 < len(windows) else beyond)
        blobs = (fetch_many([v.file_id for v in wviews])
                 if fetch_many is not None else {})
        # prefetch the NEXT window only after this one's gather: the
        # shared reader pool is FIFO, and enqueuing w+1 first would put
        # window w's cold fetches BEHIND it (doubled time-to-first-byte
        # on every cold read). Kicked here, the prefetch overlaps the
        # caller consuming/writing window w instead.
        if prefetch is not None:
            for fid in nxt:
                prefetch(fid)
        wend = (wviews[-1].logical_offset + wviews[-1].size
                if w + 1 < len(windows) else end)
        buf = bytearray(wend - cur)
        for i, v in enumerate(wviews):
            blob = blobs.get(v.file_id)
            if blob is None:
                upcoming = [x.file_id for x in wviews[i + 1:i + 3]] or nxt
                blob = fetch(v.file_id, upcoming)
            if v.cipher_key:
                # lazy: cipher needs the optional `cryptography` package —
                # plaintext reads must work without it installed
                from ..security.cipher import decrypt
                blob = decrypt(blob, v.cipher_key)
            part = blob[v.chunk_offset:v.chunk_offset + v.size]
            at = v.logical_offset - cur
            buf[at:at + len(part)] = part
        yield bytes(buf)
        cur = wend


def assemble_window(chunks, offset: int, size: int, fetch,
                    fetch_many=None) -> bytes:
    """Assemble [offset, offset+size) of a chunked file in one buffer.

    The one implementation behind both the filer server's and the remote
    client's read paths; `fetch_many` turns each window's cold fetches
    into a concurrent fan-out (see iter_windows)."""
    return b"".join(iter_windows(chunks, offset, size, fetch,
                                 fetch_many=fetch_many))


class ChunkCache:
    """fid -> chunk bytes, memory tier over an optional disk tier."""

    def __init__(self, mem_limit_bytes: int = 64 << 20,
                 disk_dir: str | None = None,
                 disk_limit_bytes: int = 1 << 30,
                 mem_chunk_max: int = 8 << 20):
        self.mem_limit = mem_limit_bytes
        # bigger chunks go disk-only — but with NO disk tier they must
        # still be mem-cacheable (up to half the budget), or a >8MB
        # chunk_size config would re-fetch a full chunk per 128KiB
        # kernel read slice
        if disk_dir is None:
            mem_chunk_max = max(mem_chunk_max, mem_limit_bytes // 2)
        self.mem_chunk_max = mem_chunk_max
        self._mem: "OrderedDict[str, bytes]" = OrderedDict()
        self._mem_bytes = 0
        self._lock = threading.Lock()
        self.disk_dir = disk_dir
        self.disk_limit = disk_limit_bytes
        self._disk: "OrderedDict[str, int]" = OrderedDict()  # fid -> size
        self._disk_bytes = 0
        self.hits = 0
        self.misses = 0
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
            # adopt chunks left by a previous run (oldest first)
            entries = []
            for name in os.listdir(disk_dir):
                p = os.path.join(disk_dir, name)
                if name.endswith(".tmp"):
                    # crash mid-_put_disk: a phantom that could never be
                    # hit would pin disk budget until LRU-evicted
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                    continue
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, name, st.st_size))
            for _, name, size in sorted(entries):
                self._disk[name] = size
                self._disk_bytes += size

    # fids contain ',' which is filesystem-safe; keep them as file names
    def _disk_path(self, fid: str) -> str:
        return os.path.join(self.disk_dir, fid.replace("/", "_"))

    def get(self, fid: str) -> "bytes | None":
        with self._lock:
            data = self._mem.get(fid)
            if data is not None:
                self._mem.move_to_end(fid)
                self.hits += 1
                return data
            on_disk = self.disk_dir is not None and fid in self._disk
        if on_disk:
            try:
                with open(self._disk_path(fid), "rb") as f:
                    data = f.read()
            except OSError:
                with self._lock:
                    self._disk_bytes -= self._disk.pop(fid, 0)
                return None
            with self._lock:
                if fid in self._disk:
                    self._disk.move_to_end(fid)
                self.hits += 1
            self._put_mem(fid, data)  # promote
            return data
        with self._lock:
            self.misses += 1
        return None

    def put(self, fid: str, data: bytes) -> None:
        if len(data) <= self.mem_chunk_max:
            self._put_mem(fid, data)
        if self.disk_dir is not None and len(data) <= self.disk_limit:
            self._put_disk(fid, data)

    def _put_mem(self, fid: str, data: bytes) -> None:
        if len(data) > self.mem_chunk_max:
            return
        with self._lock:
            old = self._mem.pop(fid, None)
            if old is not None:
                self._mem_bytes -= len(old)
            self._mem[fid] = data
            self._mem_bytes += len(data)
            while self._mem_bytes > self.mem_limit and self._mem:
                _, evicted = self._mem.popitem(last=False)
                self._mem_bytes -= len(evicted)

    def _put_disk(self, fid: str, data: bytes) -> None:
        path = self._disk_path(fid)
        try:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            # cache tier: losing an entry to a crash just re-fetches from
            # the volume server; durability costs would defeat the cache
            os.replace(tmp, path)  # swtpu-lint: disable=rename-no-dir-fsync (cache tier)
        except OSError as e:  # cache dir full/unwritable: degrade
            log.warning("disk cache write %s: %s", fid, e)
            return
        victims = []
        with self._lock:
            self._disk_bytes -= self._disk.pop(os.path.basename(path), 0)
            self._disk[os.path.basename(path)] = len(data)
            self._disk_bytes += len(data)
            while self._disk_bytes > self.disk_limit and len(self._disk) > 1:
                name, size = self._disk.popitem(last=False)
                self._disk_bytes -= size
                victims.append(name)
        for name in victims:
            try:
                os.unlink(os.path.join(self.disk_dir, name))
            except OSError:
                pass

    def contains(self, fid: str) -> bool:
        """Lock-only containment peek: no disk read, no stats mutation —
        what the prefetcher consults before scheduling work."""
        with self._lock:
            return fid in self._mem or (self.disk_dir is not None
                                        and fid in self._disk)

    def put_mem(self, fid: str, data: bytes) -> None:
        """Seed only the memory tier (write-path seeding must not double
        local disk writes when a disk tier is configured)."""
        self._put_mem(fid, data)

    @property
    def mem_bytes(self) -> int:
        return self._mem_bytes

    @property
    def disk_bytes(self) -> int:
        return self._disk_bytes

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "mem_bytes": self._mem_bytes,
                    "mem_chunks": len(self._mem),
                    "disk_bytes": self._disk_bytes,
                    "disk_chunks": len(self._disk)}


class ReaderCache:
    """Fetch-through reads with single-flight dedup and bounded prefetch.

    `fetch(fid) -> bytes` is the upstream (volume-server GET). Readers call
    `read(fid, upcoming=[...])`: the fid is served from cache or fetched
    once (concurrent readers of the same fid share one download), and up to
    `prefetch_depth` of the upcoming fids are scheduled onto the pool so a
    sequential reader finds chunk N+1 already local when it gets there —
    reference reader_cache.go MaybeCache/ReadChunkAt.
    """

    def __init__(self, fetch, cache: ChunkCache,
                 prefetch_depth: int = 2, workers: int = 4):
        self.fetch = fetch
        self.cache = cache
        self.prefetch_depth = prefetch_depth
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="chunk-prefetch")
        self._inflight: dict[str, Future] = {}
        self._lock = threading.Lock()

    def read(self, fid: str, upcoming: "list[str] | None" = None) -> bytes:
        data = self.cache.get(fid)
        if data is None:
            data = self._fetch_once(fid)
        if upcoming:
            for nxt in upcoming[: self.prefetch_depth]:
                self._maybe_prefetch(nxt)
        return data

    def read_many(self, fids: "list[str]") -> "dict[str, bytes]":
        """Gather many fids CONCURRENTLY: cache hits answer inline, every
        cold fid fans out on the pool — a concurrent reader of the same
        fid joins the same single-flight download. The read-side window
        fan-out (iter_windows) rides this; a flight failure falls back to
        one direct fetch so a dead prefetch can't poison the window."""
        out: "dict[str, bytes]" = {}
        flights: "list[tuple[str, Future]]" = []
        for fid in dict.fromkeys(fids):
            data = self.cache.get(fid)
            if data is not None:
                out[fid] = data
                continue
            with self._lock:
                fut = self._inflight.get(fid)
                if fut is None:
                    fut = Future()
                    self._inflight[fid] = fut
                    ctx = contextvars.copy_context()
                    self._pool.submit(ctx.run, self._run_flight, fid, fut)
            flights.append((fid, fut))
        for fid, fut in flights:
            try:
                out[fid] = fut.result()
            except Exception:  # noqa: BLE001 — flight owner failed: retry
                out[fid] = self._fetch_direct(fid)
        return out

    def prefetch(self, fid: str) -> None:
        """Schedule a background fill if the fid is neither cached nor
        already in flight (the next-window hint of the read fan-out)."""
        self._maybe_prefetch(fid)

    def _timed_fetch(self, fid: str) -> bytes:
        from ..stats import FILER_CHUNK_FETCH_SECONDS, FILER_INFLIGHT_CHUNKS
        FILER_INFLIGHT_CHUNKS.add("fetch", amount=1)
        t0 = time.perf_counter()
        try:
            return self.fetch(fid)
        finally:
            FILER_INFLIGHT_CHUNKS.add("fetch", amount=-1)
            FILER_CHUNK_FETCH_SECONDS.observe(
                value=time.perf_counter() - t0)

    def _fetch_once(self, fid: str) -> bytes:
        with self._lock:
            fut = self._inflight.get(fid)
            if fut is None:
                fut = Future()
                self._inflight[fid] = fut
                owner = True
            else:
                owner = False
        if not owner:
            try:
                return fut.result()
            except Exception:  # noqa: BLE001
                # the flight owner (possibly a prefetch) failed — retry
                # on our own rather than inheriting its error
                return self._fetch_direct(fid)
        try:
            data = self._timed_fetch(fid)
            self.cache.put(fid, data)
            fut.set_result(data)
            return data
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            with self._lock:
                self._inflight.pop(fid, None)

    def _fetch_direct(self, fid: str) -> bytes:
        data = self._timed_fetch(fid)
        self.cache.put(fid, data)
        return data

    def _run_flight(self, fid: str, fut: Future) -> None:
        try:
            data = self._timed_fetch(fid)
            self.cache.put(fid, data)
            fut.set_result(data)
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)
            # a failed flight must not poison later reads (or warn at GC)
            fut.exception()
        finally:
            with self._lock:
                self._inflight.pop(fid, None)

    def _maybe_prefetch(self, fid: str) -> None:
        if self.cache.contains(fid):
            return
        with self._lock:
            if fid in self._inflight:
                return
            fut = Future()
            self._inflight[fid] = fut
        ctx = contextvars.copy_context()
        self._pool.submit(ctx.run, self._run_flight, fid, fut)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
