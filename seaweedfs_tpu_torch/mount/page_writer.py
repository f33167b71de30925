"""Write-back page cache: chunk-granular dirty pages + upload pipeline.

Reference: weed/mount/page_writer.go:22 (PageWriter), dirty_pages_chunked.go
(ChunkedDirtyPages), page_writer/page_chunk_mem.go / page_chunk_swapfile.go
(memory vs swap-file backing), page_writer/upload_pipeline.go (sealed
chunks upload concurrently while writes continue), activity_score.go
(sequential-vs-random scoring decides mem vs swap backing).

The port's copy of seaweedfs_tpu/mount/page_writer.py, unchanged. The
saver it is given uploads through the port's filer or FilerClient.
"""

from __future__ import annotations

import os
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

from ..utils.log import logger

log = logger("mount.pages")


class ActivityScore:
    """Sequential-writes score (reference page_writer/activity_score.go):
    monotonically increasing offsets raise it, seeks lower it. Sequential
    streams early-seal full chunks and stay in memory; a low score
    (random IO) with many live partial chunks spills to swap files."""

    def __init__(self):
        self._last_offset = -1
        self.score = 0

    def track(self, offset: int) -> None:
        if offset >= self._last_offset:
            self.score = min(self.score + 1, 64)
        else:
            self.score = max(self.score - 8, -64)
        self._last_offset = offset

    @property
    def is_sequential(self) -> bool:
        return self.score >= 16


class MemChunk:
    """In-memory page chunk (page_chunk_mem.go)."""

    def __init__(self, chunk_size: int):
        self.buf = bytearray(chunk_size)
        self.intervals: list[tuple[int, int]] = []  # sorted, merged

    def write(self, at: int, data: bytes) -> None:
        self.buf[at:at + len(data)] = data
        self._add_interval(at, at + len(data))

    def read(self, at: int, size: int) -> bytes:
        return bytes(self.buf[at:at + size])

    def _add_interval(self, start: int, stop: int) -> None:
        merged = []
        for s, e in self.intervals:
            if e < start or s > stop:
                merged.append((s, e))
            else:
                start, stop = min(s, start), max(e, stop)
        merged.append((start, stop))
        self.intervals = sorted(merged)

    @property
    def written(self) -> int:
        return sum(e - s for s, e in self.intervals)

    def content(self) -> bytes:
        """Contiguous content from 0 to max written offset (holes zero)."""
        if not self.intervals:
            return b""
        return bytes(self.buf[:self.intervals[-1][1]])

    def destroy(self) -> None:
        self.buf = bytearray(0)


class SwapFileChunk(MemChunk):
    """Disk-backed chunk for big sequential streams
    (page_chunk_swapfile.go); keeps RSS flat while a large file uploads."""

    def __init__(self, chunk_size: int, swap_dir: str | None = None):
        self.chunk_size = chunk_size
        fd, self._path = tempfile.mkstemp(prefix="swtpu-swap-",
                                          dir=swap_dir, suffix=".chunk")
        self._f = os.fdopen(fd, "r+b")
        self._f.truncate(chunk_size)
        self.intervals = []

    def write(self, at: int, data: bytes) -> None:
        self._f.seek(at)
        self._f.write(data)
        self._add_interval(at, at + len(data))

    def read(self, at: int, size: int) -> bytes:
        self._f.seek(at)
        return self._f.read(size)

    def content(self) -> bytes:
        if not self.intervals:
            return b""
        self._f.seek(0)
        return self._f.read(self.intervals[-1][1])

    def destroy(self) -> None:
        try:
            self._f.close()
            os.unlink(self._path)
        except OSError:
            pass


class UploadPipeline:
    """Concurrent sealed-chunk uploader (upload_pipeline.go): sealed
    chunks go to a worker pool; writers keep filling newer chunks.
    `saver(data, logical_offset) -> result` runs on workers; flush()
    drains and returns results ordered by logical offset.

    Backpressure: at most 2x concurrency uploads may be queued or
    running — submit() blocks past that, so a writer streaming faster
    than the uploads drain cannot accumulate the whole file in memory
    (the reference bounds its pipeline the same way). In-flight bytes
    stay readable via read_at until flush() hands the results to the
    caller (reference MaybeReadDataAt on sealed chunks)."""

    def __init__(self, saver: Callable[[bytes, int], object],
                 concurrency: int = 8):
        self._saver = saver
        self._pool = ThreadPoolExecutor(max_workers=concurrency,
                                        thread_name_prefix="upload")
        self._slots = threading.BoundedSemaphore(concurrency * 2)
        self._pending: list[tuple[int, Future]] = []
        self._inflight: dict[int, bytes] = {}  # logical_offset -> data
        self._lock = threading.Lock()

    def submit(self, data: bytes, logical_offset: int) -> None:
        import time as _time
        self._slots.acquire()
        with self._lock:
            self._inflight[logical_offset] = data
        # submit-order timestamp: uploads finish out of order on the
        # worker pool, but newest-chunk-wins resolution must follow
        # write order, not completion order
        ts_ns = _time.time_ns()

        def run():
            try:
                result = self._saver(data, logical_offset)
                if hasattr(result, "modified_ts_ns"):
                    result.modified_ts_ns = ts_ns
                return result
            finally:
                self._slots.release()

        fut = self._pool.submit(run)
        with self._lock:
            self._pending.append((logical_offset, fut))

    def read_at(self, offset: int, size: int) -> list[tuple[int, bytes]]:
        """Overlap of [offset, offset+size) with sealed-but-unmerged data."""
        out = []
        with self._lock:
            for base, data in self._inflight.items():
                lo = max(offset, base)
                hi = min(offset + size, base + len(data))
                if lo < hi:
                    out.append((lo, data[lo - base:hi - base]))
        return out

    def flush(self) -> list[object]:
        """Drain pending uploads. In-flight copies stay readable until
        the caller has merged the results into the file entry and calls
        commit() — dropping them here would open a window where the data
        is in neither the entry nor the overlay."""
        with self._lock:
            pending, self._pending = self._pending, []
            self._flushed_offsets = [off for off, _ in pending]
        results = []
        errors = []
        for off, fut in sorted(pending, key=lambda t: t[0]):
            try:
                results.append(fut.result())
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        if errors:
            raise errors[0]
        return results

    def commit(self) -> None:
        """Caller merged the flushed chunks into the entry; drop copies."""
        with self._lock:
            for off in getattr(self, "_flushed_offsets", []):
                self._inflight.pop(off, None)
            self._flushed_offsets = []

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class ChunkedDirtyPages:
    """Dirty pages of one open file, chunk_size-granular
    (dirty_pages_chunked.go:41). Writes land in page chunks; a chunk
    that is fully covered seals early to the pipeline (so huge streams
    don't hold memory); flush seals the rest and drains the pipeline."""

    def __init__(self, chunk_size: int, saver: Callable[[bytes, int], object],
                 concurrency: int = 8, swap_dir: str | None = None,
                 swap_threshold_chunks: int = 16):
        self.chunk_size = chunk_size
        self._chunks: dict[int, MemChunk] = {}
        self._pipeline = UploadPipeline(saver, concurrency)
        self._activity = ActivityScore()
        self._swap_dir = swap_dir
        self._swap_threshold = swap_threshold_chunks
        self._lock = threading.Lock()
        self.dirty = False

    def _backing(self) -> type:
        # Random IO keeps many partially-written chunks alive (nothing
        # gets full enough to early-seal); spill those to disk. A
        # sequential stream seals chunks as it goes, so it never
        # accumulates live chunks and stays in memory.
        if (not self._activity.is_sequential
                and len(self._chunks) >= self._swap_threshold):
            return SwapFileChunk
        return MemChunk

    def write(self, offset: int, data: bytes) -> None:
        self.dirty = True
        with self._lock:
            self._activity.track(offset)
            pos = 0
            while pos < len(data):
                logical = offset + pos
                ci, at = divmod(logical, self.chunk_size)
                n = min(self.chunk_size - at, len(data) - pos)
                chunk = self._chunks.get(ci)
                if chunk is None:
                    cls = self._backing()
                    chunk = (cls(self.chunk_size, self._swap_dir)
                             if cls is SwapFileChunk
                             else cls(self.chunk_size))
                    self._chunks[ci] = chunk
                chunk.write(at, data[pos:pos + n])
                pos += n
                # early-seal full chunks behind the write frontier
                if chunk.written == self.chunk_size:
                    self._seal(ci)

    def _seal(self, ci: int) -> None:
        """Upload each contiguous dirty interval separately (reference
        dirty_pages_chunked.go saveChunkedFileIntervalToStorage) — holes
        must NOT be zero-filled or they'd clobber underlying file data."""
        chunk = self._chunks.pop(ci, None)
        if chunk is None or not chunk.intervals:
            return
        base = ci * self.chunk_size
        for s, e in chunk.intervals:
            self._pipeline.submit(chunk.read(s, e - s), base + s)
        chunk.destroy()

    def read(self, offset: int, size: int) -> list[tuple[int, bytes]]:
        """Unflushed dirty ranges overlapping [offset, offset+size):
        [(logical_offset, data)] — overlaid on top of stored chunks for
        read-your-writes. Sealed in-flight uploads come first so live
        (newer) writes win when the caller applies overlays in order."""
        out = self._pipeline.read_at(offset, size)
        with self._lock:
            first = offset // self.chunk_size
            last = (offset + size - 1) // self.chunk_size
            for ci in range(first, last + 1):
                chunk = self._chunks.get(ci)
                if chunk is None:
                    continue
                base = ci * self.chunk_size
                for s, e in chunk.intervals:
                    lo = max(offset, base + s)
                    hi = min(offset + size, base + e)
                    if lo < hi:
                        out.append((lo, chunk.read(lo - base, hi - lo)))
        return out

    def flush(self) -> list[object]:
        """Seal everything, drain the pipeline, return saver results.
        Call commit() once the results are merged into the file entry."""
        with self._lock:
            for ci in sorted(self._chunks):
                self._seal(ci)
        results = self._pipeline.flush()
        self.dirty = False
        return results

    def commit(self) -> None:
        self._pipeline.commit()

    def destroy(self) -> None:
        with self._lock:
            for c in self._chunks.values():
                c.destroy()
            self._chunks.clear()
        self._pipeline.shutdown()
