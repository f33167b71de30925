"""Filer metadata event log: every mutation appended, replayable, tailable.

Reference: weed/filer/filer_notify.go:20-116 (NotifyUpdateEvent →
util/log_buffer → dated files under /topics/.system/log, replayed by
SubscribeMetadata) and util/log_buffer/log_buffer.go:53. Re-designed as one
length-prefixed pb log file + an in-memory tail window and a condition
variable for live subscribers, instead of the reference's paged buffer.

The port's copy of seaweedfs_tpu/filer/meta_log.py, unchanged: a log written
by either package replays in the other.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from collections import deque

from ..pb import filer_pb2 as fpb
from ..utils import fsutil
from ..utils.log import logger

log = logger("meta-log")

_HDR = struct.Struct("<QI")  # ts_ns, blob length


class MetaLog:
    def __init__(self, path: str | None, tail_window: int = 4096):
        self._path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "ab")
        self._tail: deque[tuple[int, bytes]] = deque(maxlen=tail_window)
        self._cond = threading.Condition()
        self._last_ts = 0
        # highest ts ever evicted from the bounded tail: a live subscriber
        # whose `last` is behind this has a GAP the deque can no longer
        # serve and must re-read the persisted log (subscribe())
        self._evicted_ts = 0
        # bumped by purge(): the file was rewritten, so subscribers'
        # incremental read cursors into it are invalid
        self._purge_gen = 0

    def append(self, directory: str, ev: fpb.EventNotification) -> int:
        resp = fpb.SubscribeMetadataResponse(directory=directory,
                                             event_notification=ev)
        with self._cond:
            ts = max(time.time_ns(), self._last_ts + 1)  # strictly monotonic
            self._last_ts = ts
            resp.ts_ns = ts
            blob = resp.SerializeToString()
            if self._f:
                self._f.write(_HDR.pack(ts, len(blob)))
                self._f.write(blob)
                self._f.flush()
            if len(self._tail) == self._tail.maxlen:
                self._evicted_ts = self._tail[0][0]
            self._tail.append((ts, blob))
            self._cond.notify_all()
        return ts

    def purge(self, before_ns: int) -> int:
        """Drop persisted events older than `before_ns` (shell
        fs.log.purge; the reference deletes dated log files under
        /topics/.system/log the same way, command_fs_log_purge.go).
        Returns the number of purged records."""
        if not self._path or not os.path.exists(self._path):
            return 0
        with self._cond:
            # single streaming pass straight into the replacement file:
            # O(1) memory, and the (unavoidable) lock hold is one
            # read+write sweep, not two passes plus a buffered list
            dropped = 0
            tmp = self._path + ".tmp"
            with open(self._path, "rb") as src, open(tmp, "wb") as dst:
                while True:
                    hdr = src.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    ts, ln = _HDR.unpack(hdr)
                    blob = src.read(ln)
                    if len(blob) < ln:
                        break
                    if ts < before_ns:
                        dropped += 1
                    else:
                        dst.write(hdr + blob)
                dst.flush()
                os.fsync(dst.fileno())
            if not dropped:
                os.unlink(tmp)
                return 0
            if self._f:
                self._f.close()
            os.replace(tmp, self._path)
            # subscribers resume from offsets into the purged file; if a
            # crash rolled the rename back they would replay pre-purge
            # bytes at those offsets — pin the swap before handing out
            # positions from the new generation
            fsutil.fsync_dir(self._path)
            self._purge_gen += 1
            if self._f:
                self._f = open(self._path, "ab")
            return dropped

    def _read_persisted(self, since_ns: int, start_pos: int = 0
                        ) -> tuple[list[tuple[int, bytes]], int]:
        """Events with ts > since_ns from byte `start_pos` on; returns
        (events, end_pos) so lagging subscribers re-scan incrementally
        instead of the whole file per poll."""
        if not self._path or not os.path.exists(self._path):
            return [], start_pos
        out = []
        with open(self._path, "rb") as f:
            f.seek(start_pos)
            pos = start_pos
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                ts, ln = _HDR.unpack(hdr)
                blob = f.read(ln)
                if len(blob) < ln:
                    break  # torn tail
                pos = f.tell()
                if ts > since_ns:
                    out.append((ts, blob))
        return out, pos

    def subscribe(self, since_ns: int, stop: threading.Event,
                  poll_s: float = 0.2):
        """Yield SubscribeMetadataResponse from since_ns (exclusive), then
        tail live until stop is set (reference ReadPersistedLogBuffer +
        LoopProcessLogData)."""
        last = since_ns
        oldest_tail = self._tail[0][0] if self._tail else None
        if self._path is None or (oldest_tail is not None and last + 1 >= oldest_tail):
            backlog = [(t, b) for t, b in list(self._tail) if t > last]
        else:  # tail window may have dropped (or never seen) older events
            backlog, _ = self._read_persisted(last)
        for ts, blob in backlog:
            resp = fpb.SubscribeMetadataResponse()
            resp.ParseFromString(blob)
            yield resp
            last = ts
        warned_gap = False
        file_pos = 0  # incremental gap-read cursor into the persisted log
        file_gen = self._purge_gen
        while not stop.is_set():
            with self._cond:
                fresh = [(t, b) for t, b in list(self._tail) if t > last]
                if not fresh and last >= self._evicted_ts:
                    self._cond.wait(timeout=poll_s)
                    fresh = [(t, b) for t, b in list(self._tail) if t > last]
                # recompute AFTER any wait: a burst larger than the tail
                # window during the wait must not be silently skipped
                gap = last < self._evicted_ts
            if gap:
                # a burst overflowed the bounded tail while this
                # subscriber lagged: the deque can no longer serve the
                # backlog. Re-read the persisted log (appends flush
                # before entering the tail, so it is complete up to now),
                # resuming from the last scan's file offset — a purge
                # rewrites the file, so its generation resets the cursor.
                if self._path is not None:
                    if file_gen != self._purge_gen:
                        file_pos, file_gen = 0, self._purge_gen
                    fresh, file_pos = self._read_persisted(
                        last, start_pos=file_pos)
                else:
                    if not warned_gap:
                        warned_gap = True
                        log.warning(
                            "meta tail window overflowed a memory-only "
                            "log: a lagging subscriber lost events "
                            "before %d (persist the log or raise "
                            "tail_window)", self._evicted_ts)
                    # the lost events are unrecoverable: advance past the
                    # gap or this loop spins at 100% CPU re-detecting it
                    # (the cv wait above only engages once last catches up
                    # to the evicted watermark)
                    last = max(last, self._evicted_ts)
            for ts, blob in fresh:
                # re-check per event: a stopped subscriber must not keep
                # consuming (a "stopped" FilerSync would still replicate)
                if stop.is_set():
                    return
                resp = fpb.SubscribeMetadataResponse()
                resp.ParseFromString(blob)
                yield resp
                last = ts

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
