"""Continuous filer-to-filer sync (reference command/filer_sync.go).

Subscribes to the source filer's metadata stream and replays every
mutation into the target through a FilerSink. Loop prevention follows
the reference: each filer stamps events with its signature; a sync
worker drops events that already carry the *target's* signature (they
originated there — command/filer_sync.go excludeSignatures). Offsets
persist in the target's KV store so restarts resume
(track_sync_offset-style).

The port's copy of seaweedfs_tpu/replication/filer_sync.py, unchanged: it
runs over an in-process FilerServer or a FilerClient of either package, and
keeps its offset in the target's store kv (`sync.offset.<source sig>`, the
reference's key and encoding), so a restarted sync of either package
resumes where the other stopped.
"""

from __future__ import annotations

import struct
import threading

from ..utils.log import logger
from .replicator import Replicator
from .sink import FilerSink

log = logger("filer.sync")


class FilerSync:
    def __init__(self, source_fs, target_fs, path_prefix: str = "/",
                 from_ns: int | None = None, max_retries: int = 5,
                 retry_base_delay: float = 0.2):
        self.source = source_fs
        self.target = target_fs
        self.prefix = path_prefix
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        sink = FilerSink(target_fs)
        self.replicator = Replicator(sink, self._read_source_data,
                                     path_prefix)
        self._offset_key = (
            f"sync.offset.{self.source.filer.signature}".encode())
        self.from_ns = (self._load_offset() if from_ns is None else from_ns)
        self.applied = 0
        self.skipped = 0
        self.dead_lettered = 0
        self.max_retries = max_retries
        self.retry_base_delay = retry_base_delay

    # -- offsets (reference persists per-peer offsets in store KV) ----------
    def _load_offset(self) -> int:
        try:
            raw = self.target.filer.store.kv_get(self._offset_key)
            if raw:
                return struct.unpack("<q", raw)[0]
        except Exception as e:  # noqa: BLE001
            # a silent fallback here replays the WHOLE journal from 0 —
            # that is correct (sync is idempotent) but never invisible
            log.warning("sync offset read failed (%s); replaying from 0", e)
        return 0

    def _save_offset(self, ts_ns: int) -> None:
        try:
            self.target.filer.store.kv_put(self._offset_key,
                                           struct.pack("<q", ts_ns))
        except Exception as e:  # noqa: BLE001
            log.warning("offset save: %s", e)

    def _read_source_data(self, entry) -> bytes:
        return self.source.read_entry_bytes(entry)

    # -- run -----------------------------------------------------------------
    def start(self) -> "FilerSync":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="filer-sync")
        self._thread.start()
        return self

    def _run(self) -> None:
        target_sig = self.target.filer.signature
        for resp in self.source.filer.meta_log.subscribe(self.from_ns,
                                                         self._stop):
            ev = resp.event_notification
            if target_sig in ev.signatures:
                self.skipped += 1  # originated at the target: loop guard
                if resp.ts_ns:
                    self._save_offset(resp.ts_ns)
                continue
            # Retry with backoff and only advance the offset once the event
            # applied (the reference filer.sync re-processes the event and
            # persists the offset after success) — saving early would skip
            # the mutation forever after a restart.
            applied = False
            for attempt in range(self.max_retries):
                try:
                    self.replicator.replicate(resp.directory, ev)
                    applied = True
                    break
                except Exception as e:  # noqa: BLE001
                    log.warning("sync apply %s (try %d/%d): %s",
                                resp.directory, attempt + 1,
                                self.max_retries, e)
                    if attempt + 1 >= self.max_retries:
                        break  # no point sleeping before the dead-letter
                    if self._stop.wait(self.retry_base_delay * 2 ** attempt):
                        return
            if applied:
                self.applied += 1
            else:
                # dead-letter explicitly: log loudly and move on so one
                # poisoned event can't wedge the stream forever
                self.dead_lettered += 1
                log.error("sync DEAD-LETTER %s after %d tries",
                          resp.directory, self.max_retries)
            if resp.ts_ns:
                self._save_offset(resp.ts_ns)

    def stop(self) -> None:
        self._stop.set()
