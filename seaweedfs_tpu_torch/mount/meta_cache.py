"""Local metadata cache synced by the filer metadata subscription.

Reference: weed/mount/meta_cache/meta_cache.go (entries cached in a
local store; meta_cache_subscribe.go applies EventNotifications from
SubscribeMetadata so cached attributes stay fresh across mounts).
Entries are cached per directory on first listing; events invalidate or
update in place.

The port's copy of seaweedfs_tpu/mount/meta_cache.py, unchanged; it
subscribes to the port's meta log, or to any filer's through a
FilerClient.
"""

from __future__ import annotations

import threading

from ..pb import filer_pb2 as fpb
from ..utils.log import logger

log = logger("mount.meta")


class MetaCache:
    def __init__(self, filer_server, subscribe: bool = True):
        self.fs = filer_server
        self._entries: dict[str, fpb.Entry] = {}   # full path -> entry
        self._listed: set[str] = set()             # directories fully cached
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sub_thread: threading.Thread | None = None
        if subscribe:
            self._start_subscription()

    # -- subscription --------------------------------------------------------
    def _start_subscription(self) -> None:
        import time

        def run():
            since = time.time_ns()
            meta_log = self.fs.filer.meta_log
            for resp in meta_log.subscribe(since, self._stop):
                try:
                    self._apply_event(resp.directory, resp.event_notification)
                except Exception as e:  # noqa: BLE001
                    log.warning("meta event apply: %s", e)

        self._sub_thread = threading.Thread(target=run, daemon=True,
                                            name="meta-cache-sub")
        self._sub_thread.start()

    def _apply_event(self, directory: str, ev: fpb.EventNotification) -> None:
        """Mirror meta_cache_subscribe.go: delete old path, upsert new."""
        with self._lock:
            if ev.HasField("old_entry") and ev.old_entry.name:
                # events carry the old parent in `directory`; renames put
                # the target dir in new_parent_path (filer.proto:183)
                old_path = self._join(directory, ev.old_entry.name)
                self._entries.pop(old_path, None)
                if ev.old_entry.is_directory:
                    # purge cached children + listing markers of the
                    # deleted/moved subtree (reference meta_cache folder
                    # deletion handling)
                    prefix = old_path.rstrip("/") + "/"
                    for p in [p for p in self._entries
                              if p.startswith(prefix)]:
                        del self._entries[p]
                    for d in [d for d in self._listed
                              if d == old_path or d.startswith(prefix)]:
                        self._listed.discard(d)
            if ev.HasField("new_entry") and ev.new_entry.name:
                new_path = self._join(ev.new_parent_path or directory,
                                      ev.new_entry.name)
                e = fpb.Entry()
                e.CopyFrom(ev.new_entry)
                self._entries[new_path] = e

    @staticmethod
    def _join(d: str, n: str) -> str:
        return (d.rstrip("/") + "/" + n) if d != "/" else "/" + n

    # -- lookups -------------------------------------------------------------
    def find(self, directory: str, name: str) -> fpb.Entry | None:
        path = self._join(directory, name)
        with self._lock:
            hit = self._entries.get(path)
            if hit is not None and not hit.hard_link_id:
                e = fpb.Entry()
                e.CopyFrom(hit)
                return e
            # hardlinked entries read through: their truth lives in the
            # shared record, which updates through OTHER names this
            # cache never sees events for (reference keys hardlinks by
            # hard_link_id for the same reason, weedfs_link.go:17)
        entry = self.fs.filer.find_entry(directory, name)
        if entry is not None:
            with self._lock:
                cached = fpb.Entry()
                cached.CopyFrom(entry)
                self._entries[path] = cached
        return entry

    def list(self, directory: str) -> list[fpb.Entry]:
        with self._lock:
            if directory in self._listed:
                prefix = directory.rstrip("/") + "/"
                out = []
                for path, e in self._entries.items():
                    if path.startswith(prefix) and "/" not in path[len(prefix):]:
                        c = fpb.Entry()
                        c.CopyFrom(e)
                        out.append(c)
                return sorted(out, key=lambda e: e.name)
        entries = list(self.fs.filer.list_entries(directory))
        with self._lock:
            for e in entries:
                cached = fpb.Entry()
                cached.CopyFrom(e)
                self._entries[self._join(directory, e.name)] = cached
            self._listed.add(directory)
        return entries

    def invalidate(self, directory: str, name: str) -> None:
        with self._lock:
            self._entries.pop(self._join(directory, name), None)
            # the directory's cached listing no longer reflects reality
            self._listed.discard(directory)

    def close(self) -> None:
        self._stop.set()
