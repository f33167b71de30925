"""Filer core: namespace CRUD over a pluggable store + event notification.

Reference: weed/filer/filer.go:57 (Filer), :188 CreateEntry (parent-dir
auto-create), :301 UpdateEntry, filer_delete_entry.go (recursive delete with
chunk GC), filer_rename.go (AtomicRenameEntry as subtree move),
filechunks.go garbage collection of replaced chunks, TTL expiry on read.

The port's copy of seaweedfs_tpu/filer/filer.py, with one difference: a
filer's signature is its store's, kept in the store's kv under
"filer.store.id" (4 bytes, big-endian; upstream filer.go
setOrLoadFilerStoreSignature keeps it the same way), so a filer restarted on
the same namespace keeps its identity. The reference draws a new signature
at every start, so a filer.sync restarted after its source filer restarts
finds no offset under the new signature and replays the source's whole
meta log.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Callable, Iterator

from ..pb import filer_pb2 as fpb
from ..utils import failpoints
from ..utils.log import logger
from .chunks import resolve_manifests, separate_manifest_chunks, total_size
from .meta_log import MetaLog
from .store import FilerStore

log = logger("filer")

ROOT = "/"
STORE_ID_KEY = b"filer.store.id"


def store_signature(store: FilerStore) -> int:
    """The store's filer signature: the one kept in its kv, else a fresh one
    that is kept there (a store without kv gets a fresh one each time)."""
    try:
        raw = store.kv_get(STORE_ID_KEY)
    except Exception as e:  # noqa: BLE001
        log.warning("filer store id unreadable (%s); a fresh signature", e)
        raw = None
    if raw and len(raw) == 4 and struct.unpack(">I", raw)[0]:
        return struct.unpack(">I", raw)[0]
    sig = (time.time_ns() & 0x7FFFFFFF) or 1
    try:
        store.kv_put(STORE_ID_KEY, struct.pack(">I", sig))
    except Exception as e:  # noqa: BLE001
        log.warning("filer store id not kept (%s)", e)
    return sig


def split_path(path: str) -> tuple[str, str]:
    path = path.rstrip("/") or "/"
    if path == "/":
        return "/", ""
    d, _, n = path.rpartition("/")
    return d or "/", n


def join_path(directory: str, name: str) -> str:
    return f"{directory.rstrip('/')}/{name}" if name else directory


class Filer:
    def __init__(self, store: FilerStore, meta_log_path: str | None = None,
                 chunk_deleter: Callable[[list[str]], None] | None = None,
                 signature: int = 0, notification_queue=None):
        self.store = store
        self.meta_log = MetaLog(meta_log_path)
        self.signature = signature or store_signature(store)
        # chunk_deleter receives file_ids of unreferenced chunks (wired to
        # operation.delete_batch by the server; no-op in unit tests)
        self.chunk_deleter = chunk_deleter or (lambda fids: None)
        # optional notification.MessageQueue fed every mutation event
        # besides the meta log (reference filer_notify.go:20-66)
        self.notification_queue = notification_queue
        # in-process mutation hooks: fn(directory, old, new); used by the
        # filer server to hot-reload /etc/seaweedfs/filer.conf
        self.mutation_hooks: list = []
        self._dir_lock = threading.RLock()  # _ensure_parents recurses
        self._hardlink_lock = threading.Lock()  # KV counter RMW atomicity
        self._chunkref_lock = threading.Lock()  # shared-chunk RMW atomicity

    # -- CRUD ---------------------------------------------------------------
    def create_entry(self, directory: str, entry: fpb.Entry,
                     o_excl: bool = False, from_other_cluster: bool = False,
                     signatures: list[int] | None = None,
                     gc_chunks: bool = True) -> None:
        """`gc_chunks=False` is the metadata-only apply the peer mesh
        uses: chunks are shared cluster-wide, and GC-ing the replaced
        version's chunks on EVERY mesh filer would delete both sides of
        a concurrent update (the origin filer already GCs once)."""
        failpoints.check("filer.create_entry")
        if not entry.attributes.crtime:
            entry.attributes.crtime = int(time.time())
        if not entry.attributes.mtime:
            entry.attributes.mtime = int(time.time())
        self._ensure_parents(directory)
        old = self.store.find_entry(directory, entry.name)
        if old is not None and o_excl:
            raise FileExistsError(join_path(directory, entry.name))
        self.store.insert_entry(directory, entry)
        if old is not None:
            if old.hard_link_id:
                # overwriting ONE name of a hardlink set = unlink: the
                # shared chunks belong to the remaining links
                self._unlink_shared(old, is_delete_data=gc_chunks)
            elif gc_chunks:
                self._gc_replaced_chunks(old, entry)
        self._notify(directory, old, entry, delete_chunks=old is not None,
                     from_other_cluster=from_other_cluster,
                     signatures=signatures)

    def _ensure_parents(self, directory: str) -> None:
        if directory == "/":
            return
        parent, name = split_path(directory)
        if self.store.find_entry(parent, name) is not None:
            return
        with self._dir_lock:
            if self.store.find_entry(parent, name) is not None:
                return
            self._ensure_parents(parent)
            e = fpb.Entry(name=name, is_directory=True)
            e.attributes.crtime = e.attributes.mtime = int(time.time())
            e.attributes.file_mode = 0o40755
            self.store.insert_entry(parent, e)
            self._notify(parent, None, e)

    def update_entry(self, directory: str, entry: fpb.Entry,
                     from_other_cluster: bool = False,
                     signatures: list[int] | None = None,
                     gc_chunks: bool = True,
                     touch_mtime: bool = True) -> None:
        """touch_mtime=False is for metadata-only updates (xattr, chmod):
        POSIX says those change ctime, not mtime."""
        failpoints.check("filer.update_entry")
        old = self.store.find_entry(directory, entry.name)
        if old is None:
            raise FileNotFoundError(join_path(directory, entry.name))
        if touch_mtime:
            entry.attributes.mtime = int(time.time())
        if old.hard_link_id:
            # write-through: EVERY link sees the new content; the counter
            # stays authoritative in the shared record
            with self._hardlink_lock:
                key = self._hardlink_key(old.hard_link_id)
                raw = self.store.kv_get(key)
                counter = 1
                resolved_old = old
                if raw:
                    meta = fpb.Entry()
                    meta.ParseFromString(raw)
                    counter = meta.hard_link_counter
                    resolved_old = meta
                entry.hard_link_id = bytes(old.hard_link_id)
                entry.hard_link_counter = counter
                self.store.kv_put(key, entry.SerializeToString())
                self.store.update_entry(directory, entry)
            if gc_chunks:
                self._gc_replaced_chunks(resolved_old, entry)
        else:
            self.store.update_entry(directory, entry)
            if gc_chunks:
                self._gc_replaced_chunks(old, entry)
        self._notify(directory, old, entry, delete_chunks=True,
                     from_other_cluster=from_other_cluster,
                     signatures=signatures)

    def append_chunks(self, directory: str, name: str,
                      chunks: list[fpb.FileChunk]) -> fpb.Entry:
        entry = self.store.find_entry(directory, name)
        if entry is None:
            entry = fpb.Entry(name=name)
            entry.attributes.crtime = int(time.time())
            self._ensure_parents(directory)
        offset = total_size(entry.chunks)
        for c in chunks:
            c.offset = offset
            offset += c.size
            entry.chunks.append(c)
        entry.attributes.mtime = int(time.time())
        entry.attributes.file_size = offset
        self.store.insert_entry(directory, entry)
        self._notify(directory, None, entry)
        return entry

    def find_entry(self, directory: str, name: str) -> fpb.Entry | None:
        if directory == "/" and not name:
            e = fpb.Entry(name="/", is_directory=True)
            e.attributes.file_mode = 0o40755
            return e
        entry = self.store.find_entry(directory, name)
        if entry is None:
            return None
        if self._expired(entry):
            log.info("ttl-expired entry %s", join_path(directory, name))
            self.delete_entry(directory, name, is_delete_data=True)
            return None
        return self._resolve_hardlink(entry)

    # -- hardlinks (reference filerstore_hardlink.go) ----------------------
    # Linked files share ONE metadata record in the store's KV space keyed
    # by hard_link_id; each directory entry is a pointer carrying the id.
    # The counter lives in the shared record; chunks are GC'd only when the
    # last link goes.
    _HARDLINK_PREFIX = b"hardlink/"

    def _hardlink_key(self, hid: bytes) -> bytes:
        return self._HARDLINK_PREFIX + bytes(hid)

    def _resolve_hardlink(self, entry: fpb.Entry) -> fpb.Entry:
        if not entry.hard_link_id:
            return entry
        raw = self.store.kv_get(self._hardlink_key(entry.hard_link_id))
        if raw is None:
            return entry
        meta = fpb.Entry()
        meta.ParseFromString(raw)
        meta.name = entry.name
        return meta

    def _unlink_shared(self, entry: fpb.Entry, is_delete_data: bool) -> None:
        """Drop one reference to a shared hardlink record; GC chunks only
        when the LAST link goes (counter RMW under the hardlink lock)."""
        with self._hardlink_lock:
            key = self._hardlink_key(entry.hard_link_id)
            raw = self.store.kv_get(key)
            if not raw:
                return
            meta = fpb.Entry()
            meta.ParseFromString(raw)
            meta.hard_link_counter -= 1
            last = meta.hard_link_counter <= 0
            self.store.kv_put(key, b"" if last
                              else meta.SerializeToString())
        if last and is_delete_data:
            self._delete_entry_chunks(meta)

    def link(self, old_dir: str, old_name: str, new_dir: str,
             new_name: str) -> fpb.Entry:
        """Create a hardlink: both names share chunks + attributes."""
        import os as _os
        with self._hardlink_lock:
            src = self.store.find_entry(old_dir, old_name)
            if src is None:
                raise FileNotFoundError(join_path(old_dir, old_name))
            if src.is_directory:
                raise IsADirectoryError(join_path(old_dir, old_name))
            if self.store.find_entry(new_dir, new_name) is not None:
                # never clobber: an overwrite here would orphan the old
                # entry's chunks (and strand a hardlink set's counter)
                raise FileExistsError(join_path(new_dir, new_name))
            if not src.hard_link_id:
                # first link: move the metadata into the shared record
                src_before = fpb.Entry()
                src_before.CopyFrom(src)
                src.hard_link_id = _os.urandom(16)
                src.hard_link_counter = 1
                self.store.kv_put(self._hardlink_key(src.hard_link_id),
                                  src.SerializeToString())
                self.store.update_entry(old_dir, src)
                # announce the source's mutation: peer mounts must learn
                # it became a hardlink pointer or their caches serve the
                # pre-link record forever
                self._notify(old_dir, src_before, src)
            meta = fpb.Entry()
            meta.ParseFromString(
                self.store.kv_get(self._hardlink_key(src.hard_link_id)))
            meta.hard_link_counter += 1
            self.store.kv_put(self._hardlink_key(src.hard_link_id),
                              meta.SerializeToString())
            new_entry = fpb.Entry()
            new_entry.CopyFrom(meta)
            new_entry.name = new_name
        self._ensure_parents(new_dir)
        self.store.insert_entry(new_dir, new_entry)
        self._notify(new_dir, None, new_entry)
        return self._resolve_hardlink(new_entry)

    @staticmethod
    def _expired(entry: fpb.Entry) -> bool:
        ttl = entry.attributes.ttl_sec
        return bool(ttl) and entry.attributes.mtime + ttl < time.time()  # swtpu-lint: disable=wallclock-duration (mtime is persisted wall-clock)

    def list_entries(self, directory: str, start_from: str = "",
                     inclusive: bool = False, limit: int = 2**31,
                     prefix: str = "") -> Iterator[fpb.Entry]:
        for e in self.store.list_entries(directory, start_from, inclusive,
                                         limit, prefix):
            if not self._expired(e):
                yield e

    def delete_entry(self, directory: str, name: str,
                     is_delete_data: bool = True, is_recursive: bool = False,
                     from_other_cluster: bool = False,
                     signatures: list[int] | None = None) -> None:
        failpoints.check("filer.delete_entry")
        entry = self.store.find_entry(directory, name)
        if entry is None:
            return
        path = join_path(directory, name)
        if entry.is_directory:
            children = list(self.store.list_entries(path, limit=2))
            if children and not is_recursive:
                raise OSError(f"{path} is a non-empty folder")
            self._delete_subtree(path, is_delete_data)
            self.store.delete_entry(directory, name)
        else:
            # entry FIRST, chunks SECOND: copy-by-reference re-checks the
            # source entry after adopting refcounts — entry-still-present
            # must imply no release has started, or a racing delete can
            # free blobs the copy just adopted
            self.store.delete_entry(directory, name)
            if entry.hard_link_id:
                self._unlink_shared(entry, is_delete_data)
            elif is_delete_data:
                self._delete_entry_chunks(entry)
        self._notify(directory, entry, None, delete_chunks=is_delete_data,
                     from_other_cluster=from_other_cluster,
                     signatures=signatures)

    def _delete_subtree(self, path: str, is_delete_data: bool) -> None:
        for child in list(self.store.list_entries(path)):
            cpath = join_path(path, child.name)
            if child.is_directory:
                self._delete_subtree(cpath, is_delete_data)
            else:
                # same entry-first ordering as delete_entry: a child
                # still visible in the store must imply its chunk
                # release hasn't started (copy-by-reference re-checks
                # the source after adopting refcounts)
                self.store.delete_entry(path, child.name)
                if child.hard_link_id:
                    self._unlink_shared(child, is_delete_data)
                elif is_delete_data:
                    self._delete_entry_chunks(child)
        self.store.delete_folder_children(path)

    def _delete_entry_chunks(self, entry: fpb.Entry) -> None:
        fids = [c.file_id for c in entry.chunks if c.file_id]
        dead = self._release_chunks(fids)
        if dead:
            self.chunk_deleter(dead)

    def _gc_replaced_chunks(self, old: fpb.Entry, new: fpb.Entry) -> None:
        """Delete chunks referenced by old but not by new (filechunks.go
        MinusChunks)."""
        keep = {c.file_id for c in new.chunks}
        dropped = [c.file_id for c in old.chunks
                   if c.file_id and c.file_id not in keep]
        dead = self._release_chunks(dropped)
        if dead:
            self.chunk_deleter(dead)

    # -- shared-chunk refcounts (S3 server-side copy-by-reference) ----------
    # A copied object clones the source's FileChunk list instead of moving
    # bytes through the gateway; the blobs are then owned by MORE than one
    # entry, and the naive fid GC above would delete the copy's data when
    # the source dies. The KV record counts EXTRA references beyond the
    # first (absent record = sole owner); every GC path consumes a
    # reference before physically deleting.
    _CHUNKREF_PREFIX = b"chunkref/"

    def adopt_chunks(self, fids: "list[str]") -> None:
        """One more entry now references these fids (call BEFORE the
        cloning entry is created, so a crash leaks a refcount — harmless
        — rather than double-freeing a live chunk)."""
        with self._chunkref_lock:
            for fid in fids:
                if not fid:
                    continue
                key = self._CHUNKREF_PREFIX + fid.encode()
                raw = self.store.kv_get(key)
                n = int(raw) if raw else 0
                self.store.kv_put(key, str(n + 1).encode())

    def release_chunks(self, fids: "list[str]") -> None:
        """Drop one reference per fid and physically delete the ones
        whose last reference went (the rollback half of adopt_chunks)."""
        dead = self._release_chunks(fids)
        if dead:
            self.chunk_deleter(dead)

    def _release_chunks(self, fids: "list[str]") -> "list[str]":
        """Consume one reference per fid; returns the fids now safe to
        physically delete (no surviving cloned entry references them)."""
        dead: "list[str]" = []
        with self._chunkref_lock:
            for fid in fids:
                if not fid:
                    continue
                key = self._CHUNKREF_PREFIX + fid.encode()
                raw = self.store.kv_get(key)
                n = int(raw) if raw else 0
                if n <= 0:
                    dead.append(fid)
                else:
                    # the empty value is the store's deletion idiom
                    # (see _unlink_shared)
                    self.store.kv_put(key, str(n - 1).encode()
                                      if n > 1 else b"")
        return dead

    # -- rename (reference filer_rename.go / AtomicRenameEntry) -------------
    def rename(self, old_dir: str, old_name: str, new_dir: str,
               new_name: str) -> None:
        failpoints.check("filer.rename")
        entry = self.store.find_entry(old_dir, old_name)
        if entry is None:
            raise FileNotFoundError(join_path(old_dir, old_name))
        if self.store.find_entry(new_dir, new_name) is not None:
            raise FileExistsError(join_path(new_dir, new_name))
        self._ensure_parents(new_dir)
        self._move_entry(old_dir, entry, new_dir, new_name)

    def _move_entry(self, old_dir: str, entry: fpb.Entry, new_dir: str,
                    new_name: str) -> None:
        old_path = join_path(old_dir, entry.name)
        moved = fpb.Entry()
        moved.CopyFrom(entry)
        moved.name = new_name
        self.store.insert_entry(new_dir, moved)
        if entry.is_directory:
            new_path = join_path(new_dir, new_name)
            for child in list(self.store.list_entries(old_path)):
                self._move_entry(old_path, child, new_path, child.name)
        self.store.delete_entry(old_dir, entry.name)
        self._notify(old_dir, entry, moved, delete_chunks=False,
                     new_parent_path=new_dir)

    # -- events -------------------------------------------------------------
    def _notify(self, directory: str, old: fpb.Entry | None,
                new: fpb.Entry | None, delete_chunks: bool = False,
                from_other_cluster: bool = False,
                signatures: list[int] | None = None,
                new_parent_path: str = "") -> None:
        ev = fpb.EventNotification(delete_chunks=delete_chunks,
                                   is_from_other_cluster=from_other_cluster,
                                   new_parent_path=new_parent_path)
        if old is not None:
            ev.old_entry.CopyFrom(old)
        if new is not None:
            ev.new_entry.CopyFrom(new)
        for s in signatures or []:
            ev.signatures.append(s)
        ev.signatures.append(self.signature)
        for hook in self.mutation_hooks:
            try:
                hook(directory, old, new, new_parent_path)
            except Exception as e:  # noqa: BLE001 — hooks must not break writes
                log.warning("mutation hook %s: %s", hook, e)
        self.meta_log.append(directory, ev)
        if self.notification_queue is not None:
            name = (new.name if new is not None
                    else old.name if old is not None else "")
            key = join_path(directory, name) if name else directory
            try:
                self.notification_queue.send(key, ev)
            except Exception as e:  # noqa: BLE001
                log.warning("notification send %s: %s", key, e)

    # -- manifest support ---------------------------------------------------
    def data_chunks(self, entry: fpb.Entry,
                    fetch: Callable[[str], bytes]) -> list[fpb.FileChunk]:
        manifests, _ = separate_manifest_chunks(entry.chunks)
        if not manifests:
            return list(entry.chunks)
        return resolve_manifests(entry.chunks, fetch)

    def close(self) -> None:
        self.meta_log.close()
        self.store.close()
