"""WeedFS: the filesystem facade whose methods map 1:1 to FUSE callbacks.

Reference: weed/mount/weedfs.go (WFS), weedfs_file_write.go:37 (Write ->
dirty pages), weedfs_file_sync.go:92 (doFlush: upload pipeline drain +
CreateEntry/UpdateEntry with the merged chunk list), weedfs_file_read.go
(read via chunk views overlaid with dirty pages), weedfs_dir*.go
(mkdir/readdir/unlink), weedfs_attr.go (getattr/setattr incl truncate),
weedfs_rename.go.

File handles keep per-open state (ChunkedDirtyPages). Reads merge the
stored chunk views with unflushed dirty ranges for read-your-writes.

Op-table coverage vs the reference mount: weedfs_symlink.go,
weedfs_xattr.go, weedfs_link.go, weedfs_attr.go (chmod/chown/utimens)
are all implemented. weedfs_file_copy_range.go and weedfs_file_lseek.go
(copy_file_range, SEEK_HOLE/SEEK_DATA) have NO slots in the libfuse 2.9
ABI this binding targets (fuse_operations ends at fallocate; both are
fuse3 additions), so the kernel transparently falls back to read/write
copies and data-only seeks — correct results, without the offload.

The port's copy of seaweedfs_tpu/mount/weedfs.py, unchanged. It runs over
the port's FilerServer in process or over a FilerClient of the port, whose
read of an uncached remote-mounted entry reads the remote through (the
reference's FilerClient returns zeros of the entry's size there).
"""

from __future__ import annotations

import os
import stat as stat_mod
import threading
import time

from ..filer.chunks import read_views, total_size
from ..pb import filer_pb2 as fpb
from ..utils.log import logger
from .inode_map import ROOT_INODE, InodeToPath
from .meta_cache import MetaCache
from .page_writer import ChunkedDirtyPages

log = logger("mount.weedfs")


class FuseError(OSError):
    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(errno_, msg or os.strerror(errno_))


class FileHandle:
    def __init__(self, fh: int, path: str, entry: fpb.Entry,
                 dirty: ChunkedDirtyPages):
        self.fh = fh
        self.path = path
        self.entry = entry
        self.dirty = dirty
        self.size = max(entry.attributes.file_size, total_size(entry.chunks))


class WeedFS:
    def __init__(self, filer_server, chunk_size_mb: int = 4,
                 concurrency: int = 8, swap_dir: str | None = None,
                 subscribe_meta: bool = True):
        self.fs = filer_server
        self.chunk_size = chunk_size_mb << 20
        self.concurrency = concurrency
        self.swap_dir = swap_dir
        self.inodes = InodeToPath()
        self.meta = MetaCache(filer_server, subscribe=subscribe_meta)
        self._handles: dict[int, FileHandle] = {}
        self._next_fh = 2
        self._lock = threading.Lock()
        # serializes whole-entry read-modify-writes (flush vs setxattr vs
        # truncate): the loser of an unserialized RMW would overwrite the
        # winner's chunk list or extended map
        self._entry_mu = threading.Lock()
        # mount.configure quota (reference mount_pb ConfigureRequest
        # CollectionCapacity): 0 = unlimited; reported via statfs
        self.collection_capacity = 0

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        from ..filer.filer import split_path
        return split_path(path)

    def _entry(self, path: str) -> fpb.Entry:
        if path == "/":
            e = fpb.Entry(name="/", is_directory=True)
            e.attributes.file_mode = 0o755
            return e
        d, n = self._split(path)
        entry = self.meta.find(d, n)
        if entry is None:
            raise FuseError(2, path)  # ENOENT
        return entry

    def _attr(self, path: str, entry: fpb.Entry) -> dict:
        a = entry.attributes
        mode = a.file_mode & 0o7777
        if entry.is_directory:
            mode |= stat_mod.S_IFDIR
        elif a.symlink_target:
            mode |= stat_mod.S_IFLNK
        else:
            mode |= stat_mod.S_IFREG
        if a.symlink_target:
            size = len(a.symlink_target)
        else:
            size = (0 if entry.is_directory
                    else max(a.file_size, total_size(entry.chunks)))
        if entry.hard_link_id:
            # all names of a hardlink set share one inode number
            # (weedfs_link.go:17 "use the hardlink id as inode") so
            # os.path.samefile and `find -samefile` work across names
            ino = int.from_bytes(bytes(entry.hard_link_id)[:8], "big") or 1
        else:
            ino = self.inodes.lookup(path)
        return {"st_ino": ino, "st_mode": mode,
                "st_size": size, "st_mtime": a.mtime or 0,
                "st_ctime": a.crtime or a.mtime or 0,
                "st_uid": a.uid, "st_gid": a.gid,
                "st_nlink": max(1, entry.hard_link_counter)}

    # -- FUSE ops ------------------------------------------------------------
    def lookup(self, parent_path: str, name: str) -> dict:
        path = parent_path.rstrip("/") + "/" + name
        return self.getattr(path)

    def getattr(self, path: str) -> dict:
        return self._attr(path, self._entry(path))

    def readdir(self, path: str) -> list[str]:
        entry = self._entry(path)
        if not entry.is_directory:
            raise FuseError(20, path)  # ENOTDIR
        return [e.name for e in self.meta.list(path)]

    def mkdir(self, path: str, mode: int = 0o755) -> dict:
        d, n = self._split(path)
        if self.meta.find(d, n) is not None:
            raise FuseError(17, path)  # EEXIST
        e = fpb.Entry(name=n, is_directory=True)
        e.attributes.file_mode = mode
        e.attributes.mtime = e.attributes.crtime = int(time.time())
        self.fs.filer.create_entry(d, e)
        self.meta.invalidate(d, n)
        return self.getattr(path)

    def rmdir(self, path: str) -> None:
        entry = self._entry(path)
        if not entry.is_directory:
            raise FuseError(20, path)
        if next(iter(self.fs.filer.list_entries(path, limit=1)), None):
            raise FuseError(39, path)  # ENOTEMPTY
        d, n = self._split(path)
        self.fs.filer.delete_entry(d, n, is_recursive=False)
        self.meta.invalidate(d, n)
        self.inodes.remove_path(path)

    def unlink(self, path: str) -> None:
        d, n = self._split(path)
        if self.meta.find(d, n) is None:
            raise FuseError(2, path)
        self.fs.filer.delete_entry(d, n, is_delete_data=True)
        self.meta.invalidate(d, n)
        self.inodes.remove_path(path)

    def rename(self, old: str, new: str) -> None:
        od, on = self._split(old)
        nd, nn = self._split(new)
        if self.meta.find(nd, nn) is not None:
            self.fs.filer.delete_entry(nd, nn, is_recursive=True,
                                       is_delete_data=True)
            self.meta.invalidate(nd, nn)
        self.fs.filer.rename(od, on, nd, nn)
        self.meta.invalidate(od, on)
        self.meta.invalidate(nd, nn)
        self.inodes.move_path(old, new)

    # -- setattr family (reference weedfs_attr.go: chmod/chown/utimens
    # persist through the filer like any metadata change) -------------------
    def _update_entry_meta(self, path: str, mutate) -> None:
        """Shared metadata-only read-modify-write (setattr + xattr): one
        lock, one gc-free mtime-preserving update, one invalidation."""
        d, n = self._split(path)
        with self._entry_mu:
            entry = self.fs.filer.find_entry(d, n)
            if entry is None:
                raise FuseError(2, path)
            updated = fpb.Entry()
            updated.CopyFrom(entry)
            mutate(updated)
            self.fs.filer.update_entry(d, updated, gc_chunks=False,
                                       touch_mtime=False)
        self.meta.invalidate(d, n)

    _setattr = _update_entry_meta

    def chmod(self, path: str, mode: int) -> None:
        def mutate(e: fpb.Entry) -> None:
            e.attributes.file_mode = (e.attributes.file_mode & ~0o7777) | \
                (mode & 0o7777)
        self._setattr(path, mutate)

    def chown(self, path: str, uid: int, gid: int) -> None:
        def mutate(e: fpb.Entry) -> None:
            # -1 means "leave unchanged" (chown(2) semantics); the FUSE
            # layer passes 0xFFFFFFFF for it
            if uid not in (0xFFFFFFFF, -1):
                e.attributes.uid = uid
            if gid not in (0xFFFFFFFF, -1):
                e.attributes.gid = gid
        self._setattr(path, mutate)

    def utimens(self, path: str, atime: float | None,
                mtime: float | None) -> None:
        def mutate(e: fpb.Entry) -> None:
            if mtime is not None:
                e.attributes.mtime = int(mtime)
        self._setattr(path, mutate)

    # -- symlinks (reference weedfs_symlink.go) ------------------------------
    def symlink(self, target: str, path: str) -> dict:
        """`ln -s target path`: a zero-chunk entry whose attributes carry
        the target (weedfs_symlink.go:33 stores SymlinkTarget the same
        way)."""
        d, n = self._split(path)
        if self.meta.find(d, n) is not None:
            raise FuseError(17, path)  # EEXIST
        e = fpb.Entry(name=n)
        e.attributes.file_mode = 0o777
        e.attributes.symlink_target = target
        e.attributes.mtime = e.attributes.crtime = int(time.time())
        self.fs.filer.create_entry(d, e)
        self.meta.invalidate(d, n)
        return self.getattr(path)

    def readlink(self, path: str) -> str:
        entry = self._entry(path)
        if not entry.attributes.symlink_target:
            raise FuseError(22, path)  # EINVAL — not a symlink
        return entry.attributes.symlink_target

    # -- hardlinks (reference weedfs_link.go; shared record in the filer) ----
    def link(self, old: str, new: str) -> dict:
        od, on = self._split(old)
        nd, nn = self._split(new)
        if self.meta.find(nd, nn) is not None:
            raise FuseError(17, new)
        src = self.meta.find(od, on)
        if src is None:
            raise FuseError(2, old)
        if src.is_directory:
            raise FuseError(31, old)  # EMLINK — no dir hardlinks
        try:
            self.fs.filer.link(od, on, nd, nn)
        except FileNotFoundError:
            raise FuseError(2, old) from None
        except FileExistsError:
            raise FuseError(17, new) from None
        except IsADirectoryError:
            raise FuseError(31, old) from None
        self.meta.invalidate(od, on)
        self.meta.invalidate(nd, nn)
        return self.getattr(new)

    # -- extended attributes (reference weedfs_xattr.go; stored in
    # Entry.extended under the same "xattr-" key prefix the filer uses) ------
    XATTR_PREFIX = "xattr-"
    MAX_XATTR_NAME = 255
    MAX_XATTR_VALUE = 65536

    # POSIX: xattr changes touch ctime only, never mtime — which is what
    # the shared metadata-only RMW already guarantees
    _xattr_update = _update_entry_meta

    def setxattr(self, path: str, name: str, value: bytes,
                 flags: int = 0) -> None:
        if not name or len(name) > self.MAX_XATTR_NAME:
            raise FuseError(22 if not name else 34)  # EINVAL / ERANGE
        if len(value) > self.MAX_XATTR_VALUE:
            raise FuseError(7)  # E2BIG
        key = self.XATTR_PREFIX + name

        def mutate(e: fpb.Entry) -> None:
            if flags & 1 and key in e.extended:  # XATTR_CREATE
                raise FuseError(17, name)
            if flags & 2 and key not in e.extended:  # XATTR_REPLACE
                raise FuseError(61, name)  # ENODATA/ENOATTR
            e.extended[key] = value

        self._xattr_update(path, mutate)

    def getxattr(self, path: str, name: str) -> bytes:
        entry = self._entry(path)
        key = self.XATTR_PREFIX + name
        if key not in entry.extended:
            raise FuseError(61, name)  # ENODATA/ENOATTR
        return bytes(entry.extended[key])

    def listxattr(self, path: str) -> list[str]:
        entry = self._entry(path)
        return sorted(k[len(self.XATTR_PREFIX):] for k in entry.extended
                      if k.startswith(self.XATTR_PREFIX))

    def removexattr(self, path: str, name: str) -> None:
        key = self.XATTR_PREFIX + name

        def mutate(e: fpb.Entry) -> None:
            if key not in e.extended:
                raise FuseError(61, name)
            del e.extended[key]

        self._xattr_update(path, mutate)

    # -- open files ----------------------------------------------------------
    def create(self, path: str, mode: int = 0o644) -> int:
        d, n = self._split(path)
        if self.meta.find(d, n) is not None:
            raise FuseError(17, path)
        e = fpb.Entry(name=n)
        e.attributes.file_mode = mode
        e.attributes.mtime = e.attributes.crtime = int(time.time())
        self.fs.filer.create_entry(d, e)
        self.meta.invalidate(d, n)
        return self.open(path)

    def open(self, path: str) -> int:
        entry = self._entry(path)
        if entry.is_directory:
            raise FuseError(21, path)  # EISDIR
        dirty = ChunkedDirtyPages(
            self.chunk_size, self._make_saver(), self.concurrency,
            swap_dir=self.swap_dir)
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = FileHandle(fh, path, entry, dirty)
        return fh

    def _handle(self, fh: int) -> FileHandle:
        h = self._handles.get(fh)
        if h is None:
            raise FuseError(9, f"fh {fh}")  # EBADF
        return h

    def _make_saver(self):
        def saver(data: bytes, logical_offset: int) -> fpb.FileChunk:
            chunk = self.fs._save_blob(data)
            chunk.offset = logical_offset
            return chunk
        return saver

    def write(self, fh: int, offset: int, data: bytes) -> int:
        h = self._handle(fh)
        h.dirty.write(offset, data)
        h.size = max(h.size, offset + len(data))
        return len(data)

    def read(self, fh: int, offset: int, size: int) -> bytes:
        h = self._handle(fh)
        size = max(0, min(size, h.size - offset))
        if size == 0:
            return b""
        buf = bytearray(size)
        stored = self.fs.read_entry_bytes(h.entry, offset, size)
        buf[:len(stored)] = stored
        # overlay unflushed dirty ranges (read-your-writes)
        for lo, data in h.dirty.read(offset, size):
            at = lo - offset
            buf[at:at + len(data)] = data
        return bytes(buf)

    def flush(self, fh: int) -> None:
        """doFlush (weedfs_file_sync.go:92): drain the pipeline, merge
        new chunks into the entry, update the filer."""
        h = self._handle(fh)
        if not h.dirty.dirty:
            return
        new_chunks = h.dirty.flush()  # uploads happen OUTSIDE the mutex
        d, n = self._split(h.path)
        with self._entry_mu:
            entry = self.fs.filer.find_entry(d, n) or h.entry
            updated = fpb.Entry()
            updated.CopyFrom(entry)
            updated.chunks.extend(new_chunks)
            updated.attributes.file_size = max(
                h.size, total_size(updated.chunks))
            updated.attributes.mtime = int(time.time())
            self.fs.filer.update_entry(d, updated)
        h.entry = updated
        h.dirty.commit()  # entry now holds the chunks; drop overlay copies
        self.meta.invalidate(d, n)

    fsync = flush

    def release(self, fh: int) -> None:
        h = self._handles.get(fh)
        if h is None:
            return
        try:
            self.flush(fh)
        finally:
            h.dirty.destroy()
            with self._lock:
                self._handles.pop(fh, None)

    def truncate(self, path: str, length: int) -> None:
        """setattr(size) — weedfs_attr.go truncates the chunk list."""
        # flush open handles first so no unflushed dirty interval beyond
        # `length` can resurrect the truncated bytes at the next flush
        for h in list(self._handles.values()):
            if h.path == path and h.dirty.dirty:
                self.flush(h.fh)
        d, n = self._split(path)
        with self._entry_mu:
            entry = self.fs.filer.find_entry(d, n)
            if entry is None:
                raise FuseError(2, path)
            kept = [c for c in entry.chunks if c.offset < length]
            updated = fpb.Entry()
            updated.CopyFrom(entry)
            del updated.chunks[:]
            for c in kept:
                nc = updated.chunks.add()
                nc.CopyFrom(c)
                if nc.offset + nc.size > length:
                    nc.size = length - nc.offset
            updated.attributes.file_size = length
            self.fs.filer.update_entry(d, updated)
        self.meta.invalidate(d, n)
        for h in self._handles.values():
            if h.path == path:
                h.size = length
                h.entry = updated

    def configure(self, collection_capacity: int) -> None:
        """mount.configure RPC body (reference weedfs_grpc_server.go
        Configure): adjust the quota on a live mount."""
        self.collection_capacity = max(0, int(collection_capacity))
        self._usage_cached_at = 0.0  # force re-measure on next statfs

    _usage_cached_at = 0.0
    _usage_cached = 0
    USAGE_TTL_S = 5.0  # statfs is a kernel hot path; don't walk per call

    def statfs(self) -> dict:
        if self.collection_capacity:
            import time as _time
            bsize = self.chunk_size
            blocks = max(1, self.collection_capacity // bsize)
            now = _time.monotonic()
            if now - self._usage_cached_at > self.USAGE_TTL_S:
                try:
                    self._usage_cached = sum(
                        (e.attributes.file_size or 0)
                        for _, e in self._walk_all("/"))
                    self._usage_cached_at = now
                except Exception as e:  # noqa: BLE001 — quota display best-effort
                    log.debug("statfs usage scan failed: %s", e)
            free = max(0, blocks - self._usage_cached // bsize)
            return {"f_bsize": bsize, "f_blocks": blocks,
                    "f_bfree": free, "f_bavail": free,
                    "f_files": 1 << 20, "f_ffree": 1 << 20}
        return {"f_bsize": self.chunk_size, "f_blocks": 1 << 30,
                "f_bfree": 1 << 30, "f_bavail": 1 << 30,
                "f_files": 1 << 20, "f_ffree": 1 << 20}

    def _walk_all(self, directory: str):
        for e in self.meta.list(directory):
            path = (directory.rstrip("/") + "/" + e.name)
            yield path, e
            if e.is_directory:
                yield from self._walk_all(path)

    def forget(self, inode: int, nlookup: int = 1) -> None:
        self.inodes.forget(inode, nlookup)

    def destroy(self) -> None:
        for fh in list(self._handles):
            try:
                self.release(fh)
            except Exception as e:  # noqa: BLE001
                log.debug("handle %s release at unmount failed: %s", fh, e)
        self.meta.close()


def mount(weedfs: WeedFS, mountpoint: str):  # pragma: no cover - needs fusepy
    """Kernel mount via fusepy when available (the image has no fusepy;
    the reference uses go-fuse, weedfs.go). Raises RuntimeError otherwise."""
    try:
        import fuse  # type: ignore[import-not-found]
    except ImportError as e:
        raise RuntimeError(
            "fusepy not installed; WeedFS is only drivable in-process") from e

    class _Ops(fuse.Operations):  # type: ignore[misc]
        def getattr(self, path, fh=None):
            return weedfs.getattr(path)

        def readdir(self, path, fh):
            return [".", ".."] + weedfs.readdir(path)

        def mkdir(self, path, mode):
            weedfs.mkdir(path, mode)

        def rmdir(self, path):
            weedfs.rmdir(path)

        def unlink(self, path):
            weedfs.unlink(path)

        def rename(self, old, new):
            weedfs.rename(old, new)

        def create(self, path, mode, fi=None):
            return weedfs.create(path, mode)

        def open(self, path, flags):
            return weedfs.open(path)

        def read(self, path, size, offset, fh):
            return weedfs.read(fh, offset, size)

        def write(self, path, data, offset, fh):
            return weedfs.write(fh, offset, data)

        def flush(self, path, fh):
            weedfs.flush(fh)

        def release(self, path, fh):
            weedfs.release(fh)

        def truncate(self, path, length, fh=None):
            weedfs.truncate(path, length)

        def statfs(self, path):
            return weedfs.statfs()

        def symlink(self, target, source):
            weedfs.symlink(source, target)  # fusepy arg order

        def readlink(self, path):
            return weedfs.readlink(path)

        def link(self, target, source):
            weedfs.link(source, target)

        def chmod(self, path, mode):
            weedfs.chmod(path, mode)

        def chown(self, path, uid, gid):
            weedfs.chown(path, uid, gid)

        def utimens(self, path, times=None):
            if times:
                weedfs.utimens(path, times[0], times[1])

        def setxattr(self, path, name, value, options, position=0):
            weedfs.setxattr(path, name, value, options)

        def getxattr(self, path, name, position=0):
            return weedfs.getxattr(path, name)

        def listxattr(self, path):
            return weedfs.listxattr(path)

        def removexattr(self, path, name):
            weedfs.removexattr(path, name)

    return fuse.FUSE(_Ops(), mountpoint, foreground=True)
