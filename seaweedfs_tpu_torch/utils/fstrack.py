"""Recording VFS shim for crash-state enumeration (devtools/crashsim).

The static half of the crash-consistency plane (the `ack-before-fsync`
/ `rename-no-dir-fsync` / `vif-write-bypass` rules in
devtools/swtpu_lint.py) reads source; this module watches what the
process actually DOES to the filesystem: `install()` patches
`os.write/pwrite/fsync/fdatasync/rename/replace/truncate/ftruncate/
unlink/open/close` plus `builtins.open` (write-mode file objects come
back wrapped in a recording proxy), and every mutation under the
registered scope root lands in one totally-ordered trace with fd→path
resolution and fsync barriers. devtools/crashsim.py replays prefixes
of that trace — and legal drops/tears of un-fsynced suffixes — into a
fresh directory and runs each surface's real recovery code on the
result.

Scoping mirrors utils/locktrack.py: only paths under the root passed
to `start_trace()` are recorded, so daemon threads writing elsewhere
(logs, sockets, caches) pass through the patched entry points with a
dictionary miss and nothing else. Fds are resolved through a table
populated by the patched `os.open` / `builtins.open`; an fd opened
before `install()` is untracked by construction (crashsim workloads
create every file under the trace, so nothing is lost).

Recorded op kinds and their crash semantics (the contract
devtools/crashsim.py enumerates against — see README "Crash
consistency"):

* ``create`` / ``write`` / ``trunc`` — data ops on one file; they
  persist in program order per file (ext4 data=ordered appends), so a
  crash may drop only an un-fsynced *suffix*, and may additionally
  tear the last surviving write mid-record;
* ``fsync`` — barrier: pins every earlier data op on that file
  (including its creation — no mainstream fs loses a just-fsynced
  file);
* ``rename`` / ``unlink`` — directory metadata; droppable unless a
  later ``fsync_dir`` of the parent (or an ``fsync`` of the rename's
  destination) pins them — the exact gap the `rename-no-dir-fsync`
  lint rule points at;
* ``fsync_dir`` — barrier for metadata ops in that directory (emitted
  when the patched `os.fsync` resolves a directory fd, e.g. via
  utils/fsutil.fsync_dir);
* ``mark`` — workload annotation (`mark("ack", ...)`): the durability
  promise whose crash-survival the invariant drivers check.

Internals use a raw `_thread.allocate_lock()` (never `threading.Lock`)
so the shim stays OUT of locktrack's ordering graph — the chaos lane
runs a crashsim pass under SWTPU_LOCKCHECK=1 to hold that line — and
every patched entry point carries a per-thread reentrancy latch so a
GC-triggered `__del__` closing a file mid-record passes straight
through instead of deadlocking on the non-reentrant lock (the lesson
locktrack's tracker learned in the profiling plane).

Known blind spots, by design: writes through fds that were dup()ed or
inherited, mmap stores, and `O_DIRECT` tricks are not traced; none of
the repo's durability surfaces use them on the write path (the EC
writer pool maps the *source* read-only and writes shards via
os.pwrite on fds the shim registered).

The port's copy of seaweedfs_tpu/utils/fstrack.py. The port's EC seal
(ec/stream.encode_volumes) opens its shard files through `os.open` and
writes them from its WriterPool threads with `os.pwrite`, and sizes them
with the file object's `truncate`; the shim records all three, from any
thread.
"""
from __future__ import annotations

import _thread
import builtins
import os
import threading


class FsOp:
    """One traced filesystem mutation (or annotation)."""

    __slots__ = ("seq", "kind", "path", "offset", "data", "length",
                 "dst", "label", "meta")

    def __init__(self, seq, kind, path=None, offset=0, data=b"",
                 length=0, dst=None, label="", meta=None):
        self.seq = seq
        self.kind = kind          # create|write|trunc|rename|unlink|
        #                           fsync|fsync_dir|mark
        self.path = path          # absolute path (src for rename)
        self.offset = offset      # byte offset for write
        self.data = data          # bytes written (write)
        self.length = length      # new length (trunc)
        self.dst = dst            # rename destination
        self.label = label        # mark label
        self.meta = meta          # mark payload (dict)

    def __repr__(self):  # debugging/artifact aid, not parsed anywhere
        if self.kind == "write":
            return (f"FsOp({self.seq} write {self.path}"
                    f"@{self.offset}+{len(self.data)})")
        if self.kind == "rename":
            return f"FsOp({self.seq} rename {self.path} -> {self.dst})"
        if self.kind == "mark":
            return f"FsOp({self.seq} mark {self.label} {self.meta})"
        return f"FsOp({self.seq} {self.kind} {self.path})"


# -- module state (one active trace at a time; crashsim runs scenarios
#    sequentially) ----------------------------------------------------------
_guard = _thread.allocate_lock()   # raw: invisible to locktrack
_tls = threading.local()           # reentrancy latch per thread
_installed = False
_orig: dict = {}
_scope: str | None = None          # abs root; None = record nothing
_trace: list = []
_seq = 0
_fd_paths: dict = {}               # fd -> (abspath, is_dir)


def _busy() -> bool:
    return getattr(_tls, "busy", False)


def _in_scope(path) -> str | None:
    """Abs path when `path` is under the scope root, else None."""
    if _scope is None or not isinstance(path, (str, bytes, os.PathLike)):
        return None
    try:
        p = os.path.abspath(os.fspath(path))
    except TypeError:
        return None
    if isinstance(p, bytes):
        try:
            p = p.decode()
        except UnicodeDecodeError:
            return None
    if p == _scope or p.startswith(_scope + os.sep):
        return p
    return None


def _record(kind, **kw) -> None:
    global _seq
    with _guard:
        _seq += 1
        _trace.append(FsOp(_seq, kind, **kw))


# -- public API -------------------------------------------------------------

def installed() -> bool:
    return _installed


def install() -> None:
    """Patch the os/builtins entry points (idempotent). Nothing is
    recorded until `start_trace()` registers a scope root."""
    global _installed
    with _guard:
        if _installed:
            return
        _orig.update({
            "open": builtins.open,
            "os.open": os.open,
            "os.close": os.close,
            "os.write": os.write,
            "os.pwrite": os.pwrite,
            "os.fsync": os.fsync,
            "os.fdatasync": os.fdatasync,
            "os.rename": os.rename,
            "os.replace": os.replace,
            "os.truncate": os.truncate,
            "os.ftruncate": os.ftruncate,
            "os.unlink": os.unlink,
            "os.remove": os.remove,
        })
        builtins.open = _patched_builtin_open
        os.open = _patched_os_open
        os.close = _patched_os_close
        os.write = _patched_os_write
        os.pwrite = _patched_os_pwrite
        os.fsync = _patched_os_fsync
        os.fdatasync = _patched_os_fdatasync
        os.rename = _patched_rename
        os.replace = _patched_replace
        os.truncate = _patched_os_truncate
        os.ftruncate = _patched_os_ftruncate
        os.unlink = _patched_unlink
        os.remove = _patched_unlink
        _installed = True


def uninstall() -> None:
    global _installed, _scope
    with _guard:
        if not _installed:
            return
        builtins.open = _orig["open"]
        os.open = _orig["os.open"]
        os.close = _orig["os.close"]
        os.write = _orig["os.write"]
        os.pwrite = _orig["os.pwrite"]
        os.fsync = _orig["os.fsync"]
        os.fdatasync = _orig["os.fdatasync"]
        os.rename = _orig["os.rename"]
        os.replace = _orig["os.replace"]
        os.truncate = _orig["os.truncate"]
        os.ftruncate = _orig["os.ftruncate"]
        os.unlink = _orig["os.unlink"]
        os.remove = _orig["os.remove"]
        _orig.clear()
        _installed = False
        _scope = None
        _fd_paths.clear()


def start_trace(root: str) -> None:
    """Reset the trace and record every mutation under `root`."""
    global _scope, _seq
    if not _installed:
        raise RuntimeError("fstrack.install() first")
    with _guard:
        _scope = os.path.abspath(root)
        _trace.clear()
        _seq = 0
        _fd_paths.clear()


def stop_trace() -> "list[FsOp]":
    """Stop recording; returns the captured ops (marks included)."""
    global _scope
    with _guard:
        _scope = None
        ops = list(_trace)
        _trace.clear()
        _fd_paths.clear()
    return ops


def mark(label: str, **meta) -> None:
    """Annotate the trace (e.g. mark("ack", key=..., sha=...)): the
    crash simulator hands every mark at-or-before the crash point to
    the invariant driver as an in-force durability promise."""
    if _scope is not None:
        _record("mark", label=label, meta=meta)


# -- patched entry points ---------------------------------------------------

def _patched_os_open(path, flags, mode=0o777, *, dir_fd=None):
    if _busy() or dir_fd is not None:
        return _orig["os.open"](path, flags, mode,
                                **({"dir_fd": dir_fd} if dir_fd else {}))
    _tls.busy = True
    try:
        p = _in_scope(path)
        existed = p is not None and os.path.exists(p)
        fd = _orig["os.open"](path, flags, mode)
        if p is not None:
            is_dir = os.path.isdir(p)
            with _guard:
                _fd_paths[fd] = (p, is_dir)
            if not is_dir:
                if (flags & os.O_CREAT) and not existed:
                    _record("create", path=p)
                if (flags & os.O_TRUNC) and existed:
                    _record("trunc", path=p, length=0)
        return fd
    finally:
        _tls.busy = False


def _patched_os_close(fd):
    if not _busy():
        with _guard:
            _fd_paths.pop(fd, None)
    return _orig["os.close"](fd)


def _patched_os_write(fd, data):
    if _busy():
        return _orig["os.write"](fd, data)
    ent = _fd_paths.get(fd)
    if ent is None or ent[1]:
        return _orig["os.write"](fd, data)
    _tls.busy = True
    try:
        off = os.lseek(fd, 0, os.SEEK_CUR)
        n = _orig["os.write"](fd, data)
        _record("write", path=ent[0], offset=off, data=bytes(data[:n]))
        return n
    finally:
        _tls.busy = False


def _patched_os_pwrite(fd, data, offset):
    if _busy():
        return _orig["os.pwrite"](fd, data, offset)
    ent = _fd_paths.get(fd)
    if ent is None or ent[1]:
        return _orig["os.pwrite"](fd, data, offset)
    _tls.busy = True
    try:
        n = _orig["os.pwrite"](fd, data, offset)
        _record("write", path=ent[0], offset=offset, data=bytes(data[:n]))
        return n
    finally:
        _tls.busy = False


def _sync_common(which, fd):
    if _busy():
        return _orig[which](fd)
    ent = _fd_paths.get(fd)
    if ent is None:
        return _orig[which](fd)
    _tls.busy = True
    try:
        r = _orig[which](fd)
        _record("fsync_dir" if ent[1] else "fsync", path=ent[0])
        return r
    finally:
        _tls.busy = False


def _patched_os_fsync(fd):
    return _sync_common("os.fsync", fd)


def _patched_os_fdatasync(fd):
    # fdatasync pins file DATA but not necessarily size metadata; the
    # repo only fdatasyncs append-only files whose recovery tolerates a
    # torn tail, so the enumerator treats it as a full fsync barrier
    return _sync_common("os.fdatasync", fd)


def _rename_common(which, src, dst):
    if _busy():
        return _orig[which](src, dst)
    _tls.busy = True
    try:
        ps, pd = _in_scope(src), _in_scope(dst)
        r = _orig[which](src, dst)
        if ps is not None or pd is not None:
            _record("rename", path=ps or os.path.abspath(os.fspath(src)),
                    dst=pd or os.path.abspath(os.fspath(dst)))
        return r
    finally:
        _tls.busy = False


def _patched_rename(src, dst, **kw):
    if kw:
        return _orig["os.rename"](src, dst, **kw)
    return _rename_common("os.rename", src, dst)


def _patched_replace(src, dst, **kw):
    if kw:
        return _orig["os.replace"](src, dst, **kw)
    return _rename_common("os.replace", src, dst)


def _patched_os_truncate(path, length):
    r = _orig["os.truncate"](path, length)
    if _busy():
        return r
    if isinstance(path, int):
        ent = _fd_paths.get(path)
        if ent is not None and not ent[1]:
            _record("trunc", path=ent[0], length=length)
        return r
    _tls.busy = True
    try:
        p = _in_scope(path)
        if p is not None:
            _record("trunc", path=p, length=length)
        return r
    finally:
        _tls.busy = False


def _patched_os_ftruncate(fd, length):
    r = _orig["os.ftruncate"](fd, length)
    if not _busy():
        ent = _fd_paths.get(fd)
        if ent is not None and not ent[1]:
            _record("trunc", path=ent[0], length=length)
    return r


def _patched_unlink(path, **kw):
    if _busy() or kw:
        return _orig["os.unlink"](path, **kw)
    _tls.busy = True
    try:
        p = _in_scope(path)
        r = _orig["os.unlink"](path)
        if p is not None:
            _record("unlink", path=p)
        return r
    finally:
        _tls.busy = False


def _patched_builtin_open(file, mode="r", *args, **kwargs):
    if _busy():
        return _orig["open"](file, mode, *args, **kwargs)
    writable = any(c in mode for c in "wax+")
    p = _in_scope(file) if writable else None
    if p is None:
        return _orig["open"](file, mode, *args, **kwargs)
    _tls.busy = True
    try:
        # existence must be sampled BEFORE the open — "w"/"a" create the
        # file as a side effect, and create-vs-trunc is a real
        # distinction in the crash model (a trunc implies a directory
        # entry that already survived)
        existed = os.path.exists(p)
        f = _orig["open"](file, mode, *args, **kwargs)
        size = os.path.getsize(p) if existed else 0
        if "w" in mode or "x" in mode:
            if existed:
                _record("trunc", path=p, length=0)
            else:
                _record("create", path=p)
        elif not existed:
            _record("create", path=p)
        try:
            fd = f.fileno()
            with _guard:
                _fd_paths[fd] = (p, False)
        except (OSError, AttributeError):
            fd = None
        return _TrackedFile(f, p, fd,
                            binary=("b" in mode),
                            pos=(size if "a" in mode else 0))
    finally:
        _tls.busy = False


class _TrackedFile:
    """Write-recording proxy over a real file object. Reads, seeks and
    attribute access delegate; writes/truncates land in the trace.
    Binary offsets come from tell(); text mode keeps a byte cursor
    (every text writer on a durability surface — .vif JSON, raft
    metadata — writes sequentially from the start)."""

    def __init__(self, f, path, fd, binary, pos):
        self._f = f
        self._path = path
        self._fd = fd
        self._binary = binary
        self._pos = pos

    def write(self, data):
        if _busy():
            return self._f.write(data)
        _tls.busy = True
        try:
            if self._binary:
                off = self._f.tell()
                n = self._f.write(data)
                _record("write", path=self._path, offset=off,
                        data=bytes(data[:n]))
            else:
                n = self._f.write(data)
                b = str(data[:n]).encode(
                    getattr(self._f, "encoding", None) or "utf-8")
                _record("write", path=self._path, offset=self._pos, data=b)
                self._pos += len(b)
            return n
        finally:
            _tls.busy = False

    def writelines(self, lines):
        for ln in lines:
            self.write(ln)

    def truncate(self, size=None):
        r = self._f.truncate(size)
        if not _busy():
            _record("trunc", path=self._path,
                    length=r if size is None else size)
        return r

    def close(self):
        if self._fd is not None and not _busy():
            with _guard:
                _fd_paths.pop(self._fd, None)
            self._fd = None
        return self._f.close()

    # context manager / iteration protocols are looked up on the TYPE,
    # so __getattr__ delegation is not enough for them
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return iter(self._f)

    def __getattr__(self, name):
        return getattr(self._f, name)
