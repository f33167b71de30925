"""Minimal ctypes binding to libfuse 2.9 (x86_64 Linux) — no fusepy needed.

Reference: the Go side uses hanwen/go-fuse (weed/mount, go.mod:141); this is
the Python equivalent of the small slice of the libfuse high-level API the
mount needs: getattr/readdir/create/open/read/write/flush/release/
truncate/unlink/mkdir/rmdir/rename/statfs. Struct layouts match glibc
x86_64 + libfuse 2.9's FUSE_USE_VERSION 26 ABI (same layouts fusepy ships).

Entry point: `fuse_loop(ops_dict, mountpoint, foreground=True)` where
ops_dict maps operation names to python callables that raise FuseError
(errno) on failure.

The port's copy of seaweedfs_tpu/mount/fuse_binding.py, unchanged:
the same structures (tests/test_torch_fuse_binding.py holds their sizes
against the reference's) and the same -errno mapping.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno as errno_mod
import os

c_stat_p = ctypes.c_void_p  # forward decl for readability


class c_timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


class c_stat(ctypes.Structure):
    # glibc x86_64 struct stat
    _fields_ = [
        ("st_dev", ctypes.c_uint64),
        ("st_ino", ctypes.c_uint64),
        ("st_nlink", ctypes.c_uint64),
        ("st_mode", ctypes.c_uint32),
        ("st_uid", ctypes.c_uint32),
        ("st_gid", ctypes.c_uint32),
        ("__pad0", ctypes.c_int),
        ("st_rdev", ctypes.c_uint64),
        ("st_size", ctypes.c_int64),
        ("st_blksize", ctypes.c_int64),
        ("st_blocks", ctypes.c_int64),
        ("st_atim", c_timespec),
        ("st_mtim", c_timespec),
        ("st_ctim", c_timespec),
        ("__glibc_reserved", ctypes.c_long * 3),
    ]


class c_statvfs(ctypes.Structure):
    _fields_ = [
        ("f_bsize", ctypes.c_ulong),
        ("f_frsize", ctypes.c_ulong),
        ("f_blocks", ctypes.c_uint64),
        ("f_bfree", ctypes.c_uint64),
        ("f_bavail", ctypes.c_uint64),
        ("f_files", ctypes.c_uint64),
        ("f_ffree", ctypes.c_uint64),
        ("f_favail", ctypes.c_uint64),
        ("f_fsid", ctypes.c_ulong),
        ("f_flag", ctypes.c_ulong),
        ("f_namemax", ctypes.c_ulong),
        ("__f_spare", ctypes.c_int * 6),
    ]


class fuse_file_info(ctypes.Structure):
    _fields_ = [
        ("flags", ctypes.c_int),
        ("fh_old", ctypes.c_ulong),
        ("writepage", ctypes.c_int),
        ("flags_bits", ctypes.c_uint),  # direct_io:1 keep_cache:1 ...
        ("fh", ctypes.c_uint64),
        ("lock_owner", ctypes.c_uint64),
    ]


fuse_file_info_p = ctypes.POINTER(fuse_file_info)

# int (*fuse_fill_dir_t)(void *buf, const char *name,
#                        const struct stat *stbuf, off_t off);
fuse_fill_dir_t = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
    ctypes.POINTER(c_stat), ctypes.c_int64)

_GETATTR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                            ctypes.POINTER(c_stat))
# buf is c_void_p: a c_char_p arg would arrive as an immutable bytes copy
_READLINK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                             ctypes.c_void_p, ctypes.c_size_t)
_GETDIR = ctypes.c_void_p
_MKNOD = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
                          ctypes.c_uint64)
_MKDIR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32)
_UNLINK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p)
_RMDIR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p)
_SYMLINK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
_RENAME = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
_LINK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
_CHMOD = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32)
_CHOWN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
                          ctypes.c_uint32)
_TRUNCATE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_int64)
_UTIME = ctypes.c_void_p
_OPEN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, fuse_file_info_p)
# buffer args are c_void_p: a c_char_p callback arg would be converted to
# an immutable Python bytes copy, making the read buffer unwritable
_READ = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                         ctypes.c_size_t, ctypes.c_int64, fuse_file_info_p)
_WRITE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                          ctypes.c_size_t, ctypes.c_int64, fuse_file_info_p)
_STATFS = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                           ctypes.POINTER(c_statvfs))
_FLUSH = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, fuse_file_info_p)
_RELEASE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, fuse_file_info_p)
_FSYNC = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                          fuse_file_info_p)
_READDIR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
                            fuse_fill_dir_t, ctypes.c_int64,
                            fuse_file_info_p)
_INIT = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p)
_DESTROY = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_ACCESS = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_int)
_CREATE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32,
                           fuse_file_info_p)
_FTRUNCATE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_int64, fuse_file_info_p)
_FGETATTR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                             ctypes.POINTER(c_stat), fuse_file_info_p)
_UTIMENS = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                            ctypes.POINTER(c_timespec * 2))
# xattr family (libfuse 2.9 signatures; value buffers as c_void_p so the
# get/list destinations stay writable)
_SETXATTR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int)
_GETXATTR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_void_p, ctypes.c_size_t)
_LISTXATTR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_void_p, ctypes.c_size_t)
_REMOVEXATTR = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                                ctypes.c_char_p)


class fuse_operations(ctypes.Structure):
    # field ORDER is the libfuse 2.9 ABI (FUSE_USE_VERSION 26) — do not sort
    _fields_ = [
        ("getattr", _GETATTR),
        ("readlink", _READLINK),
        ("getdir", _GETDIR),
        ("mknod", _MKNOD),
        ("mkdir", _MKDIR),
        ("unlink", _UNLINK),
        ("rmdir", _RMDIR),
        ("symlink", _SYMLINK),
        ("rename", _RENAME),
        ("link", _LINK),
        ("chmod", _CHMOD),
        ("chown", _CHOWN),
        ("truncate", _TRUNCATE),
        ("utime", _UTIME),
        ("open", _OPEN),
        ("read", _READ),
        ("write", _WRITE),
        ("statfs", _STATFS),
        ("flush", _FLUSH),
        ("release", _RELEASE),
        ("fsync", _FSYNC),
        ("setxattr", _SETXATTR),
        ("getxattr", _GETXATTR),
        ("listxattr", _LISTXATTR),
        ("removexattr", _REMOVEXATTR),
        ("opendir", ctypes.c_void_p),
        ("readdir", _READDIR),
        ("releasedir", ctypes.c_void_p),
        ("fsyncdir", ctypes.c_void_p),
        ("init", _INIT),
        ("destroy", _DESTROY),
        ("access", _ACCESS),
        ("create", _CREATE),
        ("ftruncate", _FTRUNCATE),
        ("fgetattr", _FGETATTR),
        ("lock", ctypes.c_void_p),
        ("utimens", _UTIMENS),
        ("bmap", ctypes.c_void_p),
        ("flag_bits", ctypes.c_uint),  # nullpath_ok:1 nopath:1 ... :29
        ("ioctl", ctypes.c_void_p),
        ("poll", ctypes.c_void_p),
        ("write_buf", ctypes.c_void_p),
        ("read_buf", ctypes.c_void_p),
        ("flock", ctypes.c_void_p),
        ("fallocate", ctypes.c_void_p),
    ]


def _libfuse():
    path = ctypes.util.find_library("fuse") or "libfuse.so.2"
    return ctypes.CDLL(path)


def _fill_stat(st: c_stat, attr: dict) -> None:
    ctypes.memset(ctypes.byref(st), 0, ctypes.sizeof(st))
    st.st_mode = attr.get("st_mode", 0)
    st.st_nlink = attr.get("st_nlink", 1)
    st.st_size = attr.get("st_size", 0)
    st.st_uid = attr.get("st_uid") or os.getuid()
    st.st_gid = attr.get("st_gid") or os.getgid()
    st.st_blksize = 4096
    st.st_blocks = (st.st_size + 511) // 512
    for name, key in (("st_atim", "st_atime"), ("st_mtim", "st_mtime"),
                      ("st_ctim", "st_ctime")):
        t = float(attr.get(key, 0))
        getattr(st, name).tv_sec = int(t)
        getattr(st, name).tv_nsec = int((t % 1) * 1e9)


def fuse_loop(handlers, mountpoint: str, fsname: str = "swtpu",
              foreground: bool = True, allow_other: bool = False) -> int:
    """Mount and serve until unmounted (fusermount -u) or killed.

    handlers: object with getattr/readdir/... methods following the
    mount.weedfs.WeedFS path-based API; errors raised as FuseError(errno)
    map to negative errnos.
    """
    lib = _libfuse()

    def guard(fn):
        """Wrap a handler: FuseError -> -errno, unexpected -> -EIO."""
        def inner(*args):
            try:
                return fn(*args) or 0
            except Exception as e:  # noqa: BLE001
                eno = getattr(e, "errno", None) or errno_mod.EIO
                return -int(eno)
        return inner

    @guard
    def op_getattr(path, stbuf):
        attr = handlers.getattr(path.decode())
        _fill_stat(stbuf.contents, attr)

    @guard
    def op_fgetattr(path, stbuf, fi):
        attr = handlers.getattr(path.decode())
        _fill_stat(stbuf.contents, attr)

    @guard
    def op_readdir(path, buf, filler, offset, fi):
        for name in [".", ".."] + list(handlers.readdir(path.decode())):
            if filler(buf, name.encode(), None, 0) != 0:
                break

    @guard
    def op_mkdir(path, mode):
        handlers.mkdir(path.decode(), mode)

    @guard
    def op_rmdir(path):
        handlers.rmdir(path.decode())

    @guard
    def op_unlink(path):
        handlers.unlink(path.decode())

    @guard
    def op_rename(old, new):
        handlers.rename(old.decode(), new.decode())

    @guard
    def op_truncate(path, length):
        handlers.truncate(path.decode(), length)

    @guard
    def op_ftruncate(path, length, fi):
        handlers.truncate(path.decode(), length)

    @guard
    def op_create(path, mode, fi):
        fi.contents.fh = handlers.create(path.decode(), mode)

    @guard
    def op_open(path, fi):
        fi.contents.fh = handlers.open(path.decode())

    @guard
    def op_read(path, buf, size, offset, fi):
        data = handlers.read(fi.contents.fh, offset, size)
        n = len(data)
        ctypes.memmove(buf, data, n)
        return n

    @guard
    def op_write(path, buf, size, offset, fi):
        data = ctypes.string_at(buf, size)
        return handlers.write(fi.contents.fh, offset, data)

    @guard
    def op_flush(path, fi):
        handlers.flush(fi.contents.fh)

    @guard
    def op_release(path, fi):
        handlers.release(fi.contents.fh)

    @guard
    def op_fsync(path, datasync, fi):
        handlers.flush(fi.contents.fh)

    @guard
    def op_statfs(path, st):
        info = handlers.statfs()
        v = st.contents
        ctypes.memset(ctypes.byref(v), 0, ctypes.sizeof(v))
        v.f_bsize = info.get("f_bsize", 4096)
        v.f_frsize = info.get("f_frsize", info.get("f_bsize", 4096))
        v.f_blocks = info.get("f_blocks", 1 << 30)
        v.f_bfree = info.get("f_bfree", 1 << 30)
        v.f_bavail = info.get("f_bavail", info.get("f_bfree", 1 << 30))
        v.f_files = info.get("f_files", 1 << 20)
        v.f_ffree = v.f_favail = info.get("f_ffree", 1 << 20)
        v.f_namemax = info.get("f_namemax", 255)

    @guard
    def op_access(path, mask):
        handlers.getattr(path.decode())  # existence check

    @guard
    def op_symlink(target, linkpath):
        handlers.symlink(target.decode(), linkpath.decode())

    @guard
    def op_readlink(path, buf, size):
        target = handlers.readlink(path.decode()).encode()
        # NUL-terminated, truncated to the kernel's buffer
        data = target[:max(0, size - 1)] + b"\x00"
        ctypes.memmove(buf, data, len(data))

    @guard
    def op_link(old, new):
        handlers.link(old.decode(), new.decode())

    @guard
    def op_setxattr(path, name, value, size, flags):
        data = ctypes.string_at(value, size) if size else b""
        handlers.setxattr(path.decode(), name.decode(), data, flags)

    @guard
    def op_getxattr(path, name, buf, size):
        data = handlers.getxattr(path.decode(), name.decode())
        if size == 0:
            return len(data)  # size probe
        if len(data) > size:
            return -errno_mod.ERANGE
        ctypes.memmove(buf, data, len(data))
        return len(data)

    @guard
    def op_listxattr(path, buf, size):
        names = handlers.listxattr(path.decode())
        blob = b"".join(n.encode() + b"\x00" for n in names)
        if size == 0:
            return len(blob)
        if len(blob) > size:
            return -errno_mod.ERANGE
        if blob:
            ctypes.memmove(buf, blob, len(blob))
        return len(blob)

    @guard
    def op_removexattr(path, name):
        handlers.removexattr(path.decode(), name.decode())

    @guard
    def op_chmod(path, mode):
        handlers.chmod(path.decode(), mode)

    @guard
    def op_chown(path, uid, gid):
        handlers.chown(path.decode(), uid, gid)

    @guard
    def op_utimens(path, times):
        if not times:
            handlers.utimens(path.decode(), None, None)
            return
        ts = times.contents
        def val(t):  # UTIME_NOW(2^30-1)/UTIME_OMIT(2^30-2) in tv_nsec
            if t.tv_nsec == (1 << 30) - 2:
                return None
            if t.tv_nsec == (1 << 30) - 1:
                import time as _t
                return _t.time()
            return t.tv_sec + t.tv_nsec / 1e9
        handlers.utimens(path.decode(), val(ts[0]), val(ts[1]))

    ops = fuse_operations()
    ops.getattr = _GETATTR(op_getattr)
    ops.fgetattr = _FGETATTR(op_fgetattr)
    ops.readdir = _READDIR(op_readdir)
    ops.mkdir = _MKDIR(op_mkdir)
    ops.rmdir = _RMDIR(op_rmdir)
    ops.unlink = _UNLINK(op_unlink)
    ops.rename = _RENAME(op_rename)
    ops.truncate = _TRUNCATE(op_truncate)
    ops.ftruncate = _FTRUNCATE(op_ftruncate)
    ops.create = _CREATE(op_create)
    ops.open = _OPEN(op_open)
    ops.read = _READ(op_read)
    ops.write = _WRITE(op_write)
    ops.flush = _FLUSH(op_flush)
    ops.release = _RELEASE(op_release)
    ops.fsync = _FSYNC(op_fsync)
    ops.statfs = _STATFS(op_statfs)
    ops.symlink = _SYMLINK(op_symlink)
    ops.readlink = _READLINK(op_readlink)
    ops.link = _LINK(op_link)
    ops.setxattr = _SETXATTR(op_setxattr)
    ops.getxattr = _GETXATTR(op_getxattr)
    ops.listxattr = _LISTXATTR(op_listxattr)
    ops.removexattr = _REMOVEXATTR(op_removexattr)
    ops.access = _ACCESS(op_access)
    ops.chmod = _CHMOD(op_chmod)
    ops.chown = _CHOWN(op_chown)
    ops.utimens = _UTIMENS(op_utimens)

    args = [b"swtpu-mount", mountpoint.encode()]
    if foreground:
        args.append(b"-f")
    # use_ino: report the handlers' st_ino (hardlink sets share one inode
    # number) instead of kernel-assigned per-path inodes
    opts = [f"fsname={fsname}", "big_writes", "max_read=131072", "use_ino"]
    if allow_other:
        opts.append("allow_other")
    args += [b"-o", ",".join(opts).encode()]
    argv = (ctypes.c_char_p * len(args))(*args)

    lib.fuse_main_real.restype = ctypes.c_int
    return lib.fuse_main_real(len(args), argv, ctypes.byref(ops),
                              ctypes.sizeof(ops), None)
