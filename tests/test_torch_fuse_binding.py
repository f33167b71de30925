"""The port's ctypes libfuse 2.9 binding (seaweedfs_tpu_torch/mount/
fuse_binding.py) against the JAX package's, without a mount.

The structures' sizes and field offsets equal the reference's. Then
`fuse_loop` runs with libfuse replaced by a stand-in whose
`fuse_main_real` calls the registered callbacks the way the kernel's
requests would: each answer (a return code, and the stat, statvfs, read,
readlink, readdir and xattr buffers it filled) equals the reference
binding's over the same handlers, a FuseError becomes -errno and any
other exception -EIO. Exact comparisons; no tolerance applies."""

import ctypes
import errno

import pytest

from seaweedfs_tpu.mount import fuse_binding as ref_binding
from seaweedfs_tpu_torch.mount import fuse_binding
from seaweedfs_tpu_torch.mount.weedfs import FuseError

_STRUCTS = ("c_timespec", "c_stat", "c_statvfs", "fuse_file_info",
            "fuse_operations")


@pytest.mark.parametrize("name", _STRUCTS)
def test_structure_layout_equals_reference(name):
    mine, ref = getattr(fuse_binding, name), getattr(ref_binding, name)
    assert ctypes.sizeof(mine) == ctypes.sizeof(ref)
    assert [(f[0], getattr(mine, f[0]).offset) for f in mine._fields_] == \
        [(f[0], getattr(ref, f[0]).offset) for f in ref._fields_]


class _Handlers:
    """A two-file tree; every miss raises FuseError(ENOENT)."""

    def __init__(self):
        self.files = {"/a.txt": b"hello fuse", "/b.bin": bytes(range(200))}
        self.calls = []

    def getattr(self, path):
        if path == "/":
            return {"st_mode": 0o40755, "st_nlink": 2, "st_mtime": 5.25}
        if path == "/boom":
            raise RuntimeError("not an errno")
        if path == "/link":
            return {"st_mode": 0o120777, "st_size": 6}
        if path not in self.files:
            raise FuseError(errno.ENOENT, path)
        return {"st_mode": 0o100644, "st_size": len(self.files[path]),
                "st_uid": 1000, "st_gid": 1001, "st_mtime": 1.5,
                "st_ino": 7}

    def readdir(self, path):
        return sorted(p[1:] for p in self.files)

    def open(self, path):
        self.getattr(path)
        return 3 if path == "/a.txt" else 4

    def read(self, fh, offset, size):
        data = self.files["/a.txt" if fh == 3 else "/b.bin"]
        return data[offset:offset + size]

    def write(self, fh, offset, data):
        self.calls.append(("write", fh, offset, data))
        return len(data)

    def readlink(self, path):
        return "/a.txt"

    def statfs(self):
        return {"f_bsize": 4 << 20, "f_blocks": 24, "f_bfree": 20,
                "f_bavail": 20, "f_files": 1 << 20, "f_ffree": 1 << 20}

    def getxattr(self, path, name):
        if name != "user.k":
            raise FuseError(61, name)
        return b"value"

    def listxattr(self, path):
        return ["user.k", "user.z"]

    def mkdir(self, path, mode):
        raise FuseError(errno.EEXIST, path)

    def unlink(self, path):
        raise FuseError(errno.EACCES, path)


def _drive(binding, monkeypatch) -> list:
    """The callbacks' answers, as a kernel's requests would get them."""
    out = []

    class Lib:
        class fuse_main_real:  # noqa: N801 — libfuse's symbol
            restype = None

            def __new__(cls, argc, argv, ops_ref, size, user):
                ops = ops_ref._obj
                out.append(("argv", [argv[i] for i in range(argc)], size))
                st = binding.c_stat()
                for p in (b"/a.txt", b"/missing", b"/boom", b"/", b"/link"):
                    rc = ops.getattr(p, ctypes.pointer(st))
                    out.append(("getattr", p, rc, bytes(st)))
                names = []
                filler = binding.fuse_fill_dir_t(
                    lambda buf, name, stp, off: names.append(name) or 0)
                out.append(("readdir", ops.readdir(b"/", None, filler, 0,
                                                   None), names))
                fi = binding.fuse_file_info()
                out.append(("open", ops.open(b"/b.bin", ctypes.pointer(fi)),
                            fi.fh))
                buf = ctypes.create_string_buffer(64)
                out.append(("read", ops.read(b"/b.bin", buf, 64, 100,
                                             ctypes.pointer(fi)), buf.raw))
                data = ctypes.create_string_buffer(b"xyz", 3)
                out.append(("write", ops.write(b"/b.bin", data, 3, 9,
                                               ctypes.pointer(fi))))
                out.append(("open-missing",
                            ops.open(b"/nope", ctypes.pointer(fi))))
                link = ctypes.create_string_buffer(4)
                out.append(("readlink", ops.readlink(b"/link", link, 4),
                            link.raw))
                sv = binding.c_statvfs()
                out.append(("statfs", ops.statfs(b"/", ctypes.pointer(sv)),
                            bytes(sv)))
                xb = ctypes.create_string_buffer(16)
                out.append(("getxattr", ops.getxattr(b"/a.txt", b"user.k",
                                                     None, 0),
                            ops.getxattr(b"/a.txt", b"user.k", xb, 16),
                            xb.raw,
                            ops.getxattr(b"/a.txt", b"user.k", xb, 2),
                            ops.getxattr(b"/a.txt", b"user.x", xb, 16)))
                lb = ctypes.create_string_buffer(32)
                out.append(("listxattr", ops.listxattr(b"/a.txt", None, 0),
                            ops.listxattr(b"/a.txt", lb, 32), lb.raw))
                out.append(("mkdir", ops.mkdir(b"/a.txt", 0o755)))
                out.append(("unlink", ops.unlink(b"/a.txt")))
                out.append(("access", ops.access(b"/missing", 0)))
                return 0

    monkeypatch.setattr(binding, "_libfuse", lambda: Lib)
    h = _Handlers()
    assert binding.fuse_loop(h, "/mnt/point", allow_other=True) == 0
    out.append(("writes", h.calls))
    return out


def test_callbacks_answer_as_the_reference(monkeypatch):
    got = _drive(fuse_binding, monkeypatch)
    assert got == _drive(ref_binding, monkeypatch)
    rc = {row[1]: row[2] for row in got if row[0] == "getattr"}
    assert rc == {b"/a.txt": 0, b"/missing": -errno.ENOENT,
                  b"/boom": -errno.EIO, b"/": 0, b"/link": 0}
    by = {row[0]: row[1:] for row in got}
    assert by["read"][0] == 64 and by["read"][1] == bytes(range(100, 164))
    assert by["open-missing"] == (-errno.ENOENT,)
    assert by["mkdir"] == (-errno.EEXIST,) and by["unlink"] == (-errno.EACCES,)
    assert by["readlink"] == (0, b"/a.\x00")
    assert by["getxattr"][:2] == (5, 5) and by["getxattr"][3:] == (
        -errno.ERANGE, -61)
    assert by["writes"] == ([("write", 4, 9, b"xyz")],)
