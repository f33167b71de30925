"""The port's FUSE layer (seaweedfs_tpu_torch/mount/) against the JAX
package's, on the CPU; nothing is mounted.

The reference's cases (tests/test_mount.py, 35), rewired to the port's
modules: the inode map, the page chunks and upload pipeline, WeedFS's
operations over a port FilerServer on a cluster of the port
(tests/torch_cluster.py, device="cpu"), the control socket and the quota
in statfs. Then one seeded sequence of WeedFS operations (mkdir, creates
written 128 KiB at a time, an overwrite, rename, truncate, symlink,
hardlink, xattrs, chmod, chown, utimens, unlink, rmdir) through the
reference's WeedFS over its FilerServer, the port's over its own, and the
port's over a port FilerClient: listings, attributes, symlink targets,
xattrs and bytes equal. The control socket: the reference's
`configure_mount` against the port's `serve_mount_control` and the other
way round, the request and the answer byte-equal. Exact comparisons; no
tolerance applies.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.filer.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.mount import control as ref_control
from seaweedfs_tpu.mount.weedfs import WeedFS as RefWeedFS
from seaweedfs_tpu_torch.client.filer_client import FilerClient
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.mount import (ChunkedDirtyPages, InodeToPath,
                                       MemChunk, SwapFileChunk,
                                       UploadPipeline)
from seaweedfs_tpu_torch.mount import control
from seaweedfs_tpu_torch.mount.weedfs import FuseError, WeedFS


class TestInodeMap:
    def test_stable_and_bidirectional(self):
        m = InodeToPath()
        i1 = m.lookup("/a/b.txt")
        assert m.lookup("/a/b.txt") == i1
        assert m.get_path(i1) == "/a/b.txt"
        assert m.get_inode("/a/b.txt") == i1

    def test_root_is_one(self):
        m = InodeToPath()
        assert m.lookup("/") == 1

    def test_move_keeps_inode(self):
        m = InodeToPath()
        i = m.lookup("/x")
        m.move_path("/x", "/y")
        assert m.get_path(i) == "/y"
        assert m.get_inode("/x") is None

    def test_forget_frees_at_zero(self):
        m = InodeToPath()
        i = m.lookup("/f")
        m.lookup("/f")
        m.forget(i, 1)
        assert m.get_path(i) == "/f"  # still one ref
        m.forget(i, 1)
        with pytest.raises(KeyError):
            m.get_path(i)


class TestPageChunks:
    def test_mem_chunk_intervals(self):
        c = MemChunk(100)
        c.write(10, b"aaaa")
        c.write(14, b"bb")
        assert c.intervals == [(10, 16)]
        c.write(50, b"zz")
        assert c.intervals == [(10, 16), (50, 52)]
        assert c.read(10, 6) == b"aaaabb"
        assert c.written == 8

    def test_swapfile_chunk(self, tmp_path):
        c = SwapFileChunk(1024, str(tmp_path))
        c.write(0, b"x" * 512)
        c.write(512, b"y" * 512)
        assert c.written == 1024
        data = c.content()
        assert data[:512] == b"x" * 512 and data[512:] == b"y" * 512
        c.destroy()

    def test_upload_pipeline_order_and_concurrency(self):
        seen = []
        lock = threading.Lock()

        def saver(data, off):
            time.sleep(0.01 if off == 0 else 0)
            with lock:
                seen.append(off)
            return (off, len(data))

        p = UploadPipeline(saver, concurrency=4)
        for i in range(8):
            p.submit(b"d" * 10, i * 10)
        results = p.flush()
        assert results == [(i * 10, 10) for i in range(8)]  # offset order

    def test_dirty_pages_write_read_flush(self):
        saved = []

        def saver(data, off):
            saved.append((off, data))
            return (off, data)

        dp = ChunkedDirtyPages(chunk_size=100, saver=saver)
        dp.write(0, b"a" * 250)  # chunks 0,1 sealed early, 2 partial
        ranges = dp.read(200, 100)
        assert ranges == [(200, b"a" * 50)]
        results = dp.flush()
        offs = [o for o, _ in results]
        assert offs == [0, 100, 200]
        assert b"".join(d for _, d in results) == b"a" * 250

    def test_dirty_pages_sparse(self):
        """Sparse writes upload only the written intervals — holes are
        never zero-filled (they may cover live file data)."""
        dp = ChunkedDirtyPages(chunk_size=100, saver=lambda d, o: (o, d))
        dp.write(150, b"zz")
        dp.write(20, b"qq")
        out = dp.flush()
        assert out == [(20, b"qq"), (150, b"zz")]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("mount-cluster"),
                 volume_size_limit_mb=64)
    yield c
    tc.stop(c)


def _filer(cls, cluster):
    return cls(cluster["master"].address, store_spec="memory",
               port=tc.free_port_pair(), chunk_size_mb=1).start()


@pytest.fixture(scope="module")
def port_filer(cluster):
    fs = _filer(FilerServer, cluster)
    yield fs
    fs.stop()


@pytest.fixture(scope="module")
def wfs(port_filer):
    """The reference cases' fixture: the port's WeedFS over the port's
    filer in process."""
    w = WeedFS(port_filer, chunk_size_mb=1, subscribe_meta=True)
    yield w
    w.destroy()


class TestWeedFS:
    def test_mkdir_readdir(self, wfs):
        wfs.mkdir("/docs")
        attr = wfs.getattr("/docs")
        assert attr["st_mode"] & 0o170000 == 0o040000  # S_IFDIR
        assert "docs" in wfs.readdir("/")

    def test_create_write_read(self, wfs):
        fh = wfs.create("/docs/hello.txt")
        assert wfs.write(fh, 0, b"hello mount") == 11
        # read-your-writes before flush
        assert wfs.read(fh, 0, 11) == b"hello mount"
        wfs.flush(fh)
        wfs.release(fh)
        # reopen and read from storage
        fh2 = wfs.open("/docs/hello.txt")
        assert wfs.read(fh2, 0, 11) == b"hello mount"
        assert wfs.read(fh2, 6, 5) == b"mount"
        wfs.release(fh2)
        assert wfs.getattr("/docs/hello.txt")["st_size"] == 11

    def test_multi_chunk_file(self, wfs):
        payload = bytes(range(256)) * 4096 * 3  # 3 MB, 1 MB chunks
        fh = wfs.create("/docs/big.bin")
        mid = len(payload) // 2
        wfs.write(fh, 0, payload[:mid])
        wfs.write(fh, mid, payload[mid:])
        wfs.release(fh)  # release implies flush
        fh = wfs.open("/docs/big.bin")
        got = wfs.read(fh, 0, len(payload))
        assert got == payload
        # random offsets
        assert wfs.read(fh, 1_000_000, 1000) == payload[1_000_000:1_001_000]
        wfs.release(fh)
        entry = wfs._entry("/docs/big.bin")
        assert len(entry.chunks) >= 3  # chunked at 1 MB

    def test_overwrite_middle(self, wfs):
        fh = wfs.create("/docs/patch.bin")
        wfs.write(fh, 0, b"A" * 1000)
        wfs.release(fh)
        fh = wfs.open("/docs/patch.bin")
        wfs.write(fh, 100, b"B" * 50)
        wfs.flush(fh)
        got = wfs.read(fh, 0, 1000)
        wfs.release(fh)
        assert got[:100] == b"A" * 100
        assert got[100:150] == b"B" * 50
        assert got[150:] == b"A" * 850

    def test_rename_and_unlink(self, wfs):
        fh = wfs.create("/docs/old-name")
        wfs.write(fh, 0, b"data")
        wfs.release(fh)
        ino = wfs.getattr("/docs/old-name")["st_ino"]
        wfs.rename("/docs/old-name", "/docs/new-name")
        assert wfs.inodes.get_path(ino) == "/docs/new-name"
        with pytest.raises(FuseError):
            wfs.getattr("/docs/old-name")
        fh = wfs.open("/docs/new-name")
        assert wfs.read(fh, 0, 4) == b"data"
        wfs.release(fh)
        wfs.unlink("/docs/new-name")
        with pytest.raises(FuseError):
            wfs.getattr("/docs/new-name")

    def test_rmdir_nonempty_fails(self, wfs):
        wfs.mkdir("/full")
        fh = wfs.create("/full/x")
        wfs.release(fh)
        with pytest.raises(FuseError) as ei:
            wfs.rmdir("/full")
        assert ei.value.errno == 39  # ENOTEMPTY
        wfs.unlink("/full/x")
        wfs.rmdir("/full")

    def test_truncate(self, wfs):
        fh = wfs.create("/trunc.bin")
        wfs.write(fh, 0, b"0123456789" * 100)
        wfs.release(fh)
        wfs.truncate("/trunc.bin", 10)
        assert wfs.getattr("/trunc.bin")["st_size"] == 10
        fh = wfs.open("/trunc.bin")
        assert wfs.read(fh, 0, 100) == b"0123456789"
        wfs.release(fh)

    def test_truncate_with_unflushed_writes(self, wfs):
        """Dirty pages beyond the new length must not resurrect data."""
        fh = wfs.create("/trunc2.bin")
        wfs.write(fh, 0, b"Z" * 1000)  # unflushed
        wfs.truncate("/trunc2.bin", 10)
        wfs.release(fh)
        assert wfs.getattr("/trunc2.bin")["st_size"] == 10
        fh = wfs.open("/trunc2.bin")
        assert wfs.read(fh, 0, 100) == b"Z" * 10
        wfs.release(fh)

    def test_create_then_readdir_sees_file(self, wfs):
        """create-then-list: the cached dir listing must refresh."""
        wfs.mkdir("/fresh")
        wfs.readdir("/fresh")  # prime (empty) listing
        fh = wfs.create("/fresh/new.txt")
        wfs.release(fh)
        assert "new.txt" in wfs.readdir("/fresh")

    def test_meta_cache_event_sync(self, wfs):
        """A write through the filer (not the mount) becomes visible via
        the metadata subscription."""
        wfs.readdir("/")  # prime the cache
        wfs.fs.write_file("/outside.txt", b"external change")
        tc.wait_until(lambda: wfs.getattr("/outside.txt")["st_size"] == 15,
                   timeout=5, msg="outside write visible through meta sub")
        assert wfs.getattr("/outside.txt")["st_size"] == 15

    def test_statfs(self, wfs):
        st = wfs.statfs()
        assert st["f_bsize"] > 0 and st["f_blocks"] > 0


class TestSymlinkXattrLink:
    """Reference weedfs_symlink.go / weedfs_xattr.go / weedfs_link.go."""

    def test_symlink_readlink(self, wfs):
        fh = wfs.create("/sx/orig.txt")
        wfs.write(fh, 0, b"payload")
        wfs.flush(fh)
        wfs.release(fh)
        attr = wfs.symlink("/sx/orig.txt", "/sx/alias")
        assert attr["st_mode"] & 0o170000 == 0o120000  # S_IFLNK
        assert attr["st_size"] == len("/sx/orig.txt")
        assert wfs.readlink("/sx/alias") == "/sx/orig.txt"
        with pytest.raises(OSError):
            wfs.readlink("/sx/orig.txt")  # EINVAL: not a symlink
        # dangling symlink is legal; target never has to exist
        wfs.symlink("/nowhere", "/sx/dangling")
        assert wfs.readlink("/sx/dangling") == "/nowhere"

    def test_hardlink_shares_content_and_counts(self, wfs):
        fh = wfs.create("/hl/a.txt")
        wfs.write(fh, 0, b"shared bytes")
        wfs.flush(fh)
        wfs.release(fh)
        attr = wfs.link("/hl/a.txt", "/hl/b.txt")
        assert attr["st_mode"] & 0o170000 == 0o100000  # regular file
        assert wfs.getattr("/hl/a.txt")["st_nlink"] == 2
        assert wfs.getattr("/hl/b.txt")["st_nlink"] == 2
        fh = wfs.open("/hl/b.txt")
        assert wfs.read(fh, 0, 12) == b"shared bytes"
        wfs.release(fh)
        # write through one name, read through the other
        fh = wfs.open("/hl/b.txt")
        wfs.write(fh, 0, b"SHARED")
        wfs.flush(fh)
        wfs.release(fh)
        fh = wfs.open("/hl/a.txt")
        assert wfs.read(fh, 0, 12) == b"SHARED bytes"
        wfs.release(fh)
        # unlink one name: the other keeps the bytes, nlink drops
        wfs.unlink("/hl/a.txt")
        assert wfs.getattr("/hl/b.txt")["st_nlink"] == 1
        fh = wfs.open("/hl/b.txt")
        assert wfs.read(fh, 0, 12) == b"SHARED bytes"
        wfs.release(fh)

    def test_link_errors(self, wfs):
        with pytest.raises(OSError):
            wfs.link("/hl/missing", "/hl/x")
        wfs.mkdir("/hl/dir")
        with pytest.raises(OSError):
            wfs.link("/hl/dir", "/hl/dirlink")  # no directory hardlinks

    def test_xattr_crud(self, wfs):
        fh = wfs.create("/xa/f.txt")
        wfs.release(fh)
        wfs.setxattr("/xa/f.txt", "user.color", b"blue")
        wfs.setxattr("/xa/f.txt", "user.shape", b"round")
        assert wfs.getxattr("/xa/f.txt", "user.color") == b"blue"
        assert wfs.listxattr("/xa/f.txt") == ["user.color", "user.shape"]
        wfs.setxattr("/xa/f.txt", "user.color", b"red")  # overwrite
        assert wfs.getxattr("/xa/f.txt", "user.color") == b"red"
        wfs.removexattr("/xa/f.txt", "user.shape")
        assert wfs.listxattr("/xa/f.txt") == ["user.color"]
        with pytest.raises(OSError):
            wfs.getxattr("/xa/f.txt", "user.shape")  # ENODATA
        with pytest.raises(OSError):
            wfs.removexattr("/xa/f.txt", "user.gone")

    def test_xattr_flags(self, wfs):
        fh = wfs.create("/xa/g.txt")
        wfs.release(fh)
        wfs.setxattr("/xa/g.txt", "user.k", b"v", flags=1)  # XATTR_CREATE
        with pytest.raises(OSError):
            wfs.setxattr("/xa/g.txt", "user.k", b"v2", flags=1)  # EEXIST
        wfs.setxattr("/xa/g.txt", "user.k", b"v2", flags=2)  # XATTR_REPLACE
        assert wfs.getxattr("/xa/g.txt", "user.k") == b"v2"
        with pytest.raises(OSError):
            wfs.setxattr("/xa/g.txt", "user.new", b"v", flags=2)  # ENODATA

    def test_xattr_survives_content_writes(self, wfs):
        fh = wfs.create("/xa/h.txt")
        wfs.write(fh, 0, b"v1")
        wfs.flush(fh)
        wfs.release(fh)
        wfs.setxattr("/xa/h.txt", "user.tag", b"keep")
        fh = wfs.open("/xa/h.txt")
        wfs.write(fh, 0, b"v2")
        wfs.flush(fh)
        wfs.release(fh)
        assert wfs.getxattr("/xa/h.txt", "user.tag") == b"keep"

    def test_xattr_on_directory(self, wfs):
        wfs.mkdir("/xa/d")
        wfs.setxattr("/xa/d", "user.role", b"archive")
        assert wfs.getxattr("/xa/d", "user.role") == b"archive"

    def test_xattr_does_not_touch_mtime(self, wfs):
        fh = wfs.create("/xa/mt.txt")
        wfs.write(fh, 0, b"x")
        wfs.flush(fh)
        wfs.release(fh)
        before = wfs.getattr("/xa/mt.txt")["st_mtime"]
        wfs.setxattr("/xa/mt.txt", "user.t", b"v")
        assert wfs.getattr("/xa/mt.txt")["st_mtime"] == before

    def test_link_refuses_to_clobber(self, wfs):
        for p in ("/hl/c1.txt", "/hl/c2.txt"):
            fh = wfs.create(p)
            wfs.release(fh)
        with pytest.raises(OSError):
            wfs.link("/hl/c1.txt", "/hl/c2.txt")  # EEXIST


class TestMountControl:
    """mount.configure control socket (reference command_mount_configure.go
    + mount_pb Configure)."""

    def test_configure_roundtrip(self, tmp_path):
        from seaweedfs_tpu_torch.mount.control import (configure_mount,
                                                 mount_socket_path,
                                                 serve_mount_control)

        class FakeWFS:
            collection_capacity = 0

            def configure(self, cap):
                self.collection_capacity = cap

        wfs = FakeWFS()
        mnt = str(tmp_path / "mnt")
        stop = serve_mount_control(wfs, mount_socket_path(mnt))
        try:
            resp = configure_mount(mnt, 128 << 20)
            assert resp["ok"] and resp["collection_capacity"] == 128 << 20
            assert wfs.collection_capacity == 128 << 20
            # shell command path
            import io

            from seaweedfs_tpu_torch.shell import remote_commands  # noqa: F401
            from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
            out = io.StringIO()
            env = CommandEnv.__new__(CommandEnv)
            env.out = out
            env.option = {}
            run_command(env, f"mount.configure -dir {mnt} -quotaMB 64")
            assert "64 MB" in out.getvalue()
            assert wfs.collection_capacity == 64 << 20
        finally:
            stop()

    def test_statfs_reflects_quota(self):
        from seaweedfs_tpu_torch.mount.weedfs import WeedFS

        wfs = WeedFS.__new__(WeedFS)
        wfs.chunk_size = 1 << 20
        wfs.collection_capacity = 0
        assert WeedFS.statfs(wfs)["f_blocks"] == 1 << 30
        wfs.configure(64 << 20)

        class _Meta:
            def list(self, d):
                return []
        wfs.meta = _Meta()
        st = WeedFS.statfs(wfs)
        assert st["f_blocks"] == 64
        assert st["f_bfree"] == 64


class TestSetattrFamily:
    """chmod/chown/utimens persist through the filer (weedfs_attr.go)."""

    def test_chmod_persists(self, wfs):
        fh = wfs.create("/sa/f1.txt", mode=0o644)
        wfs.release(fh)
        wfs.chmod("/sa/f1.txt", 0o600)
        assert wfs.getattr("/sa/f1.txt")["st_mode"] & 0o7777 == 0o600

    def test_chown_persists_and_minus_one_skips(self, wfs):
        fh = wfs.create("/sa/f2.txt")
        wfs.release(fh)
        wfs.chown("/sa/f2.txt", 1000, 2000)
        a = wfs.getattr("/sa/f2.txt")
        assert (a["st_uid"], a["st_gid"]) == (1000, 2000)
        wfs.chown("/sa/f2.txt", 0xFFFFFFFF, 3000)  # uid unchanged
        a = wfs.getattr("/sa/f2.txt")
        assert (a["st_uid"], a["st_gid"]) == (1000, 3000)

    def test_utimens_sets_mtime(self, wfs):
        fh = wfs.create("/sa/f3.txt")
        wfs.release(fh)
        wfs.utimens("/sa/f3.txt", None, 1234567890.5)
        assert wfs.getattr("/sa/f3.txt")["st_mtime"] == 1234567890

    def test_setattr_missing_file(self, wfs):
        import pytest as _pytest
        with _pytest.raises(OSError):
            wfs.chmod("/sa/ghost", 0o600)



def test_all_reference_cases_are_present():
    n = sum(1 for name, v in globals().items() if name.startswith("Test")
            for m in vars(v) if m.startswith("test_"))
    assert n == 35


# -- one sequence through both packages ------------------------------------
def _sequence(w, rng):
    """A seeded run of FUSE operations; the bytes each file should hold."""
    want = {}
    w.mkdir("/seq")
    w.mkdir("/seq/d")
    for i, size in enumerate((0, 1, 4095, 131072, 300_001, 2_621_441)):
        data = rng.bytes(size)
        fh = w.create(f"/seq/d/f{i}.bin")
        for off in range(0, size, 128 << 10):  # the kernel's max_write
            w.write(fh, off, data[off:off + (128 << 10)])
        w.release(fh)
        want[f"/seq/d/f{i}.bin"] = data
    patch = rng.bytes(70_000)
    fh = w.open("/seq/d/f5.bin")
    w.write(fh, 1_000_000, patch)
    w.release(fh)
    b = bytearray(want["/seq/d/f5.bin"])
    b[1_000_000:1_070_000] = patch
    want["/seq/d/f5.bin"] = bytes(b)
    w.rename("/seq/d/f2.bin", "/seq/moved.bin")
    want["/seq/moved.bin"] = want.pop("/seq/d/f2.bin")
    w.truncate("/seq/d/f4.bin", 123_456)
    want["/seq/d/f4.bin"] = want["/seq/d/f4.bin"][:123_456]
    w.symlink("/seq/d/f3.bin", "/seq/link")
    w.symlink("/nowhere", "/seq/dangling")
    w.link("/seq/d/f1.bin", "/seq/hard.bin")
    want["/seq/hard.bin"] = want["/seq/d/f1.bin"]
    w.setxattr("/seq/d/f3.bin", "user.a", b"one")
    w.setxattr("/seq/d/f3.bin", "user.b", rng.bytes(300))
    w.setxattr("/seq/d", "user.dir", b"x")
    w.removexattr("/seq/d/f3.bin", "user.a")
    w.chmod("/seq/d/f0.bin", 0o600)
    w.chown("/seq/d/f0.bin", 1000, 2000)
    w.utimens("/seq/d/f0.bin", None, 1_234_567_890.5)
    w.mkdir("/seq/empty")
    w.rmdir("/seq/empty")
    fh = w.create("/seq/gone.bin")
    w.write(fh, 0, b"x")
    w.release(fh)
    w.unlink("/seq/gone.bin")
    for op in (lambda: w.rmdir("/seq/d"), lambda: w.readlink("/seq/d"),
               lambda: w.link("/seq/d", "/seq/dl"),
               lambda: w.getxattr("/seq/d/f3.bin", "user.a"),
               lambda: w.mkdir("/seq/d"), lambda: w.open("/seq/d")):
        with pytest.raises(OSError) as ei:
            op()
        want.setdefault("errnos", []).append(ei.value.errno)
    return want


def _view(w, want):
    """Everything a FUSE client can observe of the sequence's tree."""
    out = {"errnos": want["errnos"]}

    def walk(d):
        for name in sorted(w.readdir(d)):
            p = f"{d}/{name}"
            a = w.getattr(p)
            mtime = a["st_mtime"] if p == "/seq/d/f0.bin" else None
            row = {k: a[k] for k in ("st_mode", "st_size", "st_uid",
                                     "st_gid", "st_nlink")}
            row["mtime"] = mtime
            row["xattrs"] = {k: w.getxattr(p, k) for k in w.listxattr(p)}
            if a["st_mode"] & 0o170000 == 0o120000:
                row["target"] = w.readlink(p)
            elif a["st_mode"] & 0o170000 == 0o040000:
                walk(p)
            else:
                fh = w.open(p)
                row["data"] = w.read(fh, 0, a["st_size"] + 10)
                row["mid"] = w.read(fh, 131_000, 5_000)
                w.release(fh)
                assert row["data"] == want[p], p
            out[p] = row

    walk("/seq")
    out["statfs"] = w.statfs()
    return out


def test_weedfs_sequence_equals_reference(cluster, port_filer):
    ref_fs = _filer(RefFilerServer, cluster)
    fc = FilerClient(port_filer.url)
    views = {}
    try:
        for name, w in (("ref", RefWeedFS(ref_fs, chunk_size_mb=1,
                                          subscribe_meta=False)),
                        ("port", WeedFS(port_filer, chunk_size_mb=1,
                                        subscribe_meta=False))):
            want = _sequence(w, np.random.default_rng(24))
            views[name] = _view(w, want)
            w.destroy()
        # the port's WeedFS over a FilerClient reads the tree it wrote
        w = WeedFS(fc, chunk_size_mb=1, subscribe_meta=False)
        views["client"] = _view(w, want)
        w.destroy()
    finally:
        fc.close()
        ref_fs.stop()
    assert views["port"] == views["ref"]
    assert views["client"] == views["port"]
    assert views["port"]["/seq/link"]["target"] == "/seq/d/f3.bin"
    assert views["port"]["/seq/hard.bin"]["st_nlink"] == 2


# -- the control socket across packages -------------------------------------
class _Quota:
    collection_capacity = 0

    def configure(self, cap):
        self.collection_capacity = cap


@pytest.mark.parametrize("client,server", [(ref_control, control),
                                           (control, ref_control)],
                         ids=["ref-to-port", "port-to-ref"])
def test_configure_mount_across_packages(tmp_path, client, server):
    mnt = str(tmp_path / "mnt")
    assert client.mount_socket_path(mnt) == server.mount_socket_path(mnt)
    w = _Quota()
    stop = server.serve_mount_control(w, server.mount_socket_path(mnt))
    try:
        assert client.configure_mount(mnt, 96 << 20) == {
            "ok": True, "collection_capacity": 96 << 20}
        assert w.collection_capacity == 96 << 20
        assert client.configure_mount(mnt, 0)["collection_capacity"] == 0
    finally:
        stop()


def _capture_request(mod, mnt: str, cap: int) -> bytes:
    """The bytes one package's configure_mount sends; the answer is the
    frame of ConfigureResponse(collection_capacity=cap)."""
    path = mod.mount_socket_path(mnt)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    got = {}

    def serve():
        conn, _ = srv.accept()
        with conn:
            n = struct.unpack(">I", conn.recv(4))[0]
            body = b""
            while len(body) < n:
                body += conn.recv(n - len(body))
            got["req"] = struct.pack(">I", n) + body
            conn.sendall(b"\x00\x00\x00\x02\x08" + bytes([cap]))

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        assert mod.configure_mount(mnt, cap)["collection_capacity"] == cap
        t.join(10)
    finally:
        srv.close()
        import os
        os.unlink(path)
    return got["req"]


def _answer(mod, mnt: str, req: bytes) -> bytes:
    """The bytes one package's serve_mount_control answers `req` with."""
    stop = mod.serve_mount_control(_Quota(), mod.mount_socket_path(mnt))
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(10)
        c.connect(mod.mount_socket_path(mnt))
        c.sendall(req)
        out = b""
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            b = c.recv(1 << 16)
            if not b:
                break
            out += b
        c.close()
        return out
    finally:
        stop()


def test_control_socket_bytes_equal_reference(tmp_path):
    mnt = str(tmp_path / "m")
    reqs = [_capture_request(mod, mnt, 100) for mod in (ref_control, control)]
    assert reqs[0] == reqs[1] == b"\x00\x00\x00\x02\x08\x64"
    for req in (reqs[0], b"\x00\x00\x00\x00", b"\x00\x00\x00\x02\xff\xff"):
        assert _answer(control, mnt, req) == _answer(ref_control, mnt, req)


@pytest.mark.parametrize("name", ["mount", "remote"])
def test_proto_and_pb2_are_the_references(name):
    """pb/<name>.proto and its pb2 are byte-equal copies with the same
    serialized descriptor, so the control socket's frames and the mapping
    table parse alike in both packages."""
    import importlib
    import pathlib
    ref = importlib.import_module(f"seaweedfs_tpu.pb.{name}_pb2")
    mine = importlib.import_module(f"seaweedfs_tpu_torch.pb.{name}_pb2")
    assert mine.DESCRIPTOR.serialized_pb == ref.DESCRIPTOR.serialized_pb
    for f in (f"{name}.proto", f"{name}_pb2.py"):
        assert (pathlib.Path(mine.__file__).parent / f).read_bytes() == \
            (pathlib.Path(ref.__file__).parent / f).read_bytes()


def test_pb_build_compiles_the_ports_protos(monkeypatch, capsys):
    """pb/build.py runs protoc over the port's own pb/ (the reference's
    .proto files, copied), writing beside them."""
    import pathlib

    from seaweedfs_tpu.pb import build as ref_build
    from seaweedfs_tpu_torch.pb import build
    calls = []
    monkeypatch.setattr(build.subprocess, "run",
                        lambda cmd, check: calls.append(cmd))
    build.build()
    here = pathlib.Path(build.__file__).parent
    assert calls[0][:3] == ["protoc", f"-I{here}", f"--python_out={here}"]
    protos = [pathlib.Path(p).name for p in calls[0][3:]]
    assert protos == sorted(p.name for p in
                            pathlib.Path(ref_build.__file__).parent.glob(
                                "*.proto"))
    assert capsys.readouterr().out.strip() == \
        f"generated {len(protos)} proto modules in {here}"
