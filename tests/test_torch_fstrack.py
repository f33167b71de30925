"""The port's recording VFS shim (seaweedfs_tpu_torch/utils/fstrack.py)
against the JAX package's: one workload over builtins.open (binary, text,
append), the raw os.* fd path (os.open/write/pwrite/ftruncate/fsync/
close), renames, a directory fsync, an unlink, a truncate by path and a
mark gives the same op trace under either shim; pwrites from worker
threads on fds opened through the patched os.open, and a file object's
truncate, are recorded; paths outside the scope are not; uninstall puts
every patched function back."""

import builtins
import concurrent.futures as cf
import os

import pytest

from seaweedfs_tpu.utils import fstrack as ref_fstrack
from seaweedfs_tpu_torch.utils import fstrack

SHIMS = {"port": fstrack, "ref": ref_fstrack}


def _workload(root):
    j = lambda n: os.path.join(root, n)  # noqa: E731
    with open(j("a.bin"), "wb") as f:
        f.write(b"hello")
        f.write(b"world")
        f.truncate(8)
        f.flush()
        os.fsync(f.fileno())
    with open(j("t.txt"), "w") as f:
        f.write("ab")
        f.writelines(["cd", "ef"])
    with open(j("a.bin"), "ab") as f:
        f.write(b"yy")
    fd = os.open(j("fd.bin"), os.O_CREAT | os.O_WRONLY)
    os.write(fd, b"abc")
    os.pwrite(fd, b"XY", 10)
    os.ftruncate(fd, 6)
    os.fsync(fd)
    os.close(fd)
    os.truncate(j("t.txt"), 3)
    with open(j("x.tmp"), "wb") as f:
        f.write(b"v")
    os.replace(j("x.tmp"), j("x"))
    os.rename(j("x"), j("y"))
    dfd = os.open(root, os.O_RDONLY)
    os.fsync(dfd)
    os.close(dfd)
    os.unlink(j("fd.bin"))
    with open(j("t.txt"), "w") as f:  # an existing file: trunc, not create
        f.write("z")


def _trace(shim, root, work, *args):
    shim.install()
    try:
        shim.start_trace(root)
        work(root, *args)
        shim.mark("ack", key=7, sha="cafe")
        ops = shim.stop_trace()
    finally:
        shim.uninstall()
    rel = lambda p: os.path.relpath(p, root) if p else p  # noqa: E731
    return [(o.seq, o.kind, rel(o.path), o.offset, bytes(o.data), o.length,
             rel(o.dst), o.label, o.meta) for o in ops]


def test_same_trace_as_reference(tmp_path):
    traces = {}
    for name, shim in SHIMS.items():
        root = tmp_path / name
        root.mkdir()
        traces[name] = _trace(shim, str(root), _workload)
    assert traces["port"] == traces["ref"]
    kinds = {row[1] for row in traces["port"]}
    assert kinds == {"create", "write", "trunc", "fsync", "rename",
                     "fsync_dir", "unlink", "mark"}


def _pool_writes(root, n_files=4, runs=16):
    """The EC seal's shape: shard files made and sized by a file object's
    truncate, opened with os.open, written by pool threads with pwrite,
    fsynced one after another."""
    paths = [os.path.join(root, f"s.ec{i:02d}") for i in range(n_files)]
    for p in paths:
        with open(p, "wb") as f:
            f.truncate(runs * 64)
    fds = [os.open(p, os.O_WRONLY) for p in paths]
    with cf.ThreadPoolExecutor(4, thread_name_prefix="writer") as pool:
        futs = [pool.submit(os.pwrite, fds[i % n_files],
                            bytes([i]) * 64, (i // n_files) * 64)
                for i in range(runs * n_files)]
        for f in futs:
            f.result()
    for fd in fds:
        os.fsync(fd)
        os.close(fd)


@pytest.mark.parametrize("name", list(SHIMS))
def test_pool_pwrites_and_truncates_recorded(tmp_path, name):
    ops = _trace(SHIMS[name], str(tmp_path), _pool_writes)
    writes = [o for o in ops if o[1] == "write"]
    assert len(writes) == 64
    assert {(o[2], o[3]) for o in writes} == {
        (f"s.ec{i % 4:02d}", (i // 4) * 64) for i in range(64)}
    assert [(o[1], o[5]) for o in ops if o[1] == "trunc"] == \
        [("trunc", 1024)] * 4
    assert [o[2] for o in ops if o[1] == "fsync"] == \
        [f"s.ec{i:02d}" for i in range(4)]


def test_out_of_scope_ignored_and_uninstall_restores(tmp_path):
    before = (builtins.open, os.open, os.close, os.write, os.pwrite,
              os.fsync, os.fdatasync, os.rename, os.replace, os.truncate,
              os.ftruncate, os.unlink, os.remove)
    (tmp_path / "in").mkdir()
    (tmp_path / "out").mkdir()

    def elsewhere(root):
        with open(os.path.join(str(tmp_path / "out"), "o.bin"), "wb") as f:
            f.write(b"zz")

    ops = _trace(fstrack, str(tmp_path / "in"), elsewhere)
    assert [o[1] for o in ops] == ["mark"]
    assert not fstrack.installed()
    assert (builtins.open, os.open, os.close, os.write, os.pwrite,
            os.fsync, os.fdatasync, os.rename, os.replace, os.truncate,
            os.ftruncate, os.unlink, os.remove) == before
    fstrack.uninstall()  # idempotent
    with pytest.raises(RuntimeError):
        fstrack.start_trace(str(tmp_path))
