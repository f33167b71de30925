"""The port's remote mounts (seaweedfs_tpu_torch/remote/remote_mount.py,
shell/remote_commands.py and the filer's read-through) against the JAX
package's, on the CPU.

A port filer and a JAX filer over one cluster of the port
(tests/torch_cluster.py, device="cpu"), and three remotes, each a stand-in
in the repo: `local:` (storage/backend.LocalDirRemote), `azure:`
(utils/mini_azure) and `gcs-json:` (utils/mini_gcs). On each remote: the
same seeded objects mounted by each package give byte-equal
`extended["remote"]` entries and a byte-equal /etc/remote/mount.json;
read_remote, cache, uncache and meta.sync behave alike (the port's
meta.sync keeps a cached entry only while the object's version is the
same); the filer's HTTP
GET (whole and ranged) of an uncached entry returns the remote's bytes.
The shell's remote.* commands print the reference's lines;
remote.mount.buckets mounts each bucket of a `local:` root. Two faults of
the reference, fixed in the port: `_load_mappings` returned {} on a failed
read, so the next mount wiped every other mapping (the port raises); its
FilerClient read an uncached remote entry as zeros (the port reads the
remote through). Exact comparisons; no tolerance applies."""

import hashlib
import http.client
import io

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.client.filer_client import FilerClient as RefFilerClient
from seaweedfs_tpu.filer.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.remote import remote_mount as ref_rm
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu.shell import remote_commands as _ref_rc  # noqa: F401
from seaweedfs_tpu_torch.client.filer_client import FilerClient
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.remote import remote_mount as rm
from seaweedfs_tpu_torch.shell import commands
from seaweedfs_tpu_torch.shell import remote_commands as _rc  # noqa: F401
from seaweedfs_tpu_torch.storage.backend import open_remote
from seaweedfs_tpu_torch.utils.mini_azure import MiniAzure
from seaweedfs_tpu_torch.utils.mini_gcs import MiniGcs


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("remote-mount-cluster"),
                 volume_size_limit_mb=64)
    yield c
    tc.stop(c)


def _filer(cls, cluster):
    return cls(cluster["master"].address, store_spec="memory",
               port=tc.free_port_pair(), chunk_size_mb=1).start()


@pytest.fixture(scope="module")
def filers(cluster):
    port, ref = _filer(FilerServer, cluster), _filer(RefFilerServer, cluster)
    yield {"port": port, "ref": ref}
    port.stop()
    ref.stop()


@pytest.fixture(scope="module")
def stand_ins():
    az, gcs = MiniAzure().start(), MiniGcs().start()
    yield az, gcs
    az.stop()
    gcs.stop()


def _spec(kind, stand_ins, tmp_path, name):
    az, gcs = stand_ins
    if kind == "local":
        return f"local:{tmp_path}/{name}"
    if kind == "azure":
        return f"azure:{az.endpoint}/{name}?{az.account}:{az.key_b64}"
    return f"gcs-json:{gcs.endpoint}/{name}?{gcs.token}"


def _objects(spec, seed, prefix="data/"):
    rng = np.random.default_rng(seed)
    c = open_remote(spec)
    objs = {f"{prefix}f{i:02d}.bin": rng.bytes(int(rng.integers(0, 300_000)))
            for i in range(8)}
    objs[f"{prefix}sub/deep.txt"] = b"deep object\n"
    objs["outside.bin"] = b"not under the prefix"
    for k, v in objs.items():
        c.write_object_bytes(k, v)
    return {k[len(prefix):]: v for k, v in objs.items()
            if k.startswith(prefix)}


def _tree(fs, d):
    """path -> (is_dir, size, mode, remote ref bytes, chunk count)."""
    out = {}
    for e in fs.filer.list_entries(d):
        p = f"{d.rstrip('/')}/{e.name}"
        out[p] = (e.is_directory, e.attributes.file_size,
                  e.attributes.file_mode, bytes(e.extended.get("remote", b"")),
                  len(e.chunks))
        if e.is_directory:
            out.update(_tree(fs, p))
    return out


def _conf(fs) -> bytes:
    e = fs.filer.find_entry("/etc/remote", "mount.json")
    return fs.read_entry_bytes(e)


def _get(fs, path, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", fs.port, timeout=60)
    try:
        c.request("GET", path, headers=headers or {})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


@pytest.mark.parametrize("kind", ["local", "azure", "gcs"])
def test_mount_cache_uncache_equal_reference(kind, filers, stand_ins,
                                             tmp_path):
    spec = _spec(kind, stand_ins, tmp_path, f"mnt{kind}")
    objs = _objects(spec, 7)
    fs, ref = filers["port"], filers["ref"]
    d = f"/rm/{kind}"
    assert rm.mount_remote(fs, d, spec, "data/") == \
        ref_rm.mount_remote(ref, d, spec, "data/") == len(objs)
    assert _tree(fs, "/rm") == _tree(ref, "/rm")
    assert _conf(fs) == _conf(ref)
    for rel, data in objs.items():
        dd, n = rel.rpartition("/")[0], rel.rpartition("/")[2]
        e = fs.filer.find_entry(f"{d}/{dd}".rstrip("/"), n)
        assert rm.read_remote(e) == data
        assert rm.read_remote(e, 5, 1000) == data[5:1005]
        st, body = _get(fs, f"{d}/{rel}")
        assert (st, body) == (200, data)
        if len(data) > 3000:
            st, body = _get(fs, f"{d}/{rel}", {"Range": "bytes=1000-2999"})
            assert (st, body) == (206, data[1000:3000])
            assert (st, body) == _get(ref, f"{d}/{rel}",
                                      {"Range": "bytes=1000-2999"})
    # cache puts chunks into volumes; the entries stay equal
    big = max(objs, key=lambda k: len(objs[k]))
    for f in (fs, ref):
        (rm if f is fs else ref_rm).cache_remote(f, f"{d}/{big}")
    assert _tree(fs, "/rm") == _tree(ref, "/rm")
    assert _tree(fs, "/rm")[f"{d}/{big}"][4] > 0
    assert _get(fs, f"{d}/{big}") == (200, objs[big])
    for f in (fs, ref):
        (rm if f is fs else ref_rm).uncache_remote(f, f"{d}/{big}")
    assert _tree(fs, "/rm") == _tree(ref, "/rm")
    assert _tree(fs, "/rm")[f"{d}/{big}"][4] == 0
    assert _get(fs, f"{d}/{big}") == (200, objs[big])
    # the remote changes; a second mount (meta.sync) shows both changes
    c = open_remote(spec)
    c.write_object_bytes("data/new.bin", b"added later")
    c.delete_object("data/f00.bin")
    for f in (fs, ref):
        (rm if f is fs else ref_rm).mount_remote(f, d, spec, "data/")
    mine, theirs = _tree(fs, "/rm"), _tree(ref, "/rm")
    # the removed object's entry stays in the reference's tree only (see
    # test_meta_sync_keeps_the_cache_and_drops_removed_objects)
    assert f"{d}/f00.bin" in theirs and f"{d}/f00.bin" not in mine
    theirs.pop(f"{d}/f00.bin")
    assert mine == theirs
    assert _get(fs, f"{d}/new.bin") == (200, b"added later")
    # unmount leaves no entry and keeps the other mappings
    for f, mod in ((fs, rm), (ref, ref_rm)):
        mod.mount_remote(f, "/rm/other", spec, "data/sub/")
        mod.unmount_remote(f, d)
        assert f.filer.find_entry("/rm", kind) is None
        assert set(mod._load_mappings(f)) == {"/rm/other"}
        mod.unmount_remote(f, "/rm/other")
    assert _conf(fs) == _conf(ref)


def _shell(mod, filer, *lines):
    env = mod.CommandEnv.__new__(mod.CommandEnv)
    env.out = io.StringIO()
    env.option = {"filer": filer.url}
    for ln in lines:
        mod.run_command(env, ln)
    return env.out.getvalue()


def test_shell_remote_commands_print_the_references_lines(filers, tmp_path):
    spec = f"local:{tmp_path}/shell"
    objs = _objects(spec, 11)
    root = tmp_path / "buckets"
    for b in ("alpha", "beta", "gamma"):
        (root / b).mkdir(parents=True)
        (root / b / "x.txt").write_bytes(b.encode() * 10)
    script = ["remote.configure",
              f"remote.mount -dir /sh -remote {spec} -prefix data/",
              "remote.configure",
              "remote.cache -path /sh/f01.bin",
              "remote.uncache -path /sh/f01.bin",
              "remote.meta.sync -dir /sh",
              "remote.meta.sync -dir /nowhere",
              f"remote.mount.buckets -remote {root} -bucketPattern [ab]*",
              f"remote.mount.buckets -remote local:{root} -apply",
              "remote.mount.buckets",
              "remote.unmount -dir /sh",
              "remote.configure"]
    outs = [_shell(mod, filers[k], *script)
            for mod, k in ((commands, "port"), (ref_commands, "ref"))]
    assert outs[0] == outs[1]
    assert f"mounted {spec} at /sh: {len(objs)} entries" in outs[0]
    assert "/buckets/beta -> local:" in outs[0]
    fs = filers["port"]
    assert _get(fs, "/buckets/gamma/x.txt") == (200, b"gamma" * 10)
    assert fs.filer.find_entry("/", "sh") is None


def test_failed_mapping_read_wipes_in_reference_raises_in_port(
        filers, tmp_path, monkeypatch):
    """The reference's _load_mappings returns {} when the mapping file
    cannot be read; its mount_remote then saves {} plus one mapping and
    every other mount's mapping is gone. The port's raises and keeps the
    table."""
    spec = f"local:{tmp_path}/wipe"
    _objects(spec, 3)
    for f, mod in ((filers["port"], rm), (filers["ref"], ref_rm)):
        f.filer.delete_entry("/etc/remote", "mount.json")
        mod.mount_remote(f, "/w/a", spec, "data/")
        mod.mount_remote(f, "/w/b", spec, "data/sub/")
        before = _conf(f)
        real = f.read_entry_bytes

        def failing(entry, *a, real=real, **kw):
            if entry.name == "mount.json":
                raise OSError("volume unreachable")
            return real(entry, *a, **kw)

        monkeypatch.setattr(f, "read_entry_bytes", failing)
        if mod is rm:
            with pytest.raises(OSError):
                mod.mount_remote(f, "/w/c", spec, "data/")
            with pytest.raises(OSError):
                mod.unmount_remote(f, "/w/a")
        else:
            mod.mount_remote(f, "/w/c", spec, "data/")
        monkeypatch.undo()
        if mod is rm:
            assert _conf(f) == before
            assert set(mod._load_mappings(f)) == {"/w/a", "/w/b"}
        else:
            assert set(mod._load_mappings(f)) == {"/w/c"}  # a and b wiped
    # a file that is not a mapping table raises too; legacy flat JSON loads
    fs = filers["port"]
    fs.write_file(rm.MOUNT_CONF, b"[1, 2]")
    with pytest.raises(ValueError):
        rm._load_mappings(fs)
    fs.write_file(rm.MOUNT_CONF, b'{"/old": {"spec": "local:/x", '
                                 b'"prefix": ""}}')
    assert rm._load_mappings(fs) == ref_rm._load_mappings(fs) == {
        "/old": {"spec": "local:/x", "prefix": ""}}
    for f in (fs, filers["ref"]):
        f.filer.delete_entry("/etc/remote", "mount.json")
        f.filer.delete_entry("/", "w", is_recursive=True)


def test_meta_sync_keeps_the_cache_and_drops_removed_objects(filers,
                                                            tmp_path):
    """remote.meta.sync mounts the directory again. The reference's makes
    every entry anew: a cached entry loses its chunks, and the entry of an
    object removed from the remote stays, so its read fails. The port's
    keeps an unchanged entry with its chunks and removes the entry of a
    removed object; a local file under the mount stays in both."""
    spec = f"local:{tmp_path}/sync"
    objs = _objects(spec, 13)
    said = {}
    for name, mod in (("port", rm), ("ref", ref_rm)):
        f = filers[name]
        mod.mount_remote(f, "/ms", spec, "data/")
        mod.cache_remote(f, "/ms/f01.bin")
        f.write_file("/ms/local.txt", b"a local file")
        assert len(f.filer.find_entry("/ms", "f01.bin").chunks) > 0
    open_remote(spec).delete_object("data/f02.bin")
    for name, mod in (("port", rm), ("ref", ref_rm)):
        f = filers[name]
        n = mod.mount_remote(f, "/ms", spec, "data/")
        said[name] = (n, len(f.filer.find_entry("/ms", "f01.bin").chunks),
                      f.filer.find_entry("/ms", "f02.bin") is not None,
                      _get(f, "/ms/f01.bin"), _get(f, "/ms/local.txt"))
        if name == "ref":
            st, _ = _get(f, "/ms/f02.bin")
            assert st != 200  # the stale entry's read fails
        else:
            assert _get(f, "/ms/f02.bin")[0] == 404
        mod.unmount_remote(f, "/ms")
    assert said["port"] == (len(objs) - 1, said["port"][1], False,
                            (200, objs["f01.bin"]), (200, b"a local file"))
    assert said["port"][1] > 0
    assert said["ref"][:3] == (len(objs) - 1, 0, True)


@pytest.mark.parametrize("kind", ["local", "azure", "gcs"])
def test_meta_sync_reads_an_object_overwritten_in_place(kind, filers,
                                                        stand_ins, tmp_path):
    """A cached object overwritten on the remote with new bytes of the same
    size: its version changes, so remote.meta.sync makes its entry anew and
    it reads the new bytes over the filer's HTTP and through a FilerClient,
    then caches them; an unchanged cached object keeps its chunks."""
    spec = _spec(kind, stand_ins, tmp_path, f"ow{kind}")
    objs = _objects(spec, 19)
    fs = filers["port"]
    d = f"/ow/{kind}"
    changed, kept = sorted((k for k in objs if "/" not in k),
                           key=lambda k: len(objs[k]))[-2:]
    rm.mount_remote(fs, d, spec, "data/")
    for rel in (changed, kept):
        rm.cache_remote(fs, f"{d}/{rel}")
        assert fs.filer.find_entry(d, rel).chunks
    new = (np.frombuffer(objs[changed], np.uint8) ^ 0xFF).tobytes()
    open_remote(spec).write_object_bytes(f"data/{changed}", new)
    assert rm.mount_remote(fs, d, spec, "data/") == len(objs)
    assert not fs.filer.find_entry(d, changed).chunks
    assert fs.filer.find_entry(d, kept).chunks
    assert _get(fs, f"{d}/{changed}") == (200, new)
    assert _get(fs, f"{d}/{kept}") == (200, objs[kept])
    fc = FilerClient(fs.url)
    try:
        assert fc.read_entry_bytes(fc.filer.find_entry(d, changed)) == new
        rm.cache_remote(fc, f"{d}/{changed}")
        e = fc.filer.find_entry(d, changed)
        assert e.chunks and fc.read_entry_bytes(e) == new
        assert _get(fs, f"{d}/{changed}") == (200, new)
        # cached anew and unchanged since: the next meta.sync keeps it
        rm.mount_remote(fs, d, spec, "data/")
        assert fc.filer.find_entry(d, changed).chunks
    finally:
        fc.close()
        rm.unmount_remote(fs, d)


def test_filer_client_reads_an_uncached_entry_through(filers, tmp_path):
    """Over a FilerClient (as a mount, the FTP gateway or the sync verbs
    read), an uncached remote entry reads as the remote's bytes in the
    port; the reference's client returns zeros of the entry's size."""
    spec = f"local:{tmp_path}/fc"
    objs = _objects(spec, 5)
    fs = filers["port"]
    rm.mount_remote(fs, "/fc", spec, "data/")
    fc, ref_fc = FilerClient(fs.url), RefFilerClient(fs.url)
    try:
        for rel, data in objs.items():
            d, _, n = f"/fc/{rel}".rpartition("/")
            e = fc.filer.find_entry(d, n)
            assert fc.read_entry_bytes(e) == data
            assert b"".join(fc.iter_entry_bytes(e, window=4096)) == data
            assert fc.read_entry_bytes(e, 3, 7) == data[3:10]
            assert ref_fc.read_entry_bytes(e) == bytes(len(data))
        assert hashlib.sha256(fc.read_entry_bytes(fc.filer.find_entry(
            "/fc", "f03.bin"))).hexdigest() == hashlib.sha256(
            objs["f03.bin"]).hexdigest()
    finally:
        fc.close()
        ref_fc.close()
        rm.unmount_remote(fs, "/fc")


@pytest.mark.parametrize("kind", ["azure", "gcs"])
def test_mount_buckets_needs_a_remote_that_lists_buckets(kind, filers,
                                                         stand_ins,
                                                         tmp_path):
    """remote.mount.buckets lists the remote's buckets: `local:` (one a
    subdirectory) and the S3 family do. The Azure and GCS clients of both
    packages are bound to one container or bucket and list none, so both
    shells refuse alike and mount nothing."""
    spec = _spec(kind, stand_ins, tmp_path, f"bk{kind}")
    _objects(spec, 17)
    for mod, name in ((commands, "port"), (ref_commands, "ref")):
        with pytest.raises(NotImplementedError):
            _shell(mod, filers[name],
                   f"remote.mount.buckets -remote {spec} -apply")
        assert filers[name].filer.find_entry("/", "buckets") is None or \
            not [e for e in filers[name].filer.list_entries("/buckets")
                 if e.name.startswith("bk")]
