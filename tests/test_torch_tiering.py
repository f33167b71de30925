"""The port's remote tier of the storage layer (seaweedfs_tpu_torch/storage/
backend.py, the tiered Volume, DiskLocation's tiered load and the scrub's
tiered skip) against the JAX package's on the same files, byte for byte:
the LocalDirRemote client, RemoteDatFile's block cache, open_remote and
bucket_spec, the client sigv4 signer, tiered needle reads and the refusals
that go with a read-only remote .dat."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from seaweedfs_tpu.ec import files as ref_files
from seaweedfs_tpu.s3 import auth as ref_auth
from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage import scrub as ref_scrub
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.storage.disk_location import DiskLocation as RefLocation
from seaweedfs_tpu_torch.ec import files
from seaweedfs_tpu_torch.s3 import auth
from seaweedfs_tpu_torch.storage import backend, scrub, volume
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle

BS = backend.BLOCK_SIZE


def test_block_and_cache_sizes_are_the_reference_s():
    assert (backend.BLOCK_SIZE, backend.CACHE_BLOCKS) == \
        (ref_backend.BLOCK_SIZE, ref_backend.CACHE_BLOCKS) == (256 << 10, 64)


@pytest.mark.parametrize("size", [0, 7000, BS + 3])
def test_local_dir_remote_round_trip(tmp_path, size):
    src = tmp_path / "obj.bin"
    src.write_bytes(np.random.default_rng(size).bytes(size))
    outs = []
    for mod, name in ((backend, "port"), (ref_backend, "ref")):
        r = mod.LocalDirRemote(str(tmp_path / name))
        assert r.write_object("vols/1.dat", str(src)) == size
        assert r.write_object_bytes("vols/2.dat", b"tier-me") == 7
        r.create_bucket("b2")
        dst = tmp_path / f"{name}.back"
        r.read_object_to("vols/1.dat", str(dst))
        outs.append((r.object_size("vols/1.dat"), r.read_object("vols/1.dat", 3, 11),
                     r.list_keys("vols/"), r.list_keys(), r.list_buckets(),
                     dst.read_bytes()))
        r.delete_object("vols/1.dat")
        r.delete_object("vols/1.dat")  # already gone: no error
        r.delete_bucket("b2")
        outs.append((r.list_keys(), r.list_buckets()))
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert outs[0][5] == src.read_bytes()


class _Counting:
    """Wraps a client, counting read_object calls."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def object_size(self, key):
        return self.inner.object_size(key)

    def read_object(self, key, offset, size):
        self.calls += 1
        return self.inner.read_object(key, offset, size)


# (offset, length) reads in order: block edges, spans of several blocks,
# the tail, and a walk of 70 blocks that pushes block 0 out of the 64-block
# LRU before it is read again
_PATTERNS = {
    "edges": [(0, 16), (BS - 5, 10), (2 * BS - 1, 2), (3 * BS, BS), (BS - 1, 2 * BS + 2)],
    "tail": [(-10, -1), (-BS - 7, -1), (0, 0)],
    "lru": [(i * BS + 17, 100) for i in range(70)] + [(20, 50), (69 * BS, 8)],
}


@pytest.mark.parametrize("pattern", sorted(_PATTERNS))
def test_remote_dat_file_matches_reference(tmp_path, pattern):
    payload = np.random.default_rng(3).bytes(71 * BS + 12345)
    (tmp_path / "x.dat").write_bytes(payload)
    got = {}
    for mod in (backend, ref_backend):
        client = _Counting(mod.LocalDirRemote(str(tmp_path)))
        f = mod.RemoteDatFile(client, "x.dat")
        assert f.size == len(payload)
        reads = []
        for off, n in _PATTERNS[pattern]:
            if off < 0:
                f.seek(off, 2)
            else:
                f.seek(off)
            reads.append((f.read(n), f.tell()))
        got[mod] = (reads, client.calls, list(f._cache))
        with pytest.raises(OSError):
            f.write(b"nope")
    assert got[backend] == got[ref_backend]
    for (data, _), (off, n) in zip(got[backend][0], _PATTERNS[pattern]):
        start = off if off >= 0 else len(payload) + off
        assert data == payload[start:start + n if n >= 0 else None]
    if pattern == "lru":  # block 0 was evicted: the reread fetched it again
        assert got[backend][1] == 71 and len(got[backend][2]) == 64


_SPECS = ["local:{tmp}/tier", "{tmp}/plain", "s3:http://h:1/bkt?AK:SK",
          "s3:https://s3.example.com:9000", "b2:http://b2.example/bucket?k:s",
          "gcs:http://storage.example/b", "wasabi:http://w.example:8/b?a:b",
          "minio:http://m.example:9000/data", "s3:bucketless/bkt"]


@pytest.mark.parametrize("spec", _SPECS)
def test_open_remote_and_bucket_spec_match_reference(tmp_path, spec):
    spec = spec.format(tmp=tmp_path)
    assert backend.bucket_spec(spec, "photos") == \
        ref_backend.bucket_spec(spec, "photos")
    if ":" not in spec:
        return
    got, want = backend.open_remote(spec), ref_backend.open_remote(spec)
    assert type(got).__name__ == type(want).__name__ and got.name == want.name
    fields = ("root",) if got.name == "local" else ("endpoint", "bucket", "ak", "sk")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]


@pytest.mark.parametrize("kind", ["azure", "gcs-json"])
def test_unported_remote_kinds_raise(kind):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        backend.open_remote(f"{kind}:https://acct.example/container?k:s")


def test_unknown_remote_kind_raises_like_reference():
    for mod in (backend, ref_backend):
        with pytest.raises(ValueError, match="unknown remote backend"):
            mod.open_remote("ftp:whatever")


_SIGN_CASES = [
    ("GET", "http://h:1/bkt/a/b.dat", {"Range": "bytes=0-99"}, b""),
    ("PUT", "http://h:1/bkt/x y.dat", {}, b"payload" * 100),
    ("GET", "http://h:1/bkt?list-type=2&prefix=v/", {}, b""),
    ("DELETE", "https://s3.example.com/bkt/k", {"x-amz-meta-a": " 1  2 "}, b""),
]


@pytest.mark.parametrize("case", range(len(_SIGN_CASES)))
def test_signer_matches_reference(case):
    method, url, headers, payload = _SIGN_CASES[case]
    for date in ("20240102T030405Z", "20261016T235959Z"):
        got = auth.sign_request_v4(method, url, headers, payload, "AK", "SK",
                                   amz_date=date)
        want = ref_auth.sign_request_v4(method, url, headers, payload, "AK",
                                        "SK", amz_date=date)
        assert got == want and "Signature=" in got["Authorization"]


def test_s3_remote_requests_are_signed_like_reference(monkeypatch):
    """S3Remote's requests (a stand-in `requests` module; nothing leaves the
    process): URL, method, Range and a signature the reference signer
    gives for the same date."""
    sent = []

    class Resp:
        status_code, content, headers = 206, b"0123456789", {"Content-Length": "10"}

    def request(method, url, data=None, headers=None, timeout=None):
        sent.append((method, url, data, headers))
        return Resp()

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(request=request))
    r = backend.open_remote("s3:http://h:1/bkt?AK:SK")
    assert r.read_object("v/1.dat", 5, 10) == b"0123456789"
    assert r.object_size("v/1.dat") == 10
    (m, url, data, hdr), (m2, url2, _, _) = sent
    assert (m, url, data, hdr["Range"], m2, url2) == (
        "GET", "http://h:1/bkt/v/1.dat", None, "bytes=5-14", "HEAD", url)
    want = ref_auth.sign_request_v4("GET", url, {"Range": "bytes=5-14"}, b"",
                                    "AK", "SK", amz_date=hdr["x-amz-date"])
    assert hdr == want


def test_backend_imports_without_requests():
    code = ("import sys; sys.modules['requests'] = None; sys.modules['jax'] = None\n"
            "import seaweedfs_tpu_torch.storage.backend as b\n"
            "import seaweedfs_tpu_torch.storage.store, seaweedfs_tpu_torch.storage.vacuum\n"
            "print(b.open_remote('s3:http://h:1/bkt').bucket)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "bkt"


# -- tiered volumes -------------------------------------------------------------
VID = 6


def _volume(dirname, n=120, seed=2):
    """A port volume of n needles (some overwritten, some deleted), synced;
    returns {id: data} of the live ones."""
    rng = np.random.default_rng(seed)
    os.makedirs(dirname, exist_ok=True)
    v = volume.Volume(str(dirname), "", VID)
    want = {}
    for i in range(1, n + 1):
        want[i] = rng.bytes(int(rng.integers(0, 5000)))
        v.write_needle(Needle(id=i, cookie=i * 7, data=want[i]))
    for i in range(1, n, 9):
        want[i] = rng.bytes(100)
        v.write_needle(Needle(id=i, cookie=i * 7, data=want[i]))
    for i in range(2, n, 11):
        v.delete_needle(i, i * 7)
        del want[i]
    v.sync()
    v.close()
    return want


def _tier(dirname, remote_dir, files_mod, keep_local=False, size=True):
    """The upload stand-in on closed files: copy the .dat to the tier,
    record it in the .vif and (unless keep_local) unlink it."""
    dat = os.path.join(str(dirname), f"{VID}.dat")
    spec = f"local:{remote_dir}"
    n = backend.open_remote(spec).write_object(f"{VID}.dat", dat)
    remote = {"spec": spec, "key": f"{VID}.dat"}
    if size:
        remote["size"] = n
    files_mod.update_vif(os.path.join(str(dirname), f"{VID}.vif"),
                         {"remote": remote})
    if not keep_local:
        os.unlink(dat)
    return remote


@pytest.fixture
def tiered(tmp_path):
    """The same tiered volume in a port directory and a reference one."""
    want = _volume(tmp_path / "port")
    (tmp_path / "ref").mkdir()
    for ext in (".dat", ".idx"):
        os.link(tmp_path / "port" / f"{VID}{ext}", tmp_path / "ref" / f"{VID}{ext}")
    _tier(tmp_path / "port", tmp_path / "tier_port", files)
    _tier(tmp_path / "ref", tmp_path / "tier_ref", ref_files)
    return tmp_path, want


@pytest.mark.parametrize("with_size", [True, False])
def test_tiered_volume_reads_match_reference(tiered, with_size):
    tmp, want = tiered
    if not with_size:  # an older .vif without the size: object_size asks
        for d, fm in (("port", files), ("ref", ref_files)):
            vif = fm.read_vif(str(tmp / d / f"{VID}.vif"))
            vif["remote"].pop("size")
            fm.write_vif(str(tmp / d / f"{VID}.vif"), **vif)
    v = volume.Volume(str(tmp / "port"), "", VID)
    r = ref_volume.Volume(str(tmp / "ref"), "", VID)
    try:
        assert v.remote_spec["key"] == r.remote_spec["key"] == f"{VID}.dat"
        assert v.read_only and v._fileno == -1
        assert (v.content_size, v.file_count, v.deleted_count, v.garbage_ratio()) == \
            (r.content_size, r.file_count, r.deleted_count, r.garbage_ratio())
        for i, data in want.items():
            got = v.read_needle(i, cookie=i * 7)
            assert got.data == data == r.read_needle(i, cookie=i * 7).data
        pairs = [(i, i * 7) for i in range(1, 130)]
        assert [(s, n and n.data) for s, n in v.read_needles(pairs)] == \
            [(s, n and n.data) for s, n in r.read_needles(pairs)]
        for i in (2, 13, 999):
            with pytest.raises(KeyError):
                v.read_needle(i)
        assert v.read_raw(8, 100) == r.read_raw(8, 100)
        assert list(v.read_records_since(0)) == list(r.read_records_since(0))
    finally:
        v.close()
        r.close()
    assert v._dat.closed


def test_tiered_volume_refuses_writes(tiered):
    tmp, _ = tiered
    v = volume.Volume(str(tmp / "port"), "", VID)
    try:
        for write in (lambda: v.write_needle(Needle(id=1, cookie=7, data=b"x")),
                      lambda: v.write_needles([Needle(id=1, cookie=7, data=b"x")]),
                      lambda: v.delete_needle(1, 7),
                      lambda: v.append_records(b"")):
            with pytest.raises(PermissionError, match="read-only"):
                write()
        v.sync()  # no fsync of a remote .dat, no error
    finally:
        v.close()


def test_tiered_volume_kept_local_is_read_only(tmp_path):
    want = _volume(tmp_path)
    remote = _tier(tmp_path, tmp_path / "tier", files, keep_local=True)
    v = volume.Volume(str(tmp_path), "", VID)
    try:
        assert v.remote_spec == remote and v.read_only and v._fileno >= 0
        assert all(v.read_needle(i).data == d for i, d in want.items())
        with pytest.raises(PermissionError):
            v.write_needle(Needle(id=1, cookie=7, data=b"x"))
        assert scrub.scrub_volume(v, device="off").mode == "skipped-tiered"
    finally:
        v.close()


def test_tiered_volume_destroy_deletes_remote_object(tiered):
    tmp, _ = tiered
    v = volume.Volume(str(tmp / "port"), "", VID)
    client = backend.LocalDirRemote(str(tmp / "tier_port"))
    assert client.list_keys() == [f"{VID}.dat"]
    v.destroy()
    assert client.list_keys() == []
    assert sorted(os.listdir(tmp / "port")) == []


def test_disk_location_loads_tiered_volume_like_reference(tiered):
    tmp, want = tiered
    port, ref = DiskLocation(str(tmp / "port")), RefLocation(str(tmp / "ref"))
    port.load_existing()
    ref.load_existing()
    try:
        assert sorted(port.volumes) == sorted(ref.volumes) == [VID]
        v = port.volumes[VID]
        assert v.remote_spec is not None and not os.path.exists(v.dat_path)
        i = next(iter(want))
        assert v.read_needle(i).data == want[i]
    finally:
        for loc in (port, ref):
            for v in loc.volumes.values():
                v.close()


@pytest.mark.parametrize("device", ["cpu", "off", "cuda"])
def test_scrub_skips_tiered_volume_without_a_read(tiered, monkeypatch, device):
    """In both packages: mode "skipped-tiered", nothing scanned and not one
    object read from the tier, whatever the device (the skip comes before
    the device is touched, so "cuda" needs no card)."""
    tmp, _ = tiered
    calls = []
    for mod in (backend, ref_backend):
        plain = mod.LocalDirRemote.read_object
        monkeypatch.setattr(mod.LocalDirRemote, "read_object",
                            lambda self, *a, plain=plain: calls.append(a) or plain(self, *a))
    v = volume.Volume(str(tmp / "port"), "", VID)
    r = ref_volume.Volume(str(tmp / "ref"), "", VID)
    try:
        opened = len(calls)  # each open reads the super block
        assert opened == 2
        res = scrub.scrub_volume(v, device=device)
        ref_res = ref_scrub.scrub_volume(r, device="off")
        assert (res.mode, res.scanned, res.corrupt, res.bytes_checked) == \
            (ref_res.mode, ref_res.scanned, ref_res.corrupt,
             ref_res.bytes_checked) == ("skipped-tiered", 0, [], 0)
        assert len(calls) == opened
        with pytest.raises(ValueError, match="choose one of"):
            scrub.scrub_volume(v, device="auto")  # the device check comes first
    finally:
        v.close()
        r.close()


def test_unported_remote_kind_volume_raises(tmp_path):
    files.write_vif(str(tmp_path / f"{VID}.vif"),
                    remote={"spec": "azure:https://a.example/c?k:s", "key": "x"})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        volume.Volume(str(tmp_path), "", VID)
