"""The port's remote clients (seaweedfs_tpu_torch/remote/: the Azure Blob
SharedKey signer and client, the GCS JSON-API client) and stand-ins
(utils/mini_azure.py, utils/mini_gcs.py) against the JAX package's:
`sign_shared_key` equal on seeded requests, each client against both
packages' stand-ins on localhost (container, put, ranged reads, sizes,
paged listings, deletes, a bad key refused), and a port volume's `.dat`
tiered to `azure:` and `gcs-json:` and back through the RPC bodies, byte
for byte. Exact comparisons; no tolerance applies."""

import base64
import os

import numpy as np
import pytest

from seaweedfs_tpu.remote import azure as ref_azure
from seaweedfs_tpu.remote import gcs as ref_gcs
from seaweedfs_tpu.utils.mini_azure import MiniAzure as RefMiniAzure
from seaweedfs_tpu.utils.mini_gcs import MiniGcs as RefMiniGcs
from seaweedfs_tpu_torch import remote
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage import backend
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.utils.mini_azure import MiniAzure
from seaweedfs_tpu_torch.utils.mini_gcs import MiniGcs


def test_remote_package_exports_the_mounts_and_the_clients():
    """The package exports the reference's five mount functions and the
    clients; the replication sinks live beside them and are built at their
    first use (tests/test_torch_replication.py holds them, and shows a
    tier client's import loads no replication plane)."""
    from seaweedfs_tpu import remote as ref_remote
    assert sorted(remote.__all__) == sorted(ref_remote.__all__ + [
        "sign_shared_key", "AzureBlobClient", "parse_azure_spec",
        "GcsClient", "parse_gcs_spec"])
    from seaweedfs_tpu_torch.replication.sink import ReplicationSink
    assert issubclass(remote.azure.AzureSink, ReplicationSink)
    assert issubclass(remote.gcs.GcsSink, ReplicationSink)


@pytest.mark.parametrize("seed", range(6))
def test_sign_shared_key_equals_reference(seed):
    rng = np.random.default_rng(seed)
    key = base64.b64encode(rng.bytes(32)).decode()
    method = ("GET", "PUT", "HEAD", "DELETE")[seed % 4]
    path = f"/cont{seed}/" + "/".join(
        f"b%20{int(x)}" for x in rng.integers(0, 99, int(rng.integers(1, 4))))
    query = {k: str(int(rng.integers(0, 9))) for k in
             ("restype", "comp", "marker", "prefix")[:seed % 5]}
    headers = {"x-ms-date": "Sat, 17 Oct 2026 10:00:00 GMT",
               "x-ms-version": "2020-10-02",
               "X-Ms-Blob-Type": "BlockBlob", "Content-Type": "x/y",
               "Range": f"bytes={seed}-{seed + 99}"}
    n = int(rng.integers(0, 3)) * 1000
    assert remote.sign_shared_key(method, "acct", key, path, query, headers,
                                  n) == \
        ref_azure.sign_shared_key(method, "acct", key, path, query, headers,
                                  n)


@pytest.mark.parametrize("arg", [
    "http://127.0.0.1:1/c?acct:a2V5", "https://acct.blob.example/c?a:b",
    "127.0.0.1:1/c?acct:a2V5", "http://127.0.0.1:1/c", "http://h/?a:b",
])
def test_parse_azure_spec_like_reference(arg):
    try:
        want = ref_azure.parse_azure_spec(arg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            remote.parse_azure_spec(arg)
        assert str(got.value) == str(e)
        return
    got = remote.parse_azure_spec(arg)
    fields = ("endpoint", "account", "key_b64", "container", "name")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]


@pytest.mark.parametrize("arg", [
    "http://127.0.0.1:1/b?tok", "https://storage.example/b?t0k",
    "127.0.0.1/b?tok", "http://h/b", "http://h/?tok",
])
def test_parse_gcs_spec_like_reference(arg):
    try:
        want = ref_gcs.parse_gcs_spec(arg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            remote.parse_gcs_spec(arg)
        assert str(got.value) == str(e)
        return
    got = remote.parse_gcs_spec(arg)
    fields = ("endpoint", "bucket", "token", "name")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]


def _exercise(client, tmp_path, seed):
    """The RemoteStorageClient surface on `client`: what every call gave."""
    rng = np.random.default_rng(seed)
    out = []
    blobs = {f"dir/obj {i}.dat": rng.bytes(int(rng.integers(1, 5000)))
             for i in range(5)}
    for i, (key, data) in enumerate(blobs.items()):
        if i % 2:
            src = tmp_path / f"src{seed}_{i}"
            src.write_bytes(data)
            out.append(client.write_object(key, str(src)))
        else:
            client.put_bytes(key, data)
    for key, data in blobs.items():
        out.append(client.object_size(key) == len(data))
        for off, size in ((0, len(data)), (1, 7), (len(data) - 3, 3)):
            out.append(client.read_object(key, off, size)
                       == data[off:off + size])
    out.append(sorted(client.list_keys()) == sorted(blobs))
    out.append(client.list_keys("dir/obj 3"))
    client.delete_object("dir/obj 0.dat")
    client.delete_object("never there")  # a missing key is not an error
    out.append(sorted(client.list_keys()))
    with pytest.raises(OSError):
        client.object_size("dir/obj 0.dat")
    return out


@pytest.mark.parametrize("stand_in", ["port", "reference"])
def test_azure_client_against_both_stand_ins(stand_in, tmp_path):
    srv = (MiniAzure if stand_in == "port" else RefMiniAzure)().start()
    try:
        spec = f"{srv.endpoint}/cont?{srv.account}:{srv.key_b64}"
        ours, theirs = (mod.parse_azure_spec(spec)
                        for mod in (remote, ref_azure))
        ours.ensure_container()
        theirs.ensure_container()  # 409 on the second create is fine
        got = _exercise(ours, tmp_path, 1)
        theirs.container = ours.container = "cont2"
        ours.ensure_container()
        assert got == _exercise(theirs, tmp_path, 1)
        bad = remote.AzureBlobClient(srv.endpoint, srv.account,
                                     base64.b64encode(b"wrong").decode(),
                                     "cont")
        with pytest.raises(OSError, match="HTTP 403"):
            bad.put_bytes("x", b"y")
    finally:
        srv.stop()


@pytest.mark.parametrize("stand_in", ["port", "reference"])
def test_gcs_client_against_both_stand_ins(stand_in, tmp_path):
    srv = (MiniGcs if stand_in == "port" else RefMiniGcs)().start()
    try:
        ours = remote.parse_gcs_spec(f"{srv.endpoint}/bkt?{srv.token}")
        theirs = ref_gcs.parse_gcs_spec(f"{srv.endpoint}/bkt2?{srv.token}")
        assert _exercise(ours, tmp_path, 2) == _exercise(theirs, tmp_path, 2)
        bad = remote.GcsClient(srv.endpoint, "bkt", "wrong")
        with pytest.raises(OSError, match="HTTP 401"):
            bad.put_bytes("x", b"y")
    finally:
        srv.stop()


@pytest.mark.parametrize("kind", ["azure", "gcs-json"])
def test_tier_move_and_back_byte_identical(kind, tmp_path):
    """A port volume's .dat moved to the `kind` tier by
    VolumeTierMoveDatToRemote serves its needles from the remote copy,
    VolumeScrub skips it as tiered, and VolumeTierMoveDatFromRemote brings
    back a .dat equal byte for byte, scrubbed clean."""
    srv = (MiniAzure if kind == "azure" else MiniGcs)().start()
    spec = (f"azure:{srv.endpoint}/tier?{srv.account}:{srv.key_b64}"
            if kind == "azure" else f"gcs-json:{srv.endpoint}/tier?{srv.token}")
    if kind == "azure":
        remote.parse_azure_spec(spec.split(":", 1)[1]).ensure_container()
    store = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "d"))],
                  coder_name="torch", device="cpu")
    vs = VolumeServer(store, "127.0.0.1", 0)
    vid = 5
    rng = np.random.default_rng(9)
    try:
        vs.allocate_volume(vid)
        v = store.find_volume(vid)
        want = {}
        for i in range(1, 301):
            data = rng.bytes(int(1024 + rng.integers(0, 64)))
            v.write_needle(Needle(id=i, cookie=0x5000 + i, data=data))
            want[i] = data
        v.sync()
        with open(v.dat_path, "rb") as f:
            dat = f.read()
        r = vs.volume_tier_move_dat_to_remote(vid, spec)
        assert r["processed"] == len(dat)
        tiered = store.find_volume(vid)
        assert tiered.remote_spec["spec"] == spec and tiered.read_only
        assert not os.path.exists(tiered.dat_path)
        client = backend.open_remote(spec)
        assert client.read_object(f"{vid}.dat", 0, len(dat)) == dat
        for i in (1, 150, 300):
            assert store.read_needle(vid, i, cookie=0x5000 + i).data == want[i]
        assert vs.volume_scrub(vid, device="off")[0]["mode"] == \
            "skipped-tiered"
        vs.volume_tier_move_dat_from_remote(vid)
        back = store.find_volume(vid)
        assert back.remote_spec is None
        with open(back.dat_path, "rb") as f:
            assert f.read() == dat
        res = vs.volume_scrub(vid, device="off")[0]
        assert (res["scanned"], res["corrupt_needle_ids"]) == (300, [])
    finally:
        vs.stop()
        srv.stop()
