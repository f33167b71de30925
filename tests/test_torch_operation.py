"""The port's client data path (seaweedfs_tpu_torch/client/operation.py and
client/backup.py) against the JAX package's, both driving one cluster of
the port alone (tests/torch_cluster.py: a port master and four port volume
servers on device="cpu", ports below the ephemeral range): submit,
submit_batch, read, read_batch, delete, delete_batch and query give equal
bytes and fids of the same shape whichever package wrote or reads them,
and the port's backup of a port volume, full and then incremental, is byte
for byte the JAX package's backup of it."""

import hashlib
import json
import os
import re

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.client import backup as ref_backup
from seaweedfs_tpu.client import operation as ref_op
from seaweedfs_tpu.client.master_client import MasterClient as RefMasterClient
from seaweedfs_tpu_torch.client import backup, operation
from seaweedfs_tpu_torch.client.master_client import MasterClient
from seaweedfs_tpu_torch.storage.types import file_id, parse_file_id

FID = re.compile(r"^\d+,[0-9a-f]+[0-9a-f]{8}$")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("op"), device="cpu")
    ref_mc = RefMasterClient(c["master"].address).start()
    mc = MasterClient(c["master"].address).start()
    try:
        yield c, {"port": (operation, mc), "ref": (ref_op, ref_mc)}
    finally:
        mc.stop()
        ref_mc.stop()
        tc.stop(c)


def _blobs(n, seed, lo=1, hi=5000):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(rng.integers(lo, hi))) for _ in range(n)]


def _both_read(clients, fid):
    return [mod.read(mc, fid) for mod, mc in clients.values()]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_submit_and_read_across_packages(cluster, writer):
    c, clients = cluster
    mod, mc = clients[writer]
    datas = _blobs(12, seed=1 if writer == "port" else 2)
    got = []
    for i, data in enumerate(datas):
        res = mod.submit(mc, data, name=f"b{i}.bin" if i % 2 else "",
                         mime="application/octet-stream" if i % 3 else "",
                         collection="op")
        assert FID.match(res.fid), res.fid
        assert res.size == len(data) and res.url
        got.append(res.fid)
    assert len(set(got)) == len(got)
    for fid, data in zip(got, datas):
        assert _both_read(clients, fid) == [data, data]


def test_upload_gzips_text_like_reference(cluster):
    c, clients = cluster
    text = ("a line of compressible text\n" * 200).encode()
    answers = {}
    for name, (mod, mc) in clients.items():
        a = mc.assign(collection="op")
        answers[name] = mod.upload(f"{a.location.url}/{a.fid}", text,
                                   name="t.txt", mime="text/plain",
                                   jwt=a.auth)
        assert _both_read(clients, a.fid) == [text, text]
    assert set(answers["port"]) == set(answers["ref"])
    assert answers["port"]["size"] == answers["ref"]["size"]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_submit_batch_and_read_batch_across_packages(cluster, writer):
    c, clients = cluster
    mod, mc = clients[writer]
    datas = _blobs(300, seed=3 if writer == "port" else 4, hi=2000)
    res = mod.submit_batch(mc, datas, collection="batch")
    fids = [r.fid for r in res]
    assert len(set(fids)) == len(fids) == len(datas)
    assert all(FID.match(f) for f in fids)
    assert [r.size for r in res] == [len(d) for d in datas]
    for mod2, mc2 in clients.values():
        assert mod2.read_batch(mc2, fids) == datas
    # a missing key reads as None in both
    vid, key, cookie = parse_file_id(fids[0])
    ghost = file_id(vid, key + 10_000_000, cookie)
    for mod2, mc2 in clients.values():
        assert mod2.read_batch(mc2, [fids[1], ghost]) == [datas[1], None]


@pytest.mark.parametrize("deleter", ["port", "ref"])
def test_delete_and_delete_batch_across_packages(cluster, deleter):
    c, clients = cluster
    mod, mc = clients[deleter]
    writer_mod, writer_mc = clients["ref" if deleter == "port" else "port"]
    datas = _blobs(8, seed=5 if deleter == "port" else 6)
    fids = [writer_mod.submit(writer_mc, d, collection="del").fid
            for d in datas]
    assert mod.delete(mc, fids[0]) is True
    assert mod.delete_batch(mc, fids[1:5]) == 4
    assert mod.delete_batch(mc, fids[1:3]) == 0  # already gone
    for fid in fids[:5]:
        for mod2, mc2 in clients.values():
            with pytest.raises(KeyError):
                mod2.read(mc2, fid)
    assert _both_read(clients, fids[5]) == [datas[5], datas[5]]


def test_query_equal_across_packages(cluster):
    c, clients = cluster
    rng = np.random.default_rng(7)
    fids = []
    for i in range(10):
        lines = [{"n": i * 10 + j, "w": int(rng.integers(0, 100)),
                  "even": (i + j) % 2 == 0} for j in range(5)]
        body = "".join(json.dumps(x) + "\n" for x in lines).encode()
        fids.append(operation.submit(clients["port"][1], body,
                                     collection="q").fid)
    answers = [mod.query(mc, fids, field="w", op=">=", value="40",
                         projections=["n", "even"])
               for mod, mc in clients.values()]
    assert answers[0] == answers[1] and answers[0]
    rows = [json.loads(x) for x in answers[0].decode().splitlines()]
    assert all(len(r) == 2 for r in rows)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_backup_full_then_incremental_equals_reference(cluster, tmp_path):
    c, clients = cluster
    vid = 77
    holder = c["served"]["r2"].vs
    holder.allocate_volume(vid, collection="bk")
    tc.wait_until(lambda: clients["port"][1].refresh_lookup(vid),
                  timeout=10, msg="the backup volume known")
    rng = np.random.default_rng(8)

    def post(lo, hi):
        for k in range(lo, hi):
            fid = file_id(vid, k, 0xB0B0 + k)
            operation.upload(f"{holder.url}/{fid}",
                             rng.bytes(int(rng.integers(10, 4000))))

    post(1, 20)
    dests = {name: tmp_path / name for name in clients}
    for d in dests.values():
        d.mkdir()
    runs = {"port": backup.backup_volume, "ref": ref_backup.backup_volume}
    first = {name: runs[name](clients[name][1], vid, str(dests[name]),
                              collection="bk") for name in clients}
    assert first["port"] == first["ref"]
    assert first["port"]["mode"] == "full"
    for ext in (".dat", ".idx"):
        assert _sha(str(dests["port"] / f"bk_{vid}{ext}")) == \
            _sha(str(dests["ref"] / f"bk_{vid}{ext}"))
    post(20, 31)
    operation.delete(clients["port"][1], file_id(vid, 3, 0xB0B0 + 3))
    second = {name: runs[name](clients[name][1], vid, str(dests[name]),
                               collection="bk") for name in clients}
    assert second["port"] == second["ref"]
    assert (second["port"]["mode"], second["port"]["records_applied"]) == \
        ("incremental", 12)
    v = holder.store.find_volume(vid)
    v.sync()
    for ext in (".dat", ".idx"):
        got = _sha(str(dests["port"] / f"bk_{vid}{ext}"))
        assert got == _sha(str(dests["ref"] / f"bk_{vid}{ext}"))
    assert _sha(str(dests["port"] / f"bk_{vid}.dat")) == \
        _sha(v.file_name() + ".dat")
    assert os.path.getsize(str(dests["port"] / f"bk_{vid}.idx")) == \
        os.path.getsize(v.file_name() + ".idx")
