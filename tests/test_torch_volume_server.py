"""The port's volume server core (seaweedfs_tpu_torch/server/volume_server.py)
against the JAX package's VolumeServer: the same needles POSTed to both over
HTTP, the same RPC sequence (the JAX server through its gRPC Stub on
localhost, the port's through its methods), byte-equal shards, .ecx and .vif,
equal HTTP answers healthy, degraded and ranged, equal rebuilds, blob
deletes and decodes, for the rs, piggyback and msr codecs at RS(4,2); equal
VolumeScrub results for every device word; and, on port servers joined by
LocalPeers, the stale-location refresh, the last probe of circuit-open
holders and a rebuild that never asks its own server for its offloaded
shards. The port's Stores run with device="cpu"."""

import gzip
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import requests

from conftest import free_port_pair
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.pb import volume_server_pb2 as vpb
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.storage.disk_location import DiskLocation as RefLocation
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu.utils.rpc import VOLUME_SERVICE, Stub
from seaweedfs_tpu_torch.ec import files
from seaweedfs_tpu_torch.ec.locate import EcGeometry, locate
from seaweedfs_tpu_torch.server.volume_server import (LocalPeers, RpcAbort,
                                                      VolumeServer)
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import record_size_from_header
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import file_id
from seaweedfs_tpu_torch.utils import retry

VID = 3
D, P = 4, 2
LB, SB = 8192, 1024
LOST = (0, 4)  # a data shard and the unpiggybacked parity: survivors take
               # piggybacked parity 5, so piggyback reads strip it
HEADERS = ("Content-Range", "ETag", "Content-Encoding", "Content-Type",
           "Content-Disposition")


@pytest.fixture(autouse=True)
def _port_breakers():
    """The port's breaker table is its own (conftest resets the JAX
    package's): an open breaker left over from one test must not send the
    next test's reads down the last-probe path."""
    retry.reset_breakers()
    yield
    retry.reset_breakers()


def _port(dirname, codec="rs", **kw):
    store = Store("127.0.0.1", 0, "", [DiskLocation(str(dirname))],
                  ec_geometry=EcGeometry(D, P, large_block=LB, small_block=SB),
                  coder_name="torch", ec_codec=codec, device="cpu")
    port = free_port_pair()
    store.port, store.public_url = port, f"127.0.0.1:{port}"
    vs = VolumeServer(store, "127.0.0.1", port, **kw)
    vs.start()
    return vs


def _ref(dirname, codec="rs"):
    store = RefStore("127.0.0.1", 0, "", [RefLocation(str(dirname))],
                     ec_geometry=RefGeometry(D, P, large_block=LB,
                                             small_block=SB),
                     coder_name="numpy", ec_codec=codec)
    port = free_port_pair()
    store.port, store.public_url = port, f"127.0.0.1:{port}"
    # a master address nothing listens on: EC lookups fail fast and
    # degraded reads use the local survivors; VolumeServerLeave stops the
    # heartbeat, so admin RPCs do not wait for a master's ack
    vs = RefServer(store, f"127.0.0.1:{free_port_pair()}", port=port,
                   grpc_port=port + 10000, pulse_seconds=0.5,
                   read_mode="local")
    vs.start()
    _stub(vs).call("VolumeServerLeave", vpb.VolumeServerLeaveRequest(),
                   vpb.VolumeServerLeaveResponse)
    return vs


def _stub(ref):
    return Stub(f"127.0.0.1:{ref.grpc_port}", VOLUME_SERVICE)


def _needles(n=48, seed=5):
    """(fid, body, headers, query) uploads: plain bodies, named and typed
    ones, and gzip-stored ones."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, n + 1):
        data = rng.bytes(int(rng.integers(1, 3000)))
        headers, query = {}, ""
        if i % 4 == 1:
            headers["Content-Type"] = "text/plain"
            query = f"?name=n{i}.txt"
        elif i % 4 == 2:
            data = gzip.compress(data)
            headers["Content-Encoding"] = "gzip"
        out.append((file_id(VID, i, int(rng.integers(1, 1 << 32))), data,
                    headers, query))
    return out


def _post_all(urls, uploads):
    for fid, data, headers, query in uploads:
        got = [requests.post(f"http://{u}/{fid}{query}", data=data,
                             headers=headers, timeout=10) for u in urls]
        assert [r.status_code for r in got] == [201, 201]
        assert got[0].json() == got[1].json()


_HTTP = requests.Session()  # keep-alive: thousands of GETs per test


def _get(url, fid, **headers):
    r = _HTTP.get(f"http://{url}/{fid}", headers=headers, timeout=30)
    return (r.status_code, r.content,
            {h: r.headers.get(h) for h in HEADERS})


def _gets_equal(urls, uploads):
    """Every needle GET plain, ranged (window, suffix, open, past the end)
    and with gzip accepted: status, body and headers equal on both."""
    n = 0
    for fid, data, _, _ in uploads:
        for hdr in ({}, {"Accept-Encoding": "gzip"},
                    {"Range": "bytes=10-400"}, {"Range": "bytes=-77"},
                    {"Range": "bytes=100-"}, {"Range": "bytes=999999-"}):
            port_ans, ref_ans = (_get(u, fid, **hdr) for u in urls)
            assert port_ans == ref_ans, (fid, hdr)
            n += port_ans[0] in (200, 206)
    return n


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _ec_files(base, n):
    return {ext: _sha(base + ext)
            for ext in [files.shard_ext(s) for s in range(n)] + [".ecx", ".vif"]}


@pytest.mark.parametrize("codec", ["rs", "piggyback", "msr"])
def test_ec_rpc_sequence_against_reference(tmp_path, codec):
    uploads = _needles()
    vs = _port(tmp_path / "port", codec)
    ref = _ref(tmp_path / "ref", codec)
    stub = _stub(ref)
    try:
        urls = (vs.url, ref.url)
        vs.allocate_volume(VID)
        stub.call("AllocateVolume", vpb.AllocateVolumeRequest(volume_id=VID),
                  vpb.AllocateVolumeResponse)
        _post_all(urls, uploads)
        assert _gets_equal(urls, uploads)
        # the two .dat files differ in their append timestamps: the
        # reference takes a copy of the port's before both encode
        vs.store.find_volume(VID).sync()
        stub.call("VolumeUnmount", vpb.VolumeUnmountRequest(volume_id=VID),
                  vpb.VolumeUnmountResponse)
        for ext in (".dat", ".idx"):
            shutil.copy(tmp_path / "port" / f"{VID}{ext}",
                        tmp_path / "ref" / f"{VID}{ext}")
        stub.call("VolumeMount", vpb.VolumeMountRequest(volume_id=VID),
                  vpb.VolumeMountResponse)

        vs.volume_mark_readonly(VID)
        vs.volume_ec_shards_generate(VID, codec=codec)
        stub.call("VolumeMarkReadonly",
                  vpb.VolumeMarkReadonlyRequest(volume_id=VID),
                  vpb.VolumeMarkReadonlyResponse)
        stub.call("VolumeEcShardsGenerate",
                  vpb.VolumeEcShardsGenerateRequest(volume_id=VID, codec=codec),
                  vpb.VolumeEcShardsGenerateResponse, timeout=120)
        base = str(tmp_path / "port" / str(VID))
        ref_base = str(tmp_path / "ref" / str(VID))
        sealed = _ec_files(base, D + P)
        assert sealed == _ec_files(ref_base, D + P)

        vs.volume_ec_shards_mount(VID)
        vs.volume_delete(VID)
        stub.call("VolumeEcShardsMount",
                  vpb.VolumeEcShardsMountRequest(volume_id=VID),
                  vpb.VolumeEcShardsMountResponse)
        stub.call("VolumeDelete", vpb.VolumeDeleteRequest(volume_id=VID),
                  vpb.VolumeDeleteResponse)
        info = stub.call("VolumeEcShardsInfo",
                         vpb.VolumeEcShardsInfoRequest(volume_id=VID),
                         vpb.VolumeEcShardsInfoResponse)
        mine = vs.volume_ec_shards_info(VID)
        assert mine == {"data_shards": info.data_shards,
                        "parity_shards": info.parity_shards,
                        "dat_size": info.dat_size, "codec": codec,
                        "shard_size": info.shard_size,
                        "local_shard_ids": list(info.local_shard_ids),
                        "remote_shard_ids": list(info.remote_shard_ids)}
        assert _gets_equal(urls, uploads)  # healthy, through the EC volume

        vs.volume_ec_shards_delete(VID, shard_ids=list(LOST))
        stub.call("VolumeEcShardsDelete",
                  vpb.VolumeEcShardsDeleteRequest(volume_id=VID,
                                                  shard_ids=list(LOST)),
                  vpb.VolumeEcShardsDeleteResponse)
        before = vs.read_stats.get("reconstructs", 0)
        assert _gets_equal(urls, uploads)  # degraded
        assert vs.read_stats["reconstructs"] > before

        rebuilt = vs.volume_ec_shards_rebuild(VID)
        ref_rebuilt = stub.call("VolumeEcShardsRebuild",
                                vpb.VolumeEcShardsRebuildRequest(volume_id=VID),
                                vpb.VolumeEcShardsRebuildResponse, timeout=120)
        assert rebuilt["rebuilt_shard_ids"] == list(ref_rebuilt.rebuilt_shard_ids) \
            == list(LOST)
        assert rebuilt["bytes_read"] == ref_rebuilt.bytes_read
        assert _ec_files(base, D + P) == sealed
        stub.call("VolumeEcShardsMount",
                  vpb.VolumeEcShardsMountRequest(volume_id=VID),
                  vpb.VolumeEcShardsMountResponse)

        gone = uploads[0][0]
        key = int(gone.split(",")[1][:-8], 16)
        vs.volume_ec_blob_delete(VID, key)
        stub.call("VolumeEcBlobDelete",
                  vpb.VolumeEcBlobDeleteRequest(volume_id=VID, file_key=key),
                  vpb.VolumeEcBlobDeleteResponse)
        assert _get(vs.url, gone)[0] == _get(ref.url, gone)[0] == 404

        vs.volume_ec_shards_to_volume(VID)
        stub.call("VolumeEcShardsToVolume",
                  vpb.VolumeEcShardsToVolumeRequest(volume_id=VID),
                  vpb.VolumeEcShardsToVolumeResponse, timeout=120)
        assert _sha(base + ".dat") == _sha(ref_base + ".dat")
        assert _gets_equal(urls, uploads[1:])
        assert _get(vs.url, gone)[0] == 404
    finally:
        vs.stop()
        ref.stop()


def _damage(store, vid, ids):
    """Flip one data byte of each needle in `ids` in the .dat."""
    v = store.find_volume(vid)
    v.sync()
    with open(v.file_name() + ".dat", "r+b") as f:
        for i in ids:
            off = v.nm.get(i).offset
            f.seek(off + 16 + 4 + 3)
            b = f.read(1)
            f.seek(off + 16 + 4 + 3)
            f.write(bytes([b[0] ^ 0x5A]))


def test_volume_scrub_against_reference(tmp_path):
    uploads = [(fid, data, {}, "") for fid, data, _, _ in _needles(60, seed=9)]
    vs = _port(tmp_path / "port")
    ref = _ref(tmp_path / "ref")
    stub = _stub(ref)
    try:
        vs.allocate_volume(VID)
        stub.call("AllocateVolume", vpb.AllocateVolumeRequest(volume_id=VID),
                  vpb.AllocateVolumeResponse)
        _post_all((vs.url, ref.url), uploads)
        bad = [7, 30]
        _damage(vs.store, VID, bad)
        _damage(ref.store, VID, bad)
        for device in ("", "auto", "on", "off"):
            (mine,) = vs.volume_scrub(VID, device=device)
            (theirs,) = stub.call(
                "VolumeScrub", vpb.VolumeScrubRequest(volume_id=VID,
                                                      device=device),
                vpb.VolumeScrubResponse, timeout=60).results
            assert (mine["scanned"], sorted(mine["corrupt_needle_ids"]),
                    mine["bytes_checked"], mine["mode"], mine["error"]) == (
                theirs.scanned, sorted(theirs.corrupt_needle_ids),
                theirs.bytes_checked, theirs.mode, theirs.error), device
            assert sorted(mine["corrupt_needle_ids"]) == bad
        # a card asked for where there is none: an error result, never a
        # scrub on the CPU
        (on_card,) = vs.volume_scrub(VID, device="cuda")
        assert on_card["mode"] == "error" and on_card["scanned"] == 0
        assert "CUDA" in on_card["error"]
        with pytest.raises(RpcAbort) as e:
            vs.volume_scrub(VID, device="tpu")
        assert e.value.code == 3
        # no volume named: every volume, the cursor rotating
        assert [r["volume_id"] for r in vs.volume_scrub()] == [VID]
    finally:
        vs.stop()
        ref.stop()


class _Recording(LocalPeers):
    """LocalPeers that records which address each shard read went to."""

    def __init__(self, servers):
        super().__init__(servers)
        self.reads = []

    def read_shard(self, addr, vid, sid, offset, size):
        self.reads.append((addr, sid))
        return super().read_shard(addr, vid, sid, offset, size)


def _spread(tmp_path, n=60):
    """Port servers A, B, C joined by LocalPeers: the volume written on A
    over HTTP, encoded there, shards 2-5 copied to B with the sidecars,
    both mounted, 2-5 deleted on A and the source volume deleted."""
    a, b, c = (_port(tmp_path / x) for x in "abc")
    peers = _Recording({s.peer_address: s for s in (a, b, c)})
    uploads = [(fid, data, {}, "") for fid, data, _, _ in _needles(n, seed=3)]
    a.allocate_volume(VID)
    for fid, data, _, _ in uploads:
        assert requests.post(f"http://{a.url}/{fid}", data=data,
                             timeout=10).status_code == 201
    a.volume_mark_readonly(VID)
    a.volume_ec_shards_generate(VID)
    b.volume_ec_shards_copy(VID, shard_ids=[2, 3, 4, 5], copy_ecx_file=True,
                            copy_vif_file=True,
                            source_data_node=a.peer_address)
    b.volume_ec_shards_mount(VID)
    a.volume_ec_shards_mount(VID)
    a.volume_ec_shards_delete(VID, shard_ids=[2, 3, 4, 5])
    a.volume_delete(VID)
    return a, b, c, peers, uploads


def _on_shard(vs, fid, sid):
    ev = vs.store.find_ec_volume(VID)
    key = int(fid.split(",")[1][:-8], 16)
    off, size = ev.find_needle(key)
    return any(iv.shard_and_offset(ev.geo)[0] == sid for iv in locate(
        ev.geo, ev.dat_size, off, record_size_from_header(size)))


def test_stale_locations_refresh_and_circuit_open_last_probe(tmp_path):
    a, b, c, peers, uploads = _spread(tmp_path)
    try:
        for fid, data, _, _ in uploads:  # healthy: warms A's location cache
            assert _get(a.url, fid)[:2] == (200, data)
        assert not a.read_stats.get("reconstructs")
        # shard 3 moves from B to C behind A's back
        c.volume_ec_shards_move(VID, shard_ids=[3],
                                source_data_node=b.peer_address)
        assert sorted(c.store.find_ec_volume(VID).shards) == [3]
        a._EC_LOC_TTL_FAILED = 0  # the failed tier's 11 s, elapsed
        on3 = [u for u in uploads if _on_shard(a, u[0], 3)]
        assert on3
        for fid, data, _, _ in on3:
            assert _get(a.url, fid)[:2] == (200, data)
        assert a.read_stats["stale_locations_refreshed"] >= 1
        assert not a.read_stats.get("reconstructs")
        assert (c.peer_address, 3) in peers.reads

        # B's breaker open in the shared table: reads needing B's shards
        # still succeed, through the last probe of circuit-open holders
        retry.breaker(b.peer_address).trip()
        on2 = [u for u in uploads if _on_shard(a, u[0], 2)]
        assert on2
        for fid, data, _, _ in on2:
            assert _get(a.url, fid)[:2] == (200, data)
        assert a.read_stats["last_probes"] >= 1

        # C marked down, like a dead peer: its shard 3 is reconstructed
        retry.reset_breakers()
        peers.down.add(c.peer_address)
        before = a.read_stats.get("reconstructs", 0)
        for fid, data, _, _ in on3:
            assert _get(a.url, fid)[:2] == (200, data)
        assert a.read_stats["reconstructs"] - before >= len(on3)
        assert 3 not in peers.lookup_ec(VID)
    finally:
        for s in (a, b, c):
            s.stop()


def test_rebuild_never_reads_own_offloaded_shards(tmp_path):
    """The repair reader's holder lists drop the server itself: a holder
    that offloaded a shard to the tier never asks itself for it. Its
    rebuild takes the shard as missing and reads the survivors of the other
    holders (the JAX package's rule, volume_server.py:2104-2106)."""
    a, b, c, peers, uploads = _spread(tmp_path, n=40)
    try:
        sealed = {s: _sha(str(tmp_path / ("a" if s < 2 else "b") / str(VID))
                          + files.shard_ext(s)) for s in range(D + P)}
        # A offloads shard 0 to a tier, still holding it; shard 4 is lost
        # on B; A rebuilds
        spec = f"local:{tmp_path / 'tier'}"
        a.store.unmount_ec_shards(VID, [1])
        assert a.volume_ec_shards_tier_move_to_remote(
            VID, destination_backend_name=spec)["processed"] > 0
        a.volume_ec_shards_mount(VID)
        assert a.store.find_ec_volume(VID).remote_shard_ids() == [0]
        assert 0 in peers.lookup_ec(VID) and a.peer_address in \
            peers.lookup_ec(VID)[0]
        b.volume_ec_shards_delete(VID, shard_ids=[4])
        peers.reads.clear()
        got = a.volume_ec_shards_rebuild(VID)
        assert got["rebuilt_shard_ids"] == [0, 4]
        for s in (0, 4):
            assert _sha(str(tmp_path / "a" / str(VID)) + files.shard_ext(s)) \
                == sealed[s]
        asked = {addr for addr, _ in peers.reads}
        assert asked == {b.peer_address}
        assert sorted(sid for _, sid in peers.reads) and all(
            sid in (2, 3, 5) for _, sid in peers.reads)
    finally:
        for s in (a, b, c):
            s.stop()


def test_heartbeat_fields_match_reference(tmp_path):
    """The port's heartbeat() carries every field of the reference's
    Heartbeat message, with the same volume and EC shard entries."""
    from seaweedfs_tpu.pb import master_pb2 as mpb
    vs = _port(tmp_path / "port")
    ref = _ref(tmp_path / "ref")
    try:
        for s in (vs.store, ref.store):
            s.add_volume(VID)
            s.add_volume(VID + 1, collection="c")
        hb = vs.heartbeat()
        want = {f.name for f in mpb.Heartbeat.DESCRIPTOR.fields} - {
            "new_volumes", "deleted_volumes", "new_ec_shards",
            "deleted_ec_shards"}
        assert set(hb) == want
        msg = mpb.Heartbeat(**{k: v for k, v in hb.items()
                               if k not in ("volumes", "ec_shards")})
        for v in hb["volumes"]:
            msg.volumes.add(**v)
        ref_hb = ref.store.collect_heartbeat()
        assert [sorted(v) for v in hb["volumes"]] == \
            [sorted(v) for v in ref_hb["volumes"]]
        strip = ("modified_at_second",)
        assert [{k: v for k, v in e.items() if k not in strip}
                for e in hb["volumes"]] == \
            [{k: v for k, v in e.items() if k not in strip}
             for e in ref_hb["volumes"]]
        assert hb["max_volume_counts"] == ref_hb["max_volume_counts"]
        assert msg.grpc_port == vs.grpc_port and not msg.has_no_volumes
    finally:
        vs.stop()
        ref.stop()


def test_server_round_trip_of_chip_smoke_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 13 (three volume servers: HTTP writes and
    reads healthy, degraded and over gRPC, the stale-location refresh, the
    rebuilds, the last probe, the decode and VolumeScrub) on the CPU at a
    small size, its checks as fatal as on the card."""
    import chip_smoke
    # the failed tier's 11 s, shortened: the phase waits it out once
    monkeypatch.setattr(VolumeServer, "_EC_LOC_TTL_FAILED", 1)
    geo = EcGeometry(10, 4, large_block=8192, small_block=1024)
    res = chip_smoke.server_round_trip(np, str(tmp_path), 23, "cpu", geo,
                                       needles=3000, sample=400,
                                       http_needles=40, scrub_needles=600,
                                       device="cpu", grpc_pass=True)
    assert len(res["healthy"]) == 400 and res["degraded"]
    assert res["grpc_degraded"] and len(res["rebuild"]) == 2
    assert res["lengths"] and res["scrub"] > 0


def test_native_coder_server_encodes_like_torch(tmp_path):
    """`-coder native` of the volume verb: a Store on the AVX2 host coder
    seals the same shards as one on TorchCoder."""
    uploads = [(fid, data, {}, "") for fid, data, _, _ in _needles(30, seed=4)]
    torch_vs = _port(tmp_path / "torch")
    store = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "native"))],
                  ec_geometry=EcGeometry(D, P, large_block=LB, small_block=SB),
                  coder_name="native", device="cpu")
    native_vs = VolumeServer(store, "127.0.0.1", free_port_pair())
    native_vs.start()
    try:
        for vs in (torch_vs, native_vs):
            vs.allocate_volume(VID)
        for fid, data, _, _ in uploads:
            assert requests.post(f"http://{torch_vs.url}/{fid}", data=data,
                                 timeout=10).status_code == 201
        torch_vs.store.find_volume(VID).sync()
        native_vs.volume_unmount(VID)
        for ext in (".dat", ".idx"):
            shutil.copy(tmp_path / "torch" / f"{VID}{ext}",
                        tmp_path / "native" / f"{VID}{ext}")
        native_vs.volume_mount(VID)
        for vs in (torch_vs, native_vs):
            vs.volume_mark_readonly(VID)
            vs.volume_ec_shards_generate(VID)
        assert _ec_files(str(tmp_path / "native" / str(VID)), D + P) == \
            _ec_files(str(tmp_path / "torch" / str(VID)), D + P)
    finally:
        torch_vs.stop()
        native_vs.stop()


# -- the replicated data plane --------------------------------------------------

def _ref_alloc(ref, vid, replication=""):
    _stub(ref).call("AllocateVolume", vpb.AllocateVolumeRequest(
        volume_id=vid, replication=replication), vpb.AllocateVolumeResponse)


def test_replica_hop_lands_locally_like_reference(tmp_path):
    """A `?type=replicate` POST and DELETE on a "001" volume write and
    delete the hop's copy and fan out no further: 201 and 202 from both
    servers (the port refused them with 501 before)."""
    vs = _port(tmp_path / "port")
    ref = _ref(tmp_path / "ref")
    try:
        vs.allocate_volume(VID, replication="001")
        _ref_alloc(ref, VID, "001")
        fid = file_id(VID, 0x51, 0x1234ABCD)
        body = b"one replica hop" * 30
        for u in (vs.url, ref.url):
            r = requests.post(f"http://{u}/{fid}?type=replicate&name=h.bin",
                              data=body, timeout=10)
            assert r.status_code == 201, (u, r.text)
            assert r.json()["size"] == len(body)
        assert _get(vs.url, fid) == _get(ref.url, fid)
        assert _get(vs.url, fid)[:2] == (200, body)
        for u in (vs.url, ref.url):
            r = requests.delete(f"http://{u}/{fid}?type=replicate", timeout=10)
            assert (r.status_code, r.json()) == (202, {"size": 1}), u
        assert _get(vs.url, fid)[0] == _get(ref.url, fid)[0] == 404
    finally:
        vs.stop()
        ref.stop()


@pytest.mark.parametrize("method,path", [
    ("POST", "/not-a-fid"), ("GET", "/not-a-fid"), ("DELETE", "/3,zz"),
    ("GET", "/3")])
def test_malformed_fid_answers_500_like_reference(tmp_path, method, path):
    """The reference's handler has no ValueError branch: a fid that does
    not parse answers 500 there, and now here too (it was 400)."""
    vs = _port(tmp_path / "port")
    ref = _ref(tmp_path / "ref")
    try:
        got = [requests.request(method, f"http://{u}{path}", data=b"x",
                                timeout=10).status_code
               for u in (vs.url, ref.url)]
        assert got == [500, 500]
    finally:
        vs.stop()
        ref.stop()


def _frame(vid, n, seed, cookie=0x5EED0001, start=1, gzip_every=4):
    from seaweedfs_tpu_torch.storage import bulk
    rng = np.random.default_rng(seed)
    entries = [(start + i, cookie, rng.bytes(int(rng.integers(0, 1500))),
                1 if gzip_every and i % gzip_every == 1 else 0)
               for i in range(n)]
    return bulk.pack_frame(vid, entries), entries


def _both(urls, method, path, body=b""):
    return [requests.request(method, f"http://{u}{path}", data=body,
                             timeout=30) for u in urls]


def test_bulk_and_bulk_read_against_reference(tmp_path, monkeypatch):
    """/bulk and /bulk-read: the same statuses, JSON and response frames
    from both servers for the same frames, the overflow under a small
    byte budget, and the same refusals (400, 404, 405)."""
    from seaweedfs_tpu_torch.storage import bulk
    vs = _port(tmp_path / "port")
    ref = _ref(tmp_path / "ref")
    urls = (vs.url, ref.url)
    try:
        vs.allocate_volume(VID)
        _ref_alloc(ref, VID)
        frame, entries = _frame(VID, 40, seed=8)
        got = _both(urls, "PUT", f"/bulk?vid={VID}", frame)
        assert [r.status_code for r in got] == [201, 201]
        assert got[0].json() == got[1].json()
        assert got[0].json()["count"] == 40
        # a second frame by POST, overwriting half of the first
        frame2, entries2 = _frame(VID, 20, seed=9, start=21)
        got = _both(urls, "POST", "/bulk", frame2)
        assert [r.status_code for r in got] == [201, 201]
        assert got[0].json() == got[1].json()
        want = {k: d for k, _, d, _ in entries}
        want.update({k: d for k, _, d, _ in entries2})

        pairs = ([(k, 0x5EED0001) for k in range(1, 41)]
                 + [(99, 0x5EED0001), (5, 0x1)])  # missing, wrong cookie
        req = bulk.pack_read_request(VID, pairs)
        for _ in range(2):  # the second pass comes from the read cache
            got = _both(urls, "POST", f"/bulk-read?vid={VID}", req)
            assert [r.status_code for r in got] == [200, 200]
            assert got[0].content == got[1].content
        _, results = bulk.unpack_read_response(got[0].content)
        assert [bytes(r.data) for r in results[:40]] == \
            [want[k] for k in range(1, 41)]
        assert [r.status for r in results[40:]] == [bulk.READ_NOT_FOUND,
                                                    bulk.READ_ERROR]
        # a small frame budget: found needles past it come back overflowed
        monkeypatch.setenv("SWTPU_BULK_READ_FRAME_BYTES", "3000")
        got = _both(urls, "PUT", "/bulk-read", req)
        assert got[0].content == got[1].content
        statuses = [r.status for r in
                    bulk.unpack_read_response(got[0].content)[1]]
        assert bulk.READ_OVERFLOW in statuses and statuses[0] == bulk.READ_OK
        monkeypatch.delenv("SWTPU_BULK_READ_FRAME_BYTES")

        mixed = bulk.pack_frame(VID, [(1, 1, b"a", 0), (2, 2, b"b", 0)])
        other, _ = _frame(VID + 40, 3, seed=10)
        for method, path, body, status in (
                ("PUT", f"/bulk?vid={VID + 1}", frame, 400),
                ("PUT", "/bulk?vid=x", frame, 400),
                ("PUT", "/bulk", mixed, 400),
                ("PUT", "/bulk", frame[:-3], 400),
                ("PUT", "/bulk", other, 404),
                ("GET", "/bulk", b"", 405),
                ("POST", f"/bulk-read?vid={VID + 1}", req, 400),
                ("POST", "/bulk-read", req[:-1], 400),
                ("POST", "/bulk-read",
                 bulk.pack_read_request(VID + 40, [(1, 1)]), 404),
                ("GET", "/bulk-read", b"", 405)):
            got = _both(urls, method, path, body)
            assert [r.status_code for r in got] == [status, status], \
                (method, path)
    finally:
        vs.stop()
        ref.stop()



@pytest.mark.parametrize("name,path,written", [
    ("volume.bulk.put", "/bulk", False), ("volume.bulk.ack", "/bulk", True),
    ("volume.bulk.read", "/bulk-read", True)])
def test_bulk_failpoints(tmp_path, name, path, written):
    """volume.bulk.put fails a frame before anything lands, volume.bulk.ack
    after it is durable (the needles stay readable), volume.bulk.read fails
    a read frame: each answers 500 once, then the route serves again."""
    from seaweedfs_tpu_torch.storage import bulk
    from seaweedfs_tpu_torch.utils import failpoints
    vs = _port(tmp_path / "port")
    try:
        vs.allocate_volume(VID)
        frame, entries = _frame(VID, 5, seed=14, gzip_every=0)
        req = bulk.pack_read_request(VID, [(k, c) for k, c, _, _ in entries])
        if path == "/bulk-read":
            assert requests.put(f"http://{vs.url}/bulk", data=frame,
                                timeout=10).status_code == 201
        body = frame if path == "/bulk" else req
        failpoints.configure(name, "times:1:error")
        try:
            assert requests.post(f"http://{vs.url}{path}", data=body,
                                 timeout=10).status_code == 500
        finally:
            failpoints.clear(name)
        k, c, d, _ = entries[0]
        status, got, _ = _get(vs.url, file_id(VID, k, c))
        assert (status, got) == (200, d) if written else status == 404
        assert requests.post(f"http://{vs.url}{path}", data=body,
                             timeout=10).status_code == (
            201 if path == "/bulk" else 200)
    finally:
        vs.stop()

def _hits():
    from seaweedfs_tpu_torch.stats import READ_CACHE_HITS
    return READ_CACHE_HITS.value()


def test_read_cache_on_gets(tmp_path):
    """A second GET of a plain-volume needle is a cache hit; a DELETE, an
    overwrite and a /bulk frame over the same key drop the entry; EC GETs
    never fill the cache."""
    from seaweedfs_tpu_torch.storage import bulk
    vs = _port(tmp_path / "port")
    try:
        assert vs.read_cache is not None
        vs.allocate_volume(VID)
        fid = file_id(VID, 7, 0x77)
        for body in (b"first" * 40, b"second" * 40):
            assert requests.post(f"http://{vs.url}/{fid}", data=body,
                                 timeout=10).status_code == 201
            h0 = _hits()
            assert _get(vs.url, fid)[:2] == (200, body)  # miss, then fill
            assert _get(vs.url, fid)[:2] == (200, body)
            assert _get(vs.url, fid, Range="bytes=2-9")[:2] == (206,
                                                              body[2:10])
            assert _hits() - h0 == 2  # the overwrite dropped the old entry
        frame = bulk.pack_frame(VID, [(7, 0x77, b"framed" * 9, 0)])
        assert requests.put(f"http://{vs.url}/bulk", data=frame,
                            timeout=10).status_code == 201
        h0 = _hits()
        assert _get(vs.url, fid)[:2] == (200, b"framed" * 9)
        assert _hits() == h0
        assert _get(vs.url, fid)[:2] == (200, b"framed" * 9)
        assert _hits() == h0 + 1
        assert requests.delete(f"http://{vs.url}/{fid}",
                               timeout=10).status_code == 202
        h0 = _hits()
        assert _get(vs.url, fid)[0] == 404
        assert _hits() == h0

        uploads = [(f, d, {}, "") for f, d, _, _ in _needles(20, seed=2)]
        for f, d, _, _ in uploads:
            assert requests.post(f"http://{vs.url}/{f}", data=d,
                                 timeout=10).status_code == 201
        vs.volume_mark_readonly(VID)
        vs.volume_ec_shards_generate(VID)
        vs.volume_ec_shards_mount(VID)
        vs.volume_delete(VID)
        assert vs.store.find_ec_volume(VID) is not None
        h0, entries = _hits(), len(vs.read_cache)
        for _ in range(2):
            for f, d, _, _ in uploads:
                assert _get(vs.url, f)[:2] == (200, d)
        assert (_hits(), len(vs.read_cache)) == (h0, entries)
    finally:
        vs.stop()


def _pair(tmp_path, guard=None, b_guard=None, **kw):
    """Port servers A and B joined by LocalPeers, a "001" volume on both."""
    a = _port(tmp_path / "a", guard=guard, **kw)
    b = _port(tmp_path / "b", guard=b_guard if b_guard is not None else guard,
              **kw)
    peers = LocalPeers({s.peer_address: s for s in (a, b)})
    for s in (a, b):
        s.allocate_volume(VID, replication="001")
    return a, b, peers


def test_replicated_pair_writes_bulk_and_deletes(tmp_path):
    """Two port servers over LocalPeers holding a "001" volume: a POST and
    a /bulk frame on A read back from B, a DELETE on B reaches A, and a
    transient failure of the hop (replicate.peer, twice) is retried."""
    from seaweedfs_tpu_torch.storage import bulk
    from seaweedfs_tpu_torch.utils import failpoints
    a, b, peers = _pair(tmp_path)
    try:
        assert peers.lookup_volume(VID) == [a.url, b.url]
        uploads = _needles(12, seed=6)
        for fid, data, headers, query in uploads:
            r = requests.post(f"http://{a.url}/{fid}{query}", data=data,
                              headers=headers, timeout=10)
            assert r.status_code == 201, r.text
        for fid, _, _, _ in uploads:
            assert _get(b.url, fid) == _get(a.url, fid)
            assert _get(b.url, fid, **{"Accept-Encoding": "gzip"}) == \
                _get(a.url, fid, **{"Accept-Encoding": "gzip"})
        frame, entries = _frame(VID, 64, seed=11, start=1000)
        r = requests.put(f"http://{a.url}/bulk?vid={VID}&ttl=3d", data=frame,
                         timeout=10)
        assert r.status_code == 201
        req = bulk.pack_read_request(VID, [(k, c) for k, c, _, _ in entries])
        got = [requests.post(f"http://{s.url}/bulk-read", data=req,
                             timeout=10).content for s in (a, b)]
        assert got[0] == got[1]
        assert [bytes(x.data) for x in bulk.unpack_read_response(got[1])[1]] \
            == [d for _, _, d, _ in entries]
        assert str(b.store.read_needle(VID, 1000).ttl) == "3d"
        # a DELETE through B reaches A
        gone = uploads[0][0]
        assert requests.delete(f"http://{b.url}/{gone}",
                               timeout=10).status_code == 202
        assert _get(a.url, gone)[0] == _get(b.url, gone)[0] == 404
        # two failed hop attempts, then the third lands: the write acks
        failpoints.configure("replicate.peer", "times:2:error")
        try:
            fid = file_id(VID, 0x900, 0x42)
            assert requests.post(f"http://{a.url}/{fid}", data=b"retried",
                                 timeout=30).status_code == 201
            assert failpoints.fired("replicate.peer") >= 2
        finally:
            failpoints.clear("replicate.peer")
        assert _get(b.url, fid)[:2] == (200, b"retried")
        # a hop on B itself never fans back out
        fid = file_id(VID, 0x901, 0x42)
        assert requests.post(f"http://{b.url}/{fid}?type=replicate",
                             data=b"b only", timeout=10).status_code == 201
        assert _get(b.url, fid)[0] == 200 and _get(a.url, fid)[0] == 404
    finally:
        a.stop()
        b.stop()


def test_peer_4xx_fails_the_write_at_once(tmp_path):
    """A peer that answers 4xx (here 401: B checks tokens, A mints none)
    fails the write without a retry or a breaker charge; one that cannot
    be reached at all is retried and then fails it."""
    from seaweedfs_tpu_torch.security import Guard
    from seaweedfs_tpu_torch.stats import RETRY_ATTEMPTS
    a, b, peers = _pair(tmp_path, b_guard=Guard(signing_key="k"))
    try:
        r0 = RETRY_ATTEMPTS.value("replicate.peer")
        fid = file_id(VID, 0x31, 0x99)
        r = requests.post(f"http://{a.url}/{fid}", data=b"x" * 100,
                          timeout=30)
        assert r.status_code == 500 and "HTTP 401" in r.text
        assert RETRY_ATTEMPTS.value("replicate.peer") == r0
        assert retry.breaker(b.url).state == "closed"
        assert _get(b.url, fid)[0] == 404
        b.stop()  # B still listed as a holder, but gone
        r = requests.post(f"http://{a.url}/{fid}", data=b"y", timeout=60)
        assert r.status_code == 500
        assert RETRY_ATTEMPTS.value("replicate.peer") > r0
    finally:
        a.stop()
        b.stop()


def test_proxy_and_redirect_reads(tmp_path):
    """A third server without the volume proxies GETs to a holder (bodies,
    Range and its Content-Range, gzip) and, in redirect mode, answers 301
    to a holder; a proxied hop is never forwarded again."""
    a, b, peers = _pair(tmp_path)
    c = _port(tmp_path / "c")
    d = _port(tmp_path / "d", read_mode="redirect")
    e = _port(tmp_path / "e", read_mode="local")
    peers = LocalPeers({s.peer_address: s for s in (a, b, c, d, e)})
    try:
        uploads = _needles(16, seed=12)
        for fid, data, headers, query in uploads:
            assert requests.post(f"http://{a.url}/{fid}{query}", data=data,
                                 headers=headers,
                                 timeout=10).status_code == 201
        for fid, _, _, _ in uploads:
            for hdr in ({}, {"Accept-Encoding": "gzip"},
                        {"Range": "bytes=3-200"}, {"Range": "bytes=999999-"}):
                assert _get(c.url, fid, **hdr) == _get(a.url, fid, **hdr), \
                    (fid, hdr)
        fid = uploads[0][0]
        r = requests.get(f"http://{d.url}/{fid}?x=1", allow_redirects=False,
                         timeout=10)
        assert r.status_code == 301
        assert r.headers["Location"] in (f"http://{s.url}/{fid}?x=1&proxied=1"
                                         for s in (a, b))
        assert requests.get(f"http://{d.url}/{fid}",
                            timeout=10).content == uploads[0][1]
        assert _get(e.url, fid)[0] == 404
        assert _get(c.url, f"{fid}")[0] == 200
        assert requests.get(f"http://{c.url}/{fid}?proxied=1",
                            timeout=10).status_code == 404
        missing = file_id(VID + 9, 1, 1)
        assert _get(c.url, missing)[0] == 404
    finally:
        for s in (a, b, c, d, e):
            s.stop()


def test_guarded_pair_writes_with_master_tokens(tmp_path):
    """With a guard on both servers: a write without a token gets 401, one
    with the master-style single-fid token 201, and its replica hop
    carries a re-minted token B accepts; a /bulk frame takes a range
    token; reads stay open without a read key."""
    from seaweedfs_tpu_torch.security import (Guard, gen_jwt_for_fid_range,
                                              gen_jwt_for_volume_server)
    from seaweedfs_tpu_torch.storage import bulk
    key = "cluster-signing-key"
    a, b, peers = _pair(tmp_path, guard=Guard(signing_key=key))
    try:
        fid = file_id(VID, 0x77, 0xC0FFEE)
        url = f"http://{a.url}/{fid}"
        assert requests.post(url, data=b"nope", timeout=10).status_code == 401
        tok = gen_jwt_for_volume_server(key, 10, fid)
        wrong = gen_jwt_for_volume_server(key, 10, file_id(VID, 0x78, 1))
        assert requests.post(f"{url}?jwt={wrong}", data=b"nope",
                             timeout=10).status_code == 401
        assert requests.post(f"{url}?jwt={tok}", data=b"signed",
                             timeout=10).status_code == 201
        assert _get(b.url, fid)[:2] == (200, b"signed")
        assert b._peer_jwt_param(fid).startswith("&jwt=")
        frame, entries = _frame(VID, 8, seed=13, cookie=0xC0FFEE, start=0x100,
                                gzip_every=0)
        assert requests.put(f"http://{a.url}/bulk", data=frame,
                            timeout=10).status_code == 401
        rtok = gen_jwt_for_fid_range(key, 10, VID, 0x100, 8, 0xC0FFEE)
        assert requests.put(f"http://{a.url}/bulk?jwt={rtok}", data=frame,
                            timeout=10).status_code == 201
        for k, c, d, _ in entries:
            assert _get(b.url, file_id(VID, k, c))[:2] == (200, d)
        assert requests.delete(url, timeout=10).status_code == 401
        assert requests.delete(f"{url}?jwt={tok}",
                               timeout=10).status_code == 202
        assert _get(b.url, fid)[0] == 404
    finally:
        a.stop()
        b.stop()


def test_replica_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """chip_smoke.py's phase 14 (the replicated data plane: /bulk frames
    replicated to B with equal .idx, POSTs and DELETEs fanned out, GETs
    through the read cache, proxied and redirected GETs, /bulk-read healthy
    and degraded after the seal, VolumeScrub of the replica) on the CPU at
    a small size, its checks as fatal as on the card."""
    import chip_smoke
    geo = EcGeometry(10, 4, large_block=8192, small_block=1024)
    res = chip_smoke.replica_round_trip(
        np, str(tmp_path), 29, "cpu", geo, needles=1280, frame=128, posts=40,
        deletes=8, gets=160, proxied=40, bulk_sample=500, bulk_frame=64,
        device="cpu")
    assert len(res["post"]) == 40 and [len(p) for p in res["get"]] == [160, 160]
    assert len(res["proxy"]) == 40 and res["reconstructs"] > 0
    assert res["bulk_read"] > 0 and res["degraded_bulk_read"] > 0
    assert res["scrub"] > 0 and res["ingest"] > 0


# -- the maintenance plane against the JAX server -----------------------------

def _twins(tmp_path, uploads, name="src"):
    """A port server and a JAX server holding byte-equal copies of volume
    VID: the uploads POSTed to the port's, its files copied to the JAX
    server's (the two .dat would differ in append timestamps otherwise)."""
    vs = _port(tmp_path / f"port_{name}")
    ref = _ref(tmp_path / f"ref_{name}")
    vs.allocate_volume(VID)
    for fid, data, headers, query in uploads:
        r = requests.post(f"http://{vs.url}/{fid}{query}", data=data,
                          headers=headers, timeout=10)
        assert r.status_code == 201
    _mirror(vs, ref, tmp_path / f"ref_{name}", fresh=True)
    return vs, ref


def _mirror(vs, ref, ref_dir, fresh=False):
    """Copy the port server's files of VID over the JAX server's."""
    vs.store.find_volume(VID).sync()
    stub = _stub(ref)
    if not fresh:
        stub.call("VolumeUnmount", vpb.VolumeUnmountRequest(volume_id=VID),
                  vpb.VolumeUnmountResponse)
    src = vs.store.find_volume(VID).file_name()
    for ext in (".dat", ".idx"):
        shutil.copy(src + ext, ref_dir / f"{VID}{ext}")
    stub.call("VolumeMount", vpb.VolumeMountRequest(volume_id=VID),
              vpb.VolumeMountResponse)


def _files(base):
    return {ext: _sha(base + ext) for ext in (".dat", ".idx")}


def test_volume_copy_tail_and_incremental_against_reference(tmp_path):
    """VolumeCopy onto a second server of each package, byte-equal to the
    source; the "already here" refusal with the same code; after more
    writes, VolumeSyncStatus, VolumeTailReceiver (the copies' .dat and .idx
    equal the source's again) and VolumeIncrementalCopy (the source's tail
    bytes) alike."""
    import grpc
    uploads = _needles(40, seed=11)
    vs, ref = _twins(tmp_path, uploads)
    vs2, ref2 = _port(tmp_path / "port_dst"), _ref(tmp_path / "ref_dst")
    LocalPeers({vs.peer_address: vs, vs2.peer_address: vs2})
    stub2 = _stub(ref2)
    ref_src = f"127.0.0.1:{ref.grpc_port}"
    try:
        base = vs.store.find_volume(VID).file_name()
        ref_base = str(tmp_path / "ref_src" / str(VID))
        assert _files(base) == _files(ref_base)
        got = vs2.volume_copy(VID, "", vs.peer_address)
        want = stub2.call("VolumeCopy", vpb.VolumeCopyRequest(
            volume_id=VID, source_data_node=ref_src), vpb.VolumeCopyResponse,
            timeout=60)
        assert got == want.last_append_at_ns
        copy_base = vs2.store.find_volume(VID).file_name()
        ref_copy_base = str(tmp_path / "ref_dst" / str(VID))
        assert _files(copy_base) == _files(ref_copy_base) == _files(base)
        with pytest.raises(RpcAbort) as e:
            vs2.volume_copy(VID, "", vs.peer_address)
        with pytest.raises(grpc.RpcError) as ref_e:
            stub2.call("VolumeCopy", vpb.VolumeCopyRequest(
                volume_id=VID, source_data_node=ref_src),
                vpb.VolumeCopyResponse)
        # the JAX package passes the bare int 6 to context.abort, which
        # grpc sends as UNKNOWN: the same refusal, the port's with its code
        assert e.value.code == 6 and e.value.message == ref_e.value.details()
        assert _gets_equal((vs2.url, ref2.url), uploads)

        # the sources move on; the copies catch up by the tail
        since = vs2.store.find_volume(VID).last_record_append_ns()
        more = _needles(24, seed=12)
        for fid, data, headers, query in more:
            assert requests.post(f"http://{vs.url}/{fid}{query}", data=data,
                                 headers=headers, timeout=10).status_code == 201
        gone = uploads[3][0]  # deleted on the source alone: no fan-out
        assert requests.delete(f"http://{vs.url}/{gone}?type=replicate",
                               timeout=10).status_code == 202
        _mirror(vs, ref, tmp_path / "ref_src")
        assert _files(base) == _files(ref_base)
        status = vs.volume_sync_status(VID)
        ref_status = _stub(ref).call(
            "VolumeSyncStatus", vpb.VolumeSyncStatusRequest(volume_id=VID),
            vpb.VolumeSyncStatusResponse)
        for k, v in status.items():
            if k != "last_append_at_ns":  # a loaded volume's is 0 in the
                # JAX package, the port's source kept its POSTs' stamp
                assert getattr(ref_status, k) == v, k

        raw = b"".join(vs.volume_incremental_copy(VID, since))
        ref_raw = b"".join(r.file_content for r in _stub(ref).call_stream(
            "VolumeIncrementalCopy", vpb.VolumeIncrementalCopyRequest(
                volume_id=VID, since_ns=since),
            vpb.VolumeIncrementalCopyResponse))
        with open(base + ".dat", "rb") as f:
            tail = f.read()[os.path.getsize(copy_base + ".dat"):]
        assert raw == ref_raw == tail and raw

        got = vs2.volume_tail_receiver(VID, since, 1, vs.peer_address)
        want = stub2.call("VolumeTailReceiver", vpb.VolumeTailReceiverRequest(
            volume_id=VID, since_ns=since, idle_timeout_seconds=1,
            source_volume_server=ref_src), vpb.VolumeTailReceiverResponse,
            timeout=60)
        assert got == want.received == len(more) + 1  # + the tombstone
        vs2.volume_sync_status(VID)  # both flush the copy's .idx
        stub2.call("VolumeSyncStatus", vpb.VolumeSyncStatusRequest(
            volume_id=VID), vpb.VolumeSyncStatusResponse)
        assert _files(copy_base) == _files(ref_copy_base) == _files(base)
        assert _gets_equal((vs2.url, ref2.url), more + uploads)
    finally:
        for s in (vs, ref, vs2, ref2):
            s.stop()


def test_tail_sender_stops_when_the_client_goes():
    """With no idle timeout the tail follows while the caller's stream
    lives; `alive()` turning false ends it at the next tick."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer as VS
    calls = []

    class _V:
        def read_records_since(self, ns):
            calls.append(ns)
            return iter(())

    vs = VS.__new__(VS)
    vs._stop = __import__("threading").Event()
    alive = iter([True, True, True, False])
    assert list(vs._tail(_V(), 5, 0, lambda: next(alive), 0.001)) == []
    assert calls == [5, 5, 5]


def test_batch_delete_needle_status_and_configure_against_reference(
        tmp_path):
    """BatchDelete statuses (202, 404 and 500), VolumeNeedleStatus fields
    and its NOT_FOUND, and VolumeConfigure's super block and errors, alike
    on byte-equal volumes."""
    import grpc
    uploads = _needles(30, seed=21)
    vs, ref = _twins(tmp_path, uploads)
    stub = _stub(ref)
    try:
        for fid, data, headers, _ in uploads[:12]:
            key = int(fid.split(",")[1][:-8], 16)
            got = vs.volume_needle_status(VID, key)
            r = stub.call("VolumeNeedleStatus", vpb.VolumeNeedleStatusRequest(
                volume_id=VID, needle_id=key), vpb.VolumeNeedleStatusResponse)
            assert got == {f: getattr(r, f) for f in got}
            assert got["size"] == len(data)
        with pytest.raises(RpcAbort) as e:
            vs.volume_needle_status(VID, 1 << 50)
        with pytest.raises(grpc.RpcError) as ref_e:
            stub.call("VolumeNeedleStatus", vpb.VolumeNeedleStatusRequest(
                volume_id=VID, needle_id=1 << 50),
                vpb.VolumeNeedleStatusResponse)
        assert e.value.code == 5 and e.value.message == ref_e.value.details()

        fids = ([u[0] for u in uploads[:10]]
                + [file_id(VID, 1 << 45, 7), "not-a-fid", file_id(99, 1, 2),
                   uploads[0][0]])
        got = vs.batch_delete(fids)
        resp = stub.call("BatchDelete", vpb.BatchDeleteRequest(file_ids=fids),
                         vpb.BatchDeleteResponse)
        want = [{"file_id": r.file_id, "status": r.status,
                 **({"error": r.error} if r.error else {})}
                for r in resp.results]
        assert got == want
        assert [r["status"] for r in got] == [202] * 10 + [404, 500, 500,
                                                           404]
        for fid, *_ in uploads[:10]:
            assert _get(vs.url, fid)[0] == _get(ref.url, fid)[0] == 404

        for rep in ("001", "210", "0x1"):
            err = vs.volume_configure(VID, rep)
            ref_err = stub.call("VolumeConfigure", vpb.VolumeConfigureRequest(
                volume_id=VID, replication=rep),
                vpb.VolumeConfigureResponse).error
            assert err == ref_err, rep
            vs.store.find_volume(VID).sync()
            with open(vs.store.find_volume(VID).file_name() + ".dat",
                      "rb") as f, \
                    open(tmp_path / "ref_src" / f"{VID}.dat", "rb") as g:
                assert f.read(8) == g.read(8)
        hb = {v["id"]: v for v in vs.heartbeat()["volumes"]}
        assert hb[VID]["replica_placement"] == 210  # the byte is xyz decimal
        assert vs.volume_configure(77, "001") == stub.call(
            "VolumeConfigure", vpb.VolumeConfigureRequest(
                volume_id=77, replication="001"),
            vpb.VolumeConfigureResponse).error != ""
    finally:
        vs.stop()
        ref.stop()


def _json_uploads(n=24, seed=31):
    """JSON-lines needles (a few gzip-stored) and one CSV needle."""
    import json as _json
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, n + 1):
        lines = [_json.dumps({"id": i * 100 + j,
                              "kind": str(rng.choice(["a", "b", "c"])),
                              "size": int(rng.integers(0, 5000)),
                              "user": {"age": int(rng.integers(1, 99))}})
                 for j in range(int(rng.integers(5, 60)))]
        data = ("\n".join(lines) + "\n").encode()
        headers = {}
        if i % 5 == 0:
            data = gzip.compress(data)
            headers["Content-Encoding"] = "gzip"
        out.append((file_id(VID, i, int(rng.integers(1, 1 << 32))), data,
                    headers, ""))
    csv_rows = "\n".join(f"{j},{rng.choice(['x', 'y'])},{j * 7 % 13}"
                         for j in range(40))
    out.append((file_id(VID, n + 1, 0xC5C5), ("id,tag,v\n" + csv_rows
                                               + "\n").encode(), {}, ""))
    return out


_QUERIES = [
    dict(field="kind", op="=", value="b", projections=["id", "user.age"]),
    dict(field="size", op=">", value="2500", projections=[]),
    dict(field="user.age", op="<=", value="30", projections=["kind"],
         output_format="csv", output_delimiter=";"),
    dict(field="", op="", value="", projections=["id"]),
]


def _ref_query(stub, fids, q, input_format="json", has_header=False):
    req = vpb.QueryRequest(from_file_ids=fids)
    req.filter.field, req.filter.operand, req.filter.value = \
        q["field"], q["op"], q["value"]
    req.projections.extend(q["projections"])
    req.input_serialization.format = input_format
    req.input_serialization.csv_has_header = has_header
    req.output_serialization.format = q.get("output_format", "")
    req.output_serialization.csv_delimiter = q.get("output_delimiter", "")
    return [s.records for s in stub.call_stream("Query", req,
                                                vpb.QueriedStripe)]


def _port_query(vs, fids, q, input_format="json", has_header=False):
    return list(vs.query(fids, q["field"], q["op"], q["value"],
                         q["projections"], input_format, "", has_header,
                         q.get("output_format", ""),
                         q.get("output_delimiter", "")))


def test_query_against_reference_plain_and_degraded_ec(tmp_path):
    """Query over JSON-lines needles (gzip-stored ones too) and a CSV one,
    with filters, projections and CSV output: the same stripes as the JAX
    server, on the plain volume and again once it is sealed at RS(4,2)
    with two shards lost, where the port reconstructs the needles on lost
    shards; an unknown fid is refused alike."""
    import grpc
    uploads = _json_uploads()
    vs, ref = _twins(tmp_path, uploads)
    stub = _stub(ref)
    fids = [u[0] for u in uploads[:-1]]
    csv_fid = [uploads[-1][0]]

    def all_equal(tag):
        n = 0
        for q in _QUERIES:
            got = _port_query(vs, fids, q)
            assert got == _ref_query(stub, fids, q), (tag, q)
            n += len(got)
            got = _port_query(vs, csv_fid, q, "csv", True)
            assert got == _ref_query(stub, csv_fid, q, "csv", True), (tag, q)
        return n

    try:
        assert all_equal("plain") > 10
        with pytest.raises(RpcAbort) as e:
            list(vs.query(fids[:2] + [file_id(VID, 999, 1)]))
        with pytest.raises(grpc.RpcError) as ref_e:
            _ref_query(stub, fids[:2] + [file_id(VID, 999, 1)], _QUERIES[3])
        assert e.value.code == 5 and e.value.message == ref_e.value.details()

        vs.volume_mark_readonly(VID)
        vs.volume_ec_shards_generate(VID)
        vs.volume_ec_shards_mount(VID)
        vs.volume_delete(VID)
        vs.volume_ec_shards_delete(VID, shard_ids=list(LOST))
        for method, req, resp in (
                ("VolumeMarkReadonly",
                 vpb.VolumeMarkReadonlyRequest(volume_id=VID),
                 vpb.VolumeMarkReadonlyResponse),
                ("VolumeEcShardsGenerate",
                 vpb.VolumeEcShardsGenerateRequest(volume_id=VID),
                 vpb.VolumeEcShardsGenerateResponse),
                ("VolumeEcShardsMount",
                 vpb.VolumeEcShardsMountRequest(volume_id=VID),
                 vpb.VolumeEcShardsMountResponse),
                ("VolumeDelete", vpb.VolumeDeleteRequest(volume_id=VID),
                 vpb.VolumeDeleteResponse),
                ("VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest(
                    volume_id=VID, shard_ids=list(LOST)),
                 vpb.VolumeEcShardsDeleteResponse)):
            stub.call(method, req, resp, timeout=60)
        before = vs.read_stats.get("reconstructs", 0)
        assert all_equal("degraded ec") > 10
        assert vs.read_stats["reconstructs"] > before
    finally:
        vs.stop()
        ref.stop()


def test_leave_against_reference(tmp_path):
    """VolumeServerLeave: the heartbeat is no longer flushed, LocalPeers
    stops listing the server, and a direct GET still answers, as on the
    JAX server."""
    uploads = _needles(6, seed=41)
    vs, ref = _twins(tmp_path, uploads)
    other = _port(tmp_path / "other")
    peers = LocalPeers({vs.peer_address: vs, other.peer_address: other})
    try:
        vs.heartbeat_flush = lambda: True  # a bound heartbeat stream
        assert vs.flush_heartbeat()
        assert peers.lookup_volume(VID) == [vs.url]
        vs.volume_server_leave()
        assert not vs.flush_heartbeat()
        assert peers.lookup_volume(VID) == []
        # the JAX server left in _ref(): it answers, and heartbeats no more
        assert ref._leave.is_set() and not ref.flush_heartbeat()
        for fid, *_ in uploads:
            got = _get(vs.url, fid)
            assert got[0] == 200 and got == _get(ref.url, fid)
    finally:
        for s in (vs, ref, other):
            s.stop()


_POLICY = {"tenants": {"tiny": {"rps": 0.01, "burst": 1}},
           "classes": {"maintenance": {"bytes_per_s": "64KB",
                                       "burst_bytes": "16KB"}}}


def test_qos_shed_and_debug_qos_against_reference(tmp_path):
    """Under one policy: a tenant's second write sheds with 503 and the
    same Retry-After from both servers; /debug/qos dumps alike; on a
    guarded server its POST needs write admission (401 without) in both."""
    from seaweedfs_tpu.security import Guard as RefGuard
    from seaweedfs_tpu_torch.security import Guard
    vs = _port(tmp_path / "port", qos_policy=_POLICY,
               guard=Guard(signing_key="k"))
    store = RefStore("127.0.0.1", 0, "", [RefLocation(str(tmp_path / "ref"))],
                     coder_name="numpy")
    port = free_port_pair()
    store.port, store.public_url = port, f"127.0.0.1:{port}"
    ref = RefServer(store, f"127.0.0.1:{free_port_pair()}", port=port,
                    grpc_port=port + 10000, pulse_seconds=0.5,
                    read_mode="local", qos_policy=_POLICY,
                    guard=RefGuard(signing_key="k"))
    ref.start()
    _stub(ref).call("VolumeServerLeave", vpb.VolumeServerLeaveRequest(),
                    vpb.VolumeServerLeaveResponse)
    try:
        from seaweedfs_tpu_torch.security import gen_jwt_for_volume_server
        vs.allocate_volume(VID, collection="tiny")
        _stub(ref).call("AllocateVolume", vpb.AllocateVolumeRequest(
            volume_id=VID, collection="tiny"), vpb.AllocateVolumeResponse)
        answers = []
        for url in (vs.url, ref.url):
            got = []
            for i in (1, 2):
                fid = file_id(VID, i, 0x77)
                tok = gen_jwt_for_volume_server("k", 10, fid)
                r = requests.post(f"http://{url}/{fid}?jwt={tok}",
                                  data=b"x" * 100, timeout=10)
                got.append((r.status_code, r.headers.get("Retry-After"),
                            r.json().get("qos")))
            answers.append(got)
        assert answers[0] == answers[1] == [(201, None, None),
                                            (503, "100", "shed")]
        dumps = [requests.get(f"http://{u}/debug/qos", timeout=10).json()
                 for u in (vs.url, ref.url)]
        for d in dumps:  # byte-token levels refill between the two reads
            for c in d["classes"].values():
                c.pop("byte_tokens", None)
        assert dumps[0]["totals"] == dumps[1]["totals"] == \
            {"admitted": 1, "shed": 1}
        assert dumps[0]["classes"] == dumps[1]["classes"]
        assert [t["tenant"] for t in dumps[0]["tenants"]] == \
            [t["tenant"] for t in dumps[1]["tenants"]]
        for u in (vs.url, ref.url):
            r = requests.post(f"http://{u}/debug/qos", json={}, timeout=10)
            assert r.status_code == 401
            tok = gen_jwt_for_volume_server("k", 10, "")
            r = requests.post(f"http://{u}/debug/qos?jwt={tok}",
                              json={"enabled": False}, timeout=10)
            assert (r.status_code, r.json()) == (200, {"ok": True,
                                                       "enabled": False})
    finally:
        vs.stop()
        ref.stop()


def test_maintenance_pulls_admit_on_the_serving_server(tmp_path):
    """VolumeCopy runs maintenance-class: its CopyFile pulls admit against
    the source server's maintenance budget (queued behind a small byte
    bucket, so the wait histogram moves), while the same server's GETs stay
    interactive; an untagged CopyFile stays admission-free."""
    from seaweedfs_tpu_torch.stats import QOS_REQUESTS, QOS_WAIT_SECONDS
    policy = {"classes": {"maintenance": {"rps": 2, "burst": 1}}}
    src = _port(tmp_path / "src", qos_policy=policy)
    dst = _port(tmp_path / "dst")
    LocalPeers({src.peer_address: src, dst.peer_address: dst})
    uploads = _needles(8, seed=51)
    try:
        src.allocate_volume(VID)
        for fid, data, headers, query in uploads:
            assert requests.post(f"http://{src.url}/{fid}{query}", data=data,
                                 headers=headers, timeout=10).status_code \
                == 201

        def maint():
            return sum(QOS_REQUESTS.value("default", "maintenance", o)
                       for o in ("admitted", "queued"))
        m0, w0 = maint(), QOS_WAIT_SECONDS.count("maintenance")
        list(src.copy_file(VID, "", ".idx"))  # untagged: not admitted
        assert maint() == m0
        dst.volume_copy(VID, "", src.peer_address)
        assert maint() - m0 == 2  # .dat and .idx
        assert QOS_WAIT_SECONDS.count("maintenance") > w0  # one queued
        assert _gets_equal((dst.url, src.url), uploads)
        assert QOS_REQUESTS.value("default", "interactive", "admitted") > 0
    finally:
        src.stop()
        dst.stop()


def test_maintenance_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """chip_smoke.py's phase 15 (the maintenance plane over gRPC under mTLS:
    VolumeCopy, the tail, incremental copy, BatchDelete, VolumeNeedleStatus,
    VolumeConfigure, VolumeScrub, the seal and a maintenance-class rebuild
    under a QoS policy with GETs from B alongside, Query over a degraded EC
    volume, a shed write and leave with its heartbeat stream ending) on the
    CPU at a small size, its checks as fatal as on the card."""
    import chip_smoke
    geo = EcGeometry(10, 4, large_block=8192, small_block=1024)
    res = chip_smoke.maintenance_round_trip(
        np, str(tmp_path), 31, "cpu", geo, needles=3000, more=300,
        deletes=128, statuses=64, gets=64, query_needles=120, device="cpu",
        pulse_seconds=0.5, maint_rate="2MB", maint_burst="64KB")
    assert res["copy"] > 0 and res["tail"] > 0 and res["scrub"] > 0
    assert res["reconstructs"] > 0 and res["gets_during_rebuild"]
    assert res["qos"]["maint_waits"] > 0 and res["qos"]["maint_wait_s"] > 0


# -- the profiling plane, the debug routes and the status UI -----------------

def _route(url, path, method="GET", **kw):
    r = requests.request(method, f"http://{url}{path}", timeout=30, **kw)
    ctype = r.headers.get("Content-Type", "")
    body = r.json() if ctype.startswith("application/json") else r.text
    return r.status_code, body


def _keys(body):
    return sorted(body) if isinstance(body, dict) else type(body).__name__


_DEBUG_REQUESTS = [
    ("GET", "/debug/profile?mode=summary"),
    ("GET", "/debug/profile?mode=continuous"),
    ("GET", "/debug/profile?hz=abc"), ("GET", "/debug/profile?hz=-1"),
    ("GET", "/debug/profile?mode=bogus"),
    ("GET", "/debug/profile?seconds=nan"),
    ("GET", "/debug/profile?mode=summary&top=x"),
    ("POST", "/debug/profile?mode=summary"),
    ("GET", "/debug/flight"), ("GET", "/debug/flight?min_ms=abc"),
    ("GET", "/debug/flight?limit=3&type=volume.get"),
    ("DELETE", "/debug/flight"),
    ("GET", "/debug/traces"), ("GET", "/debug/traces?limit=2"),
    ("GET", "/debug/events"), ("GET", "/debug/events?type=ec."),
    ("GET", "/debug/locks"), ("GET", "/debug/locks?edges=1"),
    ("GET", "/debug/failpoints"),
    ("GET", "/debug/failpoints?name=ec.shard.read"),
    ("GET", "/debug/failpoints?name=ec.shard.read&spec=bogus"),
    ("GET", "/debug/lifecycle"), ("GET", "/debug/qos"),
    ("GET", "/ui"), ("GET", "/status"),
]


def test_debug_routes_answer_like_reference(tmp_path):
    """Every debug route the reference registers, and /ui, on twin servers
    after the same reads: the same status codes and the same payload keys
    (the values are each process's own)."""
    uploads = _needles(12, seed=71)
    vs, ref = _twins(tmp_path, uploads)
    try:
        _gets_equal((vs.url, ref.url), uploads)
        for method, path in _DEBUG_REQUESTS:
            (code, body), (ref_code, ref_body) = (
                _route(u, path, method) for u in (vs.url, ref.url))
            assert code == ref_code, (method, path, body, ref_body)
            if isinstance(body, dict) and path != "/status":
                assert _keys(body) == _keys(ref_body), (method, path)
        # the per-volume heat report: the same keys and counts
        (_, life), (_, ref_life) = (_route(u, "/debug/lifecycle")
                                    for u in (vs.url, ref.url))
        mine, theirs = life["volumes"][str(VID)], ref_life["volumes"][str(VID)]
        assert sorted(mine) == sorted(theirs)
        for k in ("collection", "size", "read_only", "tiered", "reads"):
            assert mine[k] == theirs[k], k
        assert mine["reads"] > 0
        # the sampler's summary carries the port's ec_read class beside
        # the reference's
        _, summary = _route(vs.url, "/debug/profile?mode=summary")
        assert set(summary) == {"hz", "ticks", "samples", "classes",
                                "stacks"}
    finally:
        vs.stop()
        ref.stop()


def _ui_tables(html):
    import re
    rows = re.findall(r"<tr>(.*?)</tr>", html)
    return [re.findall(r"<t[dh]>(.*?)</t[dh]>", r) for r in rows]


def test_ui_rows_equal_reference(tmp_path):
    uploads = _needles(20, seed=72)
    vs, ref = _twins(tmp_path, uploads)
    try:
        (code, page), (ref_code, ref_page) = (_route(u, "/ui")
                                              for u in (vs.url, ref.url))
        assert code == ref_code == 200
        got, want = _ui_tables(page), _ui_tables(ref_page)
        # the facts differ only in the master each server names
        facts = [r for r in got if r and r[0] == "Master"]
        assert facts == [["Master", ""]]
        assert [r for r in got if r[0] != "Master"] == \
            [r for r in want if r[0] != "Master"]
        assert [str(VID), "-", "hdd"] == got[[r[0] for r in got].index(
            str(VID))][:3]
    finally:
        vs.stop()
        ref.stop()


def test_lifecycle_post_and_guard_like_reference(tmp_path):
    """POST /debug/lifecycle: 400 on a malformed body, 404 for a volume that
    is not EC here, 200 stamping the .vif on an EC volume; on a guarded
    server an unauthorised POST gets 401, as on the JAX server."""
    import time as _time

    from seaweedfs_tpu.security import Guard as RefGuard
    from seaweedfs_tpu_torch.security import Guard
    uploads = _needles(6, seed=73)
    vs, ref = _twins(tmp_path, uploads)
    try:
        for body in (b"not json", b'{"volume": "x"}', b'{"volume": 9}'):
            (code, _), (ref_code, _) = (
                _route(u, "/debug/lifecycle", "POST", data=body)
                for u in (vs.url, ref.url))
            assert code == ref_code and code == 400, body
        doc = json.dumps({"volume": 77, "destroy_time": 1e10}).encode()
        assert [_route(u, "/debug/lifecycle", "POST", data=doc)[0]
                for u in (vs.url, ref.url)] == [404, 404]
        vs.volume_mark_readonly(VID)
        vs.volume_ec_shards_generate(VID)
        vs.volume_ec_shards_mount(VID)
        at = _time.time() + 10 * 365 * 86400
        doc = json.dumps({"volume": VID, "destroy_time": at}).encode()
        code, body = _route(vs.url, "/debug/lifecycle", "POST", data=doc)
        assert (code, body) == (200, {"ok": True, "volume": VID,
                                      "destroy_time": at})
        _, life = _route(vs.url, "/debug/lifecycle")
        assert life["ec_volumes"][str(VID)]["destroy_time"] == at
        assert vs.store.find_ec_volume(VID).destroy_time == at
    finally:
        vs.stop()
        ref.stop()
    guarded = _port(tmp_path / "guarded", guard=Guard(signing_key="k"))
    ref_store = RefStore("127.0.0.1", 0, "", [RefLocation(
        str(tmp_path / "ref_guarded"))], coder_name="numpy")
    port = free_port_pair()
    ref_guarded = RefServer(ref_store, f"127.0.0.1:{free_port_pair()}",
                            port=port, grpc_port=port + 10000,
                            guard=RefGuard(signing_key="k"))
    ref_guarded.start()
    try:
        doc = json.dumps({"volume": 1, "destroy_time": 1.0}).encode()
        for path in ("/debug/lifecycle", "/debug/qos"):
            got = [_route(u, path, "POST", data=doc)[0]
                   for u in (guarded.url, f"127.0.0.1:{port}")]
            assert got == [401, 401], path
        assert _route(guarded.url, "/debug/lifecycle")[0] == 200
    finally:
        guarded.stop()
        ref_guarded.stop()


def test_failpoints_route_arms_and_disarms_like_reference(tmp_path):
    from seaweedfs_tpu.utils import failpoints as ref_failpoints
    from seaweedfs_tpu_torch.utils import failpoints
    uploads = _needles(4, seed=74)
    vs, ref = _twins(tmp_path, uploads)
    try:
        for u in (vs.url, ref.url):
            code, body = _route(
                u, "/debug/failpoints?name=ec.shard.read&spec=times:1:error")
            assert code == 200 and "ec.shard.read" in body["armed"]
        assert failpoints.active() and ref_failpoints.active()
        for u in (vs.url, ref.url):
            code, body = _route(u, "/debug/failpoints?name=ec.shard.read"
                                   "&spec=off")
            assert code == 200 and "ec.shard.read" not in body["armed"]
    finally:
        failpoints.clear_all()
        ref_failpoints.clear_all()
        vs.stop()
        ref.stop()


def test_requests_feed_stages_flight_and_hot_keys(tmp_path, monkeypatch):
    """Each request lands in VOLUME_STAGE_SECONDS by stage, the slow and
    failed ones in the flight recorder with the queue depths at admit, and
    every one in the hot-key sketches behind SeaweedFS_hot_requests."""
    from seaweedfs_tpu_torch import profiling
    from seaweedfs_tpu_torch.stats import VOLUME_STAGE_SECONDS
    from seaweedfs_tpu_torch.telemetry import hot
    fr = profiling.FlightRecorder(capacity=64, slow_ms=0.0)
    monkeypatch.setattr(profiling.flight, "FLIGHT", fr)
    hot.HOT.clear()
    vs = _port(tmp_path / "p")
    try:
        vs.allocate_volume(VID)
        uploads = _needles(5, seed=75)
        for fid, data, headers, query in uploads:
            requests.post(f"http://{vs.url}/{fid}{query}", data=data,
                          headers=headers, timeout=10)
        before = VOLUME_STAGE_SECONDS.count("get", "store")
        for fid, *_ in uploads:
            assert _get(vs.url, fid)[0] == 200
        assert _get(vs.url, file_id(VID, 999, 1))[0] == 404
        assert VOLUME_STAGE_SECONDS.count("get", "store") == before + 6
        entries = fr.snapshot(kind="volume.get", limit=100)
        assert len(entries) == 6 and {e["status"] for e in entries} == \
            {200, 404}
        for e in entries:
            assert set(e["stages_ms"]) == {"recv_parse", "queue_wait",
                                           "auth_admit", "store",
                                           "serialize_flush"}
            assert set(e["queue_depths"]) == {"read", "ec_read"}
            assert e["node"] == vs.url and e["loop_lag_ms"] is not None
        body = requests.get(f"http://{vs.url}/metrics", timeout=10).text
        assert f'SeaweedFS_hot_requests{{kind="volume",key="{VID}"}} 11' \
            in body
        assert 'SeaweedFS_hot_requests{kind="method",key="get"} 6' in body
        assert vs._read_pool.pool_label == "read"
        assert vs._ec_read_pool.pool_label == "ec_read"
        assert vs._loop_lag.probes >= 0 and vs._sampler is not None
    finally:
        vs.stop()
    assert vs._sampler is None


def test_device_trace_route_on_a_cpu_server(tmp_path):
    """/debug/jax-profiler keeps the reference's path: it starts one
    torch.profiler capture and answers where its trace goes; a second start
    answers the running capture; ?stop=1 writes it; a stop with nothing
    running is a 400. A capture that must hold the card's activity raises
    where the profiler cannot capture CUDA."""
    from seaweedfs_tpu_torch.utils import profiling
    vs = _port(tmp_path / "p")
    try:
        code, text = _route(vs.url, "/debug/jax-profiler")
        assert code == 200 and "capturing to" in text
        path = text.split("capturing to ")[1].split()[0]
        assert _route(vs.url, "/debug/jax-profiler")[1] == \
            f"device trace already capturing to {path}\n"
        vs.allocate_volume(VID)
        code, text = _route(vs.url, "/debug/jax-profiler?stop=1")
        assert (code, text) == (200, f"device trace written to {path}\n")
        assert json.load(open(path))["traceEvents"] is not None
        os.unlink(path)
        assert _route(vs.url, "/debug/jax-profiler?stop=1")[0] == 400
    finally:
        vs.stop()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cannot capture CUDA"):
            profiling.start_device_trace(cuda=True)
        assert profiling.device_trace_path() is None
