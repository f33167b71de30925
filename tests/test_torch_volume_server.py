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
