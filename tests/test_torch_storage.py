"""The port's storage volume layer (seaweedfs_tpu_torch/storage/) against the
JAX package's: needle and super-block bytes, the needle maps, and volumes
written by either package read back by the other, needle for needle."""

import os
import shutil
import struct
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import needle_map as ref_nm
from seaweedfs_tpu.storage import super_block as ref_sb
from seaweedfs_tpu.storage import types as ref_t
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.storage import bulk, needle, needle_map, read_cache
from seaweedfs_tpu_torch.storage import super_block, types as t, volume
from seaweedfs_tpu_torch.utils import failpoints

NOW = 1_700_000_000_123_456_789


def _fields(rng, i):
    data = rng.integers(0, 256, int(rng.integers(0, 3000)), np.uint8).tobytes()
    return dict(id=int(rng.integers(1, 1 << 62)), cookie=int(rng.integers(0, 1 << 32)),
                data=data,
                name=b"file-%d.bin" % i if i % 2 else b"",
                mime=b"application/octet-stream" if i % 3 == 0 else b"",
                pairs={"k": "v", "n": str(i)} if i % 4 == 1 else {},
                last_modified=1_600_000_000 + i if i % 5 else 0,
                is_gzipped=bool(i % 7 == 3), is_chunk_manifest=bool(i % 11 == 5))


@pytest.mark.parametrize("ttl", ["", "5m", "3h", "2d", "1w", "4M", "1y"])
def test_needle_bytes_equal_reference(ttl):
    rng = np.random.default_rng(len(ttl))
    for i in range(12):
        f = _fields(rng, i)
        got = needle.Needle(**f, ttl=t.TTL.parse(ttl)).to_bytes(now_ns=NOW + i)
        want = ref_needle.Needle(**f, ttl=ref_t.TTL.parse(ttl)).to_bytes(now_ns=NOW + i)
        assert got == want
        back = needle.Needle.from_bytes(want)
        assert (back.id, back.cookie, back.data, back.name, back.mime,
                back.pairs, back.last_modified, str(back.ttl), back.is_gzipped,
                back.is_chunk_manifest, back.append_at_ns) == (
            f["id"], f["cookie"], f["data"], f["name"], f["mime"], f["pairs"],
            f["last_modified"], ttl if ttl != "" else "", f["is_gzipped"],
            f["is_chunk_manifest"], NOW + i)


def test_tombstone_bytes_equal_reference():
    for nid, cookie in ((1, 0), (0xDEADBEEF, 7), ((1 << 64) - 1, 0xFFFFFFFF)):
        rec = needle.Needle.tombstone(nid, cookie, now_ns=NOW)
        assert rec == ref_needle.Needle.tombstone(nid, cookie, now_ns=NOW)
        back = needle.Needle.from_bytes(rec)
        assert back.is_deleted and back.id == nid and back.append_at_ns == NOW


def test_from_bytes_rejects_crc_mismatch():
    rec = bytearray(needle.Needle(id=5, cookie=9, data=b"hello world").to_bytes(now_ns=NOW))
    rec[20] ^= 0x01
    with pytest.raises(ValueError, match="CRC mismatch"):
        needle.Needle.from_bytes(bytes(rec))
    with pytest.raises(ValueError, match="CRC mismatch"):
        ref_needle.Needle.from_bytes(bytes(rec))
    assert needle.Needle.from_bytes(bytes(rec), verify_crc=False).data == b"iello world"


def test_record_sizes_equal_reference():
    for size in (0, 1, 5, 7, 8, 1024, 1087, t.TOMBSTONE_SIZE):
        assert needle.record_size_from_header(size) == \
            ref_needle.record_size_from_header(size)
    n = needle.Needle(id=1, cookie=2, data=b"x" * 100, name=b"n")
    assert n.disk_size() == ref_needle.Needle(id=1, cookie=2, data=b"x" * 100,
                                              name=b"n").disk_size()


@pytest.mark.parametrize("rp,ttl,rev", [("000", "", 0), ("010", "3d", 7),
                                        ("201", "15m", 65535)])
def test_super_block_bytes_equal_reference(rp, ttl, rev):
    sb = super_block.SuperBlock(replica_placement=t.ReplicaPlacement.parse(rp),
                                ttl=t.TTL.parse(ttl), compaction_revision=rev)
    want = ref_sb.SuperBlock(replica_placement=ref_t.ReplicaPlacement.parse(rp),
                             ttl=ref_t.TTL.parse(ttl), compaction_revision=rev)
    assert sb.to_bytes() == want.to_bytes()
    back = super_block.SuperBlock.from_bytes(want.to_bytes())
    assert (str(back.replica_placement), str(back.ttl), back.compaction_revision) \
        == (rp, ttl, rev)
    with pytest.raises(ValueError):
        super_block.SuperBlock.from_bytes(b"\x00" * 8)
    with pytest.raises(ValueError):
        super_block.SuperBlock.from_bytes(b"\x03")


def test_types_equal_reference():
    for s in ("", "1", "5m", "2h", "3d", "4w", "5M", "6y"):
        a, b = t.TTL.parse(s), ref_t.TTL.parse(s)
        assert (a.count, a.unit, a.seconds, str(a), a.to_bytes()) == \
            (b.count, b.unit, b.seconds, str(b), b.to_bytes())
    for code in ("000", "001", "110", "200", 12, None):
        a, b = t.ReplicaPlacement.parse(code), ref_t.ReplicaPlacement.parse(code)
        assert (str(a), a.copy_count, a.to_byte()) == (str(b), b.copy_count, b.to_byte())
    with pytest.raises(ValueError):
        t.ReplicaPlacement.parse("12")
    fid = t.file_id(3, 0x1234ABCD, 0xCAFE)
    assert fid == ref_t.file_id(3, 0x1234ABCD, 0xCAFE)
    assert t.parse_file_id(fid + "_2") == ref_t.parse_file_id(fid + "_2") == (3, 0x1234ABCD, 0xCAFE)
    with pytest.raises(ValueError):
        t.parse_file_id("3")
    assert t.DiskType.parse("SSD") is t.DiskType.SSD and t.DiskType.parse("") is t.DiskType.HDD
    assert (t.offset_to_stored(4096), t.stored_to_offset(512), t.CURRENT_VERSION,
            t.MAX_VOLUME_SIZE) == (512, 4096, ref_t.CURRENT_VERSION, ref_t.MAX_VOLUME_SIZE)


def _write_reference_volume(dirname, n=200, seed=0):
    """A JAX-package volume with overwrites and deletes; returns the live
    {id: data} it should hold."""
    rng = np.random.default_rng(seed)
    os.makedirs(dirname, exist_ok=True)
    v = ref_volume.Volume(str(dirname), "c", 7)
    live = {}
    for i in range(1, n + 1):
        data = rng.integers(0, 256, int(rng.integers(0, 2000)), np.uint8).tobytes()
        v.write_needle(ref_needle.Needle(id=i, cookie=i * 3, data=data, name=b"f%d" % i))
        live[i] = data
    for i in range(1, n + 1, 9):   # overwrites
        data = rng.bytes(100)
        v.write_needle(ref_needle.Needle(id=i, cookie=i * 3, data=data))
        live[i] = data
    for i in range(2, n + 1, 13):  # deletes
        assert v.delete_needle(i, i * 3)
        live.pop(i)
    v.close()
    return live


@pytest.mark.parametrize("kind", ["memory", "leveldb", "sorted_file"])
def test_needle_map_kinds_load_reference_idx(tmp_path, kind):
    _write_reference_volume(tmp_path / "w", n=150)
    for side in ("port", "ref"):
        os.makedirs(tmp_path / side)
        shutil.copy(tmp_path / "w" / "c_7.idx", tmp_path / side / "c_7.idx")
    got = needle_map.NeedleMap(str(tmp_path / "port" / "c_7.idx"), kind)
    want = ref_nm.NeedleMap(str(tmp_path / "ref" / "c_7.idx"), kind)
    try:
        for key in range(0, 160):
            a, b = got.get(key), want.get(key)
            assert (a is None) == (b is None), key
            if a is not None:
                assert (a.key, a.offset, a.size) == (b.key, b.offset, b.size)
        assert (got.file_counter, got.deleted_counter, got.data_size,
                got.deleted_size, got.max_key, got.live_count) == (
            want.file_counter, want.deleted_counter, want.data_size,
            want.deleted_size, want.max_key, want.live_count)
        for a, b in zip(got.map.items_arrays(), want.map.items_arrays()):
            np.testing.assert_array_equal(a, b)
        seen = []
        got.map.ascending_visit(lambda nv: seen.append((nv.key, nv.offset, nv.size)))
        ref_seen = []
        want.map.ascending_visit(lambda nv: ref_seen.append((nv.key, nv.offset, nv.size)))
        assert seen == ref_seen
    finally:
        got.close()
        want.close()


def test_compact_map_merge_and_put_many(tmp_path):
    needle_map.CompactMap.MERGE_THRESHOLD, old = 16, needle_map.CompactMap.MERGE_THRESHOLD
    try:
        nm = needle_map.NeedleMap(str(tmp_path / "a.idx"))
        ref = ref_nm.NeedleMap(str(tmp_path / "b.idx"))
        entries = [(k % 37 + 1, 8 * (k + 1), k + 10) for k in range(100)]
        nm.put_many(entries[:50])
        ref.put_many(entries[:50])
        for k, off, size in entries[50:]:
            nm.put(k, off, size)
            ref.put(k, off, size)
        for k in range(1, 40, 3):
            assert nm.delete(k) == ref.delete(k)
        nm.close()
        ref.close()
        assert (tmp_path / "a.idx").read_bytes() == (tmp_path / "b.idx").read_bytes()
    finally:
        needle_map.CompactMap.MERGE_THRESHOLD = old


def test_walk_idx_and_rebuild_idx_equal_reference(tmp_path):
    _write_reference_volume(tmp_path, n=80, seed=4)
    idx = str(tmp_path / "c_7.idx")
    assert list(needle_map.walk_idx_file(idx)) == list(ref_nm.walk_idx_file(idx))
    dat = str(tmp_path / "c_7.dat")
    assert volume.rebuild_idx_from_dat(dat, str(tmp_path / "port.idx")) == \
        ref_volume.rebuild_idx_from_dat(dat, str(tmp_path / "ref.idx"))
    assert (tmp_path / "port.idx").read_bytes() == (tmp_path / "ref.idx").read_bytes()


def test_reference_volume_read_by_port(tmp_path):
    live = _write_reference_volume(tmp_path, n=200, seed=1)
    v = volume.Volume(str(tmp_path), "c", 7, create_if_missing=False)
    try:
        assert v.file_count == len(live)
        for i in range(1, 201):
            if i in live:
                n = v.read_needle(i, cookie=i * 3)
                assert n.data == live[i]
            else:
                with pytest.raises(KeyError):
                    v.read_needle(i)
        with pytest.raises(PermissionError):
            v.read_needle(1, cookie=999)
        pairs = [(1, 3), (2, 6), (4, 12), (10_000, 0)]
        got = v.read_needles(pairs)
        assert [s for s, _ in got] == [bulk.READ_OK, bulk.READ_NOT_FOUND,
                                       bulk.READ_OK, bulk.READ_NOT_FOUND]
        assert got[0][1].data == live[1]
    finally:
        v.close()


def test_port_volume_read_by_reference(tmp_path, monkeypatch):
    """Written by the port (single and bulk writes, overwrite, delete) and
    by the reference with the same clock: byte-identical .dat and .idx, and
    the reference reads every needle back."""
    monkeypatch.setattr(time, "time_ns", lambda: NOW)
    rng = np.random.default_rng(2)
    datas = [rng.bytes(int(rng.integers(0, 3000))) for _ in range(120)]
    for pkg, nd, vol in (("port", needle, volume), ("ref", ref_needle, ref_volume)):
        os.makedirs(tmp_path / pkg)
        v = vol.Volume(str(tmp_path / pkg), "", 3)
        for i, d in enumerate(datas[:40], 1):
            v.write_needle(nd.Needle(id=i, cookie=1, data=d))
        v.write_needles([nd.Needle(id=i, cookie=1, data=d)
                         for i, d in enumerate(datas[40:], 41)])
        v.write_needle(nd.Needle(id=5, cookie=1, data=b"again"))
        assert v.delete_needle(6, 1) and not v.delete_needle(6, 1)
        v.close()
    for ext in (".dat", ".idx"):
        assert (tmp_path / "port" / f"3{ext}").read_bytes() == \
            (tmp_path / "ref" / f"3{ext}").read_bytes()
    rv = ref_volume.Volume(str(tmp_path / "port"), "", 3)
    try:
        for i, d in enumerate(datas, 1):
            if i == 6:
                with pytest.raises(KeyError):
                    rv.read_needle(i)
            else:
                assert rv.read_needle(i, cookie=1).data == (b"again" if i == 5 else d)
    finally:
        rv.close()


def test_torn_tail_healed_on_reopen(tmp_path):
    v = volume.Volume(str(tmp_path), "", 1)
    v.write_needle(needle.Needle(id=1, cookie=1, data=b"a" * 100))
    with failpoints.inject("volume.write.torn", "torn:10"):
        v.write_needle(needle.Needle(id=2, cookie=1, data=b"b" * 100))
    v.close()
    v = volume.Volume(str(tmp_path), "", 1)
    try:
        assert v.read_needle(1).data == b"a" * 100
        with pytest.raises(KeyError):
            v.read_needle(2)
        v.write_needle(needle.Needle(id=3, cookie=1, data=b"c"))
        assert v.read_needle(3).data == b"c"
    finally:
        v.close()
    assert failpoints.fired("volume.write.torn") >= 1


def test_closed_volume_and_read_only(tmp_path):
    v = volume.Volume(str(tmp_path), "", 1)
    v.write_needle(needle.Needle(id=1, cookie=1, data=b"x"))
    v.sync()
    v.read_only = True
    with pytest.raises(PermissionError):
        v.write_needle(needle.Needle(id=2, cookie=1, data=b"y"))
    v.close()
    with pytest.raises(volume.VolumeClosedError):
        v._read_record(1)
    v.destroy()
    assert not os.path.exists(v.dat_path) and not os.path.exists(v.idx_path)


def test_tiered_volume_not_yet_ported(tmp_path):
    """A tiered volume whose `gcs-json:` tier lacks its object raises at
    open (the port's GCS client against its stand-in on localhost); with its
    .dat kept local it opens read-only without touching the tier."""
    from seaweedfs_tpu_torch.utils.mini_gcs import MiniGcs
    gcs = MiniGcs().start()
    try:
        (tmp_path / "9.vif").write_text(
            '{"remote": {"spec": "gcs-json:%s/b?dev-token", "key": "9.dat"}}'
            % gcs.endpoint)
        with pytest.raises(OSError, match="gcs stat 9.dat: HTTP 404"):
            volume.Volume(str(tmp_path), "", 9)
    finally:
        gcs.stop()
    (tmp_path / "9.dat").write_bytes(super_block.SuperBlock().to_bytes())
    v = volume.Volume(str(tmp_path), "", 9)
    assert v.read_only and v.remote_spec["key"] == "9.dat"
    v.close()


def test_read_cache_invalidation_chokepoint(tmp_path):
    cache = read_cache.ReadCache(1 << 20, max_obj_bytes=1 << 10)
    v = volume.Volume(str(tmp_path), "", 4)
    try:
        v.write_needle(needle.Needle(id=1, cookie=1, data=b"old"))
        ep = cache.epoch(4)
        assert cache.put(4, 1, v.read_needle(1), epoch=ep)
        assert cache.get(4, 1, cookie=1).data == b"old"
        assert cache.get(4, 1, cookie=2) is None
        v.write_needle(needle.Needle(id=1, cookie=1, data=b"new"))  # invalidates
        assert cache.get(4, 1) is None
        assert not cache.put(4, 1, needle.Needle(id=1, cookie=1, data=b"old"), epoch=ep)
        cache.put(4, 1, v.read_needle(1))
        v.delete_needle(1, 1)
        assert cache.get(4, 1) is None
        assert not cache.put(4, 2, needle.Needle(id=2, cookie=1, data=b"z" * 2048))
        cache.put(4, 3, needle.Needle(id=3, cookie=1, data=b"q"))
    finally:
        v.close()  # invalidates the whole volume
    assert len(cache) == 0 and cache.stats()["bytes"] == 0


def test_read_cache_segments_and_capacity():
    cache = read_cache.ReadCache(100, max_obj_bytes=100)
    for k in range(5):
        cache.put(1, k, needle.Needle(id=k, cookie=0, data=b"x" * 30))
    assert cache.bytes_used <= 100 and len(cache) == 3
    assert cache.get(1, 4) is not None  # second touch: protected
    st = cache.stats()
    assert st["protected"] == 1 and st["probation"] == 2
    cache.invalidate_many(1, [2, 3, 4])
    assert len(cache) == 0
    read_cache.invalidate_volume(1)
    cache.clear()
    assert cache.stats()["bytes"] == 0


def test_failpoints_kinds():
    failpoints.clear_all()
    with failpoints.inject("x.site", "error:boom"):
        with pytest.raises(failpoints.FailpointError, match="boom"):
            failpoints.check("x.site")
    failpoints.check("x.site")
    failpoints.configure("x.data", "times:1:corrupt:3")
    out = failpoints.corrupt("x.data", b"\x00" * 64)
    assert out != b"\x00" * 64 and len(out) == 64
    assert failpoints.corrupt("x.data", b"\x00" * 4) == b"\x00" * 4
    failpoints.configure("x.torn", "torn:2")
    assert failpoints.torn("x.torn", b"abcdef") == b"ab"
    assert "x.torn" in failpoints.active()
    failpoints.clear("x.torn")
    with pytest.raises(ValueError):
        failpoints.configure("x.bad", "explode")
    assert failpoints.fired("x.data") == 1
    failpoints.clear_all()


def test_iter_records_stops_at_torn_record(tmp_path):
    v = volume.Volume(str(tmp_path), "", 1)
    offs = [v.write_needle(needle.Needle(id=i, cookie=1, data=b"d" * i)) for i in range(1, 6)]
    v.sync()
    with open(v.dat_path, "rb") as f:
        walked = list(volume.iter_records(f, super_block.SUPER_BLOCK_SIZE, v.content_size))
        assert [p for p, _, _ in walked] == offs
        assert list(volume.iter_records(f, super_block.SUPER_BLOCK_SIZE,
                                        v.content_size - 1))[-1][0] == offs[-2]
    with open(v.dat_path, "rb") as f:
        assert struct.unpack("<IQI", f.read(8 + 16)[8:])[1] == 1
    v.close()
