"""The port's Store over DiskLocations (seaweedfs_tpu_torch/storage/store.py)
and its EC read path (server/volume_server.make_shard_reader) against the
JAX package's Store(coder_name="numpy") on the same volume: encode, mount,
healthy and degraded needle reads, rebuild with survivors on another
server, decode back to a volume, the TTL reap and restore, the heartbeat,
and coder selection without a fallback."""

import concurrent.futures as cf
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.storage.disk_location import DiskLocation as RefLocation
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu_torch.ec import files
from seaweedfs_tpu_torch.ec.locate import EcGeometry, locate
from seaweedfs_tpu_torch.ops import coder as coder_mod
from seaweedfs_tpu_torch.server.volume_server import make_shard_reader
from seaweedfs_tpu_torch.storage import bulk
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle, record_size_from_header
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.super_block import SuperBlock

GEO = EcGeometry(d=10, p=4, large_block=8192, small_block=1024)
REF_GEO = RefGeometry(d=10, p=4, large_block=8192, small_block=1024)
VID = 3
A_SHARDS, B_SHARDS = range(0, 7), range(7, 14)
A_LOST, B_LOST = (0, 5), (10, 13)


def _store(dirname):
    return Store("127.0.0.1", 0, "", [DiskLocation(str(dirname))],
                 ec_geometry=GEO, coder_name="torch", device="cpu")


def _ref_store(dirname):
    return RefStore("127.0.0.1", 0, "", [RefLocation(str(dirname))],
                    ec_geometry=REF_GEO, coder_name="numpy")


def _write(store, n=80, seed=1):
    """n needles of 0..3000 B through write_needles_bulk; {id: (cookie, data)}."""
    rng = np.random.default_rng(seed)
    store.add_volume(VID)
    want = {}
    needles = []
    for i in range(1, n + 1):
        want[i] = (int(rng.integers(0, 1 << 32)), rng.bytes(int(rng.integers(0, 3000))))
        needles.append(Needle(id=i, cookie=want[i][0], data=want[i][1]))
    for lo in range(0, n, 32):
        store.write_needles_bulk(VID, needles[lo:lo + 32])
    return want


@pytest.fixture
def pair(tmp_path):
    """Port store A with the volume, and the JAX package's store on a copy
    of the same .dat/.idx."""
    a = _store(tmp_path / "a")
    want = _write(a)
    a.find_volume(VID).sync()
    (tmp_path / "ref").mkdir()
    for ext in (".dat", ".idx"):
        shutil.copy(tmp_path / "a" / f"{VID}{ext}", tmp_path / "ref" / f"{VID}{ext}")
    ref = _ref_store(tmp_path / "ref")
    yield a, ref, want
    a.close()
    ref.close()


def _encode_both(a, ref, tmp_path):
    base = a.generate_ec_shards(VID)
    ref_base = ref.generate_ec_shards(VID)
    for ext in [files.shard_ext(s) for s in range(14)] + [".ecx", ".vif"]:
        assert open(base + ext, "rb").read() == open(ref_base + ext, "rb").read(), ext
    for s in (a, ref):
        s.delete_volume(VID)
        s.mount_ec_shards(VID)
    return base, ref_base


def _spread(a, base, tmp_path):
    """Move shards 7-13 (with copies of the .ecx and .vif) to a second port
    store B, remount both; returns B."""
    (tmp_path / "b").mkdir()
    b_base = str(tmp_path / "b" / str(VID))
    for s in B_SHARDS:
        os.replace(base + files.shard_ext(s), b_base + files.shard_ext(s))
    for ext in (".ecx", ".vif"):
        shutil.copy(base + ext, b_base + ext)
    b = _store(tmp_path / "b")
    a.mount_ec_shards(VID)
    assert b.find_ec_volume(VID) is not None  # loaded by the scan
    return b


def _fetch_from(store):
    def fetch(sid, off, ln):
        ev = store.find_ec_volume(VID)
        sh = ev.shards.get(sid) if ev else None
        return None if sh is None else sh.read_at(off, ln)
    return fetch


def _lose(store, base, sids):
    for s in sids:
        os.unlink(base + files.shard_ext(s))
    store.mount_ec_shards(VID)


def _shards_of(ev, nid):
    off, size = ev.find_needle(nid)
    return [iv.shard_and_offset(GEO)[0] for iv in locate(
        GEO, ev.dat_size, off, record_size_from_header(size))]


def test_encode_mount_and_healthy_reads_match_reference(pair, tmp_path):
    a, ref, want = pair
    _encode_both(a, ref, tmp_path)
    for nid, (cookie, data) in want.items():
        got = a.read_needle(VID, nid, cookie=cookie)
        assert got.data == data == ref.read_needle(VID, nid, cookie=cookie).data
    pairs = [(nid, c) for nid, (c, _) in want.items()][:30] + [(999, 0), (4, 1)]
    pairs[5] = (pairs[5][0], pairs[5][1] ^ 1)  # wrong cookie
    statuses = {}
    for budget in (None, 20_000):
        got = a.read_needles_bulk(VID, pairs, byte_budget=budget)
        exp = ref.read_needles_bulk(VID, pairs, byte_budget=budget)
        statuses[budget] = [s for s, _ in got]
        assert statuses[budget] == [s for s, _ in exp]
        assert [n.data if n else None for _, n in got] == \
            [n.data if n else None for _, n in exp]
    assert statuses[None][5] == bulk.READ_ERROR
    assert statuses[None][-2] == bulk.READ_NOT_FOUND
    assert bulk.READ_OVERFLOW in statuses[20_000]
    assert a.access_snapshot()[VID]["reads"] == ref.access_snapshot()[VID]["reads"]


def test_degraded_reads_over_two_stores_match_reference(pair, tmp_path):
    a, ref, want = pair
    base, ref_base = _encode_both(a, ref, tmp_path)
    originals = {s: open(ref_base + files.shard_ext(s), "rb").read()
                 for s in range(14)}
    b = _spread(a, base, tmp_path)
    _lose(a, base, A_LOST)
    _lose(b, str(tmp_path / "b" / str(VID)), B_LOST)
    stats = {}
    pool = cf.ThreadPoolExecutor(4)
    try:
        reader = make_shard_reader(a, VID, _fetch_from(b), pool, stats=stats)
        ev = a.find_ec_volume(VID)
        expected = sum(s in A_LOST + B_LOST
                       for nid in want for s in _shards_of(ev, nid))
        assert expected > 0
        for nid, (cookie, data) in want.items():
            assert a.read_needle(VID, nid, cookie=cookie,
                                 shard_reader=reader).data == data
        assert stats["reconstructs"] == expected
        assert stats["gather_s"] > 0 and stats["decode_s"] > 0
        # the degraded interval against the JAX package's coder on the
        # same survivors (the reference server's gather: local first, then
        # remote, the first d in id order)
        off, ln = 1000, 1500
        got = reader(0, off, ln)
        present = (1, 2, 3, 4, 6, 7, 8, 9, 11, 12)
        sl = np.stack([np.frombuffer(originals[s][off:off + ln], np.uint8)
                       for s in present])
        want_iv = np.asarray(ref.coder().reconstruct(sl, present, (0,)))[0]
        assert got == want_iv.tobytes() == originals[0][off:off + ln]
        pairs = [(nid, c) for nid, (c, _) in want.items()]
        got = a.read_needles_bulk(VID, pairs, shard_reader=reader)
        exp = ref.read_needles_bulk(VID, pairs)
        assert [(s, n.data) for s, n in got] == [(s, n.data) for s, n in exp]
    finally:
        pool.shutdown()
        b.close()


def test_fewer_than_d_reachable_raises_oserror(pair, tmp_path):
    a, ref, want = pair
    base, _ = _encode_both(a, ref, tmp_path)
    b = _spread(a, base, tmp_path)
    _lose(a, base, A_LOST)
    _lose(b, str(tmp_path / "b" / str(VID)), B_LOST + (7,))
    with cf.ThreadPoolExecutor(2) as pool:
        reader = make_shard_reader(a, VID, _fetch_from(b), pool)
        with pytest.raises(OSError, match="only 9 shards reachable"):
            reader(0, 0, 100)
        hit = next(nid for nid in want
                   if 0 in _shards_of(a.find_ec_volume(VID), nid))
        with pytest.raises(OSError):
            a.read_needle(VID, hit, shard_reader=reader)
        assert a.read_needles_bulk(VID, [(hit, want[hit][0])],
                                   shard_reader=reader)[0][0] == bulk.READ_ERROR
    b.close()


def test_degraded_read_refuses_layered_codec(pair, tmp_path):
    """A layered codec sealed in the .vif is served (piggyback here, msr in
    test_torch_codec_store.py); a name that is no erasure codec (a compute
    backend such as mesh, or nothing at all) is refused."""
    a, ref, want = pair
    base = a.generate_ec_shards(VID, codec="piggyback")
    ref_base = ref.generate_ec_shards(VID, codec="piggyback")
    shards = {s: open(ref_base + files.shard_ext(s), "rb").read() for s in range(14)}
    assert all(open(base + files.shard_ext(s), "rb").read() == shards[s]
               for s in range(14))
    for s in (a, ref):
        s.delete_volume(VID)
        s.mount_ec_shards(VID)
    _lose(a, base, (0, 1))
    half = len(shards[0]) // 2
    with cf.ThreadPoolExecutor(2) as pool:
        stats = {}
        reader = make_shard_reader(a, VID, lambda sid, off, ln: None, pool, stats)
        assert reader(0, 0, 10) == shards[0][:10]
        assert reader(1, half + 3, 40) == shards[1][half + 3:half + 43]
        assert stats["reconstructs"] == 2 and stats["strips"] == 1
        for nid, (cookie, data) in want.items():
            assert a.read_needle(VID, nid, cookie=cookie,
                                 shard_reader=reader).data == data
        for codec, err in (("mesh", ValueError), ("bogus", ValueError)):
            files.update_vif(base + ".vif", {"codec": codec})
            a.mount_ec_shards(VID)
            with pytest.raises(err, match=codec):
                reader(0, 0, 10)


def test_rebuild_with_remote_survivors_and_decode_match_reference(pair, tmp_path):
    a, ref, want = pair
    dat = open(tmp_path / "a" / f"{VID}.dat", "rb").read()
    base, ref_base = _encode_both(a, ref, tmp_path)
    originals = {s: open(ref_base + files.shard_ext(s), "rb").read()
                 for s in range(14)}
    b = _spread(a, base, tmp_path)
    b_base = str(tmp_path / "b" / str(VID))
    _lose(a, base, A_LOST)
    _lose(b, b_base, B_LOST)
    # the JAX package's store, same layout: its shards 7-13 "elsewhere"
    far = tmp_path / "ref_far"
    far.mkdir()
    for s in B_SHARDS:
        os.replace(ref_base + files.shard_ext(s), str(far / files.shard_ext(s)))
    for s in A_LOST:
        os.unlink(ref_base + files.shard_ext(s))
    ref.mount_ec_shards(VID)

    def read_far(sid, off, ln):
        with open(far / files.shard_ext(sid), "rb") as f:
            f.seek(off)
            return f.read(ln)
    remote = [s for s in B_SHARDS if s not in B_LOST]
    got_stats, want_stats = {}, {}
    # no `wanted`: both rebuild every shard held nowhere, (0, 5, 10, 13)
    assert a.rebuild_ec_shards(
        VID, shard_reader=lambda sid, off, ln: _fetch_from(b)(sid, off, ln),
        remote_shards=remote, stats=got_stats) == sorted(A_LOST + B_LOST)
    assert ref.rebuild_ec_shards(VID, shard_reader=read_far,
                                 remote_shards=remote,
                                 stats=want_stats) == sorted(A_LOST + B_LOST)
    for s in A_LOST + B_LOST:
        assert open(base + files.shard_ext(s), "rb").read() == originals[s] == \
            open(ref_base + files.shard_ext(s), "rb").read()
    for k in ("bytes_read", "bytes_written", "codec", "path", "shard_size"):
        assert got_stats[k] == want_stats[k], k
    assert got_stats["bytes_read"] == GEO.d * len(originals[0])
    assert got_stats["remote"] == len(remote)
    assert a.find_ec_volume(VID).shard_bits().ids() == [0, 1, 2, 3, 4, 5, 6, 10, 13]
    # B rebuilds just its own (10, 13) with A's shards as remote survivors
    os.unlink(base + files.shard_ext(10))
    os.unlink(base + files.shard_ext(13))
    a.mount_ec_shards(VID)
    b_stats = {}
    assert b.rebuild_ec_shards(VID, shard_reader=_fetch_from(a),
                               remote_shards=list(A_SHARDS), wanted=list(B_LOST),
                               stats=b_stats) == list(B_LOST)
    assert b_stats["bytes_read"] == GEO.d * len(originals[0])
    assert b_stats["remote_bytes_read"] == 7 * len(originals[0])
    for s in B_LOST:
        assert open(b_base + files.shard_ext(s), "rb").read() == originals[s]
    # decode: B's data shards 7-9 copied over, then both packages decode
    for s in (7, 8, 9):
        shutil.copy(b_base + files.shard_ext(s), base + files.shard_ext(s))
        shutil.copy(far / files.shard_ext(s), ref_base + files.shard_ext(s))
    a.find_ec_volume(VID).delete_needle(11)
    ref.find_ec_volume(VID).delete_needle(11)
    v = a.ec_shards_to_volume(VID)
    ref_v = ref.ec_shards_to_volume(VID)
    assert open(v.dat_path, "rb").read() == open(ref_v.dat_path, "rb").read()
    assert open(v.dat_path, "rb").read() == dat
    assert open(v.idx_path, "rb").read() == open(ref_v.idx_path, "rb").read()
    assert a.find_ec_volume(VID) is None and a.find_volume(VID) is v
    for nid, (cookie, data) in want.items():
        if nid == 11:
            with pytest.raises(KeyError):
                a.read_needle(VID, nid)
        else:
            assert a.read_needle(VID, nid, cookie=cookie).data == data
    b.close()


def test_expired_ec_volumes_reap_and_restore_match_reference(pair, tmp_path):
    a, ref, want = pair
    base, ref_base = _encode_both(a, ref, tmp_path)
    for s, b in ((a, base), (ref, ref_base)):
        files.update_vif(b + ".vif", {"destroy_time": 1000.0})
        s.mount_ec_shards(VID)
    assert a.delete_expired_ec_volumes(now=999.0) == \
        ref.delete_expired_ec_volumes(now=999.0) == []
    got = a.delete_expired_ec_volumes(now=1000.0)
    exp = ref.delete_expired_ec_volumes(now=1000.0)
    assert got == exp and got[0]["from"] == "ec" and got[0]["bytes"] > 0
    assert a.find_ec_volume(VID) is None and VID not in a.access_snapshot()
    assert sorted(os.listdir(tmp_path / "a" / ".trash")) == \
        sorted(os.listdir(tmp_path / "ref" / ".trash"))
    ev = a.restore_ec_volume_from_trash(VID)
    ref.restore_ec_volume_from_trash(VID)
    assert ev is a.find_ec_volume(VID) and ev.shard_bits().count() == 14
    assert a.read_needle(VID, 7).data == want[7][1]
    with pytest.raises(KeyError, match="not in trash"):
        a.restore_ec_volume_from_trash(VID + 1)


def test_heartbeat_matches_reference(pair, tmp_path):
    a, ref, _ = pair
    a.add_volume(VID + 1, replication="010", ttl="3d")
    ref.add_volume(VID + 1, replication="010", ttl="3d")
    a.delete_needle(VID, 4)
    ref.delete_needle(VID, 4)
    base, ref_base = a.generate_ec_shards(VID), ref.generate_ec_shards(VID)
    a.mount_ec_shards(VID)
    ref.mount_ec_shards(VID)
    a.unmount_ec_shards(VID, [2, 9])
    ref.unmount_ec_shards(VID, [2, 9])
    # both stores reopened on the same files: the same load-time state
    a.close()
    ref.close()
    for ext in (".dat", ".idx"):
        shutil.copy(base + ext, ref_base + ext)
    a2, ref2 = _store(tmp_path / "a"), _ref_store(tmp_path / "ref")
    for s in (a2, ref2):
        s.unmount_ec_shards(VID, [2, 9])
    got, exp = a2.collect_heartbeat(), ref2.collect_heartbeat()
    assert got.keys() == exp.keys()
    for key in got:
        assert got[key] == exp[key], key
    assert got["ec_shards"][0]["ec_index_bits"] == ((1 << 14) - 1) & ~(1 << 2 | 1 << 9)
    assert a2.status()["ec_volumes"] == 1 and a2.status()["volumes"] == 2
    a2.close()
    ref2.close()


def test_batch_encode_matches_reference(pair, tmp_path):
    a, ref, want = pair
    a.add_volume(VID + 1)
    a.write_needles_bulk(VID + 1, [Needle(id=i, cookie=c, data=d)
                                   for i, (c, d) in reversed(want.items())])
    a.find_volume(VID + 1).sync()
    for ext in (".dat", ".idx"):  # the same bytes, timestamps included
        shutil.copy(tmp_path / "a" / f"{VID + 1}{ext}",
                    tmp_path / "ref" / f"{VID + 1}{ext}")
    ref.mount_volume(VID + 1)
    assert a.generate_ec_shards_batch([VID, 99, VID + 1]) == \
        ref.generate_ec_shards_batch([VID, 99, VID + 1]) == [VID, VID + 1]
    for vid in (VID, VID + 1):
        for ext in [files.shard_ext(s) for s in range(14)] + [".ecx", ".vif"]:
            got = open(tmp_path / "a" / f"{vid}{ext}", "rb").read()
            assert got == open(tmp_path / "ref" / f"{vid}{ext}", "rb").read(), ext
    for s in (a, ref):
        s.delete_volume(VID + 1)
        s.mount_ec_shards(VID + 1)
    for nid, (cookie, data) in want.items():
        assert a.read_needle(VID + 1, nid, cookie=cookie).data == data == \
            ref.read_needle(VID + 1, nid, cookie=cookie).data


def test_close_idle_ec_handles_matches_reference(pair, tmp_path):
    a, ref, want = pair
    _encode_both(a, ref, tmp_path)
    a.read_needle(VID, 1)
    ref.read_needle(VID, 1)
    assert a.close_idle_ec_handles(idle_s=3600) == \
        ref.close_idle_ec_handles(idle_s=3600) == 0
    assert a.close_idle_ec_handles(idle_s=0) == \
        ref.close_idle_ec_handles(idle_s=0) == 1
    ev = a.find_ec_volume(VID)
    assert all(sh._f.closed for sh in ev.shards.values())
    assert "last_read_wall" in files.read_vif(ev.base + ".vif")
    assert a.close_idle_ec_handles(idle_s=0) == \
        ref.close_idle_ec_handles(idle_s=0) == 0  # already closed
    assert a.read_needle(VID, 2).data == want[2][1]  # reopens lazily


def test_ec_store_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """chip_smoke.py's phase 9 (two Stores, healthy and degraded reads,
    rebuild with remote survivors, decode), every check of it, at a small
    size on the plain version."""
    import chip_smoke
    geo = EcGeometry(d=10, p=4, large_block=1 << 16, small_block=4096)
    res = chip_smoke.ec_store_round_trip(np, str(tmp_path), 13, "cpu", geo,
                                         needles=3000, sample=300,
                                         device="cpu")
    # one degraded interval each: a piece of a record of at most ~1.1 KB
    assert res["lengths"] and all(0 < ln <= 1200 for ln in res["lengths"])


def test_volume_lifecycle(pair, tmp_path):
    a, _, want = pair
    with pytest.raises(FileExistsError):
        a.add_volume(VID)
    a.mark_readonly(VID)
    with pytest.raises(PermissionError):
        a.write_needle(VID, Needle(id=500, cookie=1, data=b"x"))
    a.mark_readonly(VID, False)
    a.write_needle(VID, Needle(id=500, cookie=1, data=b"x"))
    assert a.unmount_volume(VID) and a.find_volume(VID) is None
    with pytest.raises(KeyError):
        a.read_needle(VID, 1)
    v = a.mount_volume(VID)
    assert a.mount_volume(VID) is v and a.read_needle(VID, 500).data == b"x"
    assert a.reload_volume(VID).read_needle(1).data == want[1][1]
    with pytest.raises(OSError, match="not empty"):
        a.delete_volume(VID, only_empty=True)
    a.delete_volume(VID)
    with pytest.raises(KeyError):
        a.delete_volume(VID)
    assert not os.path.exists(tmp_path / "a" / f"{VID}.dat")


def test_disk_location_skips_tiered_volumes(tmp_path, caplog):
    """A tiered volume the port can open is loaded; one on a remote kind
    that no client serves is logged and skipped, and the scan goes on."""
    d = tmp_path / "loc"
    d.mkdir()
    (tmp_path / "tier").mkdir()
    (tmp_path / "tier" / "8.dat").write_bytes(SuperBlock().to_bytes())
    (d / "8.idx").write_bytes(b"")
    files.write_vif(str(d / "8.vif"), remote={
        "spec": f"local:{tmp_path / 'tier'}", "key": "8.dat"})
    files.write_vif(str(d / "9.vif"), remote={
        "spec": "ftp:whatever", "key": "9.dat"})
    loc = DiskLocation(str(d))
    loc.load_existing()
    assert sorted(loc.volumes) == [8] and loc.ec_volumes == {}
    assert loc.volumes[8].remote_spec["key"] == "8.dat" and loc.volumes[8].read_only
    assert "load tiered volume 9.vif" in caplog.text
    assert "unknown remote backend" in caplog.text
    loc.volumes[8].close()


def test_coder_selection_has_no_fallback(tmp_path, monkeypatch):
    s = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "n"))],
              coder_name="numpy")
    assert isinstance(s.coder(), coder_mod.NumpyCoder)
    t = _store(tmp_path / "t")
    assert isinstance(t.coder(), coder_mod.TorchCoder) and t.coder().device.type == "cpu"
    for name in ("auto", "jax", "bogus"):
        with pytest.raises(ValueError, match="unknown coder"):
            Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / name))],
                  coder_name=name, device="cpu")
    for codec in ("piggyback", "msr"):
        layered = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / codec))],
                        ec_codec=codec, device="cpu").coder()
        assert layered.codec == codec and layered.inner.device.type == "cpu"
        assert t.coder(codec=codec).inner.device.type == "cpu"
    for codec in ("native", "mesh"):  # compute backends, not codecs
        with pytest.raises(ValueError, match="unknown erasure codec"):
            Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / codec))],
                  ec_codec=codec, device="cpu")
        with pytest.raises(ValueError, match="unknown erasure codec"):
            t.coder(codec=codec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "d"))])
