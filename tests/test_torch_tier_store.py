"""The port's Store across the lifecycle tiers (seaweedfs_tpu_torch/storage/
store.py: offload_ec_shards, promote_ec_shards, move_volume_local, the
remote tier of the DestroyTime reap; ec/volume.RemoteEcVolumeShard; the
.vif's remote claims) against the JAX package's Store(coder_name="numpy")
on the same EC volume, byte for byte: the .vif's remote_shards, the tier's
object keys, the bytes each call returns, needle reads healthy and degraded
from the tier, and the rollbacks."""

import concurrent.futures as cf
import hashlib
import os
import shutil
import sys
import threading

import numpy as np
import pytest

from seaweedfs_tpu.ec import files as ref_files
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage.disk_location import DiskLocation as RefLocation
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu_torch.ec import files
from seaweedfs_tpu_torch.ec import volume as ec_volume
from seaweedfs_tpu_torch.ec.locate import EcGeometry, locate
from seaweedfs_tpu_torch.server.volume_server import make_shard_reader
from seaweedfs_tpu_torch.storage import backend
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle, record_size_from_header
from seaweedfs_tpu_torch.storage.store import TIER_EC, TIER_REMOTE, Store

GEO = EcGeometry(d=10, p=4, large_block=8192, small_block=1024)
REF_GEO = RefGeometry(d=10, p=4, large_block=8192, small_block=1024)
VID, COL = 5, "cool"
LOST = (0, 5)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Pair:
    """A port Store and the JAX package's Store, each holding the same EC
    volume (encoded by each from the same .dat), and a tier directory each."""

    def __init__(self, tmp_path, n=80, seed=1):
        self.tmp = tmp_path
        self.a = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "a"))],
                       ec_geometry=GEO, coder_name="torch", device="cpu")
        rng = np.random.default_rng(seed)
        self.a.add_volume(VID, collection=COL)
        self.want = {}
        needles = []
        for i in range(1, n + 1):
            self.want[i] = (int(rng.integers(0, 1 << 32)),
                            rng.bytes(int(rng.integers(0, 3000))))
            needles.append(Needle(id=i, cookie=self.want[i][0], data=self.want[i][1]))
        for lo in range(0, n, 32):
            self.a.write_needles_bulk(VID, needles[lo:lo + 32])
        self.a.find_volume(VID).sync()
        (tmp_path / "ref").mkdir()
        for ext in (".dat", ".idx"):
            shutil.copy(tmp_path / "a" / f"{COL}_{VID}{ext}",
                        tmp_path / "ref" / f"{COL}_{VID}{ext}")
        self.r = RefStore("127.0.0.1", 0, "", [RefLocation(str(tmp_path / "ref"))],
                          ec_geometry=REF_GEO, coder_name="numpy")
        self.base = self.a.generate_ec_shards(VID, collection=COL)
        self.ref_base = self.r.generate_ec_shards(VID, collection=COL)
        for s in (self.a, self.r):
            s.delete_volume(VID)
            s.mount_ec_shards(VID, COL)
        self.hashes = {s: _sha(self.base + files.shard_ext(s)) for s in range(14)}
        assert self.hashes == {s: _sha(self.ref_base + files.shard_ext(s))
                               for s in range(14)}
        self.vif = open(self.base + ".vif").read()
        self.spec = f"local:{tmp_path / 'tier_a'}"
        self.ref_spec = f"local:{tmp_path / 'tier_ref'}"

    def both(self):
        return ((self.a, self.base, self.spec, backend),
                (self.r, self.ref_base, self.ref_spec, ref_backend))

    def lose(self, sids):
        for store, base, _, _ in self.both():
            for s in sids:
                os.unlink(base + files.shard_ext(s))
            store.unmount_ec_shards(VID, list(sids))

    def keys(self, spec, mod):
        return mod.open_remote(spec).list_keys()

    def reads_equal(self, shard_reader=None):
        for nid, (cookie, data) in self.want.items():
            got = self.a.read_needle(VID, nid, cookie=cookie, shard_reader=shard_reader)
            assert got.data == data
        for nid, (cookie, data) in self.want.items():
            assert self.r.read_needle(VID, nid, cookie=cookie).data == data

    def close(self):
        self.a.close()
        self.r.close()


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def _remote_shards(base):
    rem = files.read_vif(base + ".vif")["remote_shards"]
    return {k: v for k, v in rem.items() if k != "spec"}


def test_offload_reads_promote_round_trip_matches_reference(pair):
    moved = [s.offload_ec_shards(VID, spec, collection=COL)
             for s, _, spec, _ in pair.both()]
    assert moved[0] == moved[1] == 14 * pair.a.find_ec_volume(VID).shard_size
    assert _remote_shards(pair.base) == _remote_shards(pair.ref_base)
    assert files.read_vif(pair.base + ".vif")["remote_shards"]["spec"] == pair.spec
    keys = pair.keys(pair.spec, backend)
    assert keys == pair.keys(pair.ref_spec, ref_backend) == \
        sorted(f"{COL}/{VID}{files.shard_ext(s)}" for s in range(14))
    for d in ("a", "ref"):
        assert not [n for n in os.listdir(pair.tmp / d) if ".ec0" in n or ".ec1" in n]
    ev, rev = pair.a.find_ec_volume(VID), pair.r.find_ec_volume(VID)
    assert ev.remote_shard_ids() == rev.remote_shard_ids() == list(range(14))
    assert all(isinstance(sh, ec_volume.RemoteEcVolumeShard) for sh in ev.shards.values())
    pair.reads_equal()
    assert ev.remote_reads() == rev.remote_reads() > 0
    back = [s.promote_ec_shards(VID, collection=COL) for s, _, _, _ in pair.both()]
    assert back == moved
    assert pair.keys(pair.spec, backend) == pair.keys(pair.ref_spec, ref_backend) == []
    assert {s: _sha(pair.base + files.shard_ext(s)) for s in range(14)} == pair.hashes
    assert open(pair.base + ".vif").read() == open(pair.ref_base + ".vif").read() \
        == pair.vif
    assert pair.a.find_ec_volume(VID).remote_shard_ids() == []
    pair.reads_equal()


def test_offload_is_idempotent_and_refuses_a_second_tier(pair):
    for store, _, spec, _ in pair.both():
        assert store.offload_ec_shards(VID, spec, collection=COL) > 0
        assert store.offload_ec_shards(VID, spec, collection=COL) == 0
        with pytest.raises(ValueError, match="already offloaded"):
            store.offload_ec_shards(VID, spec + "_other", collection=COL)
        with pytest.raises(KeyError):
            store.offload_ec_shards(VID + 1, spec)
        with pytest.raises(KeyError):
            store.promote_ec_shards(VID + 1)
    assert not os.path.exists(str(pair.tmp / "tier_a_other"))
    assert _remote_shards(pair.base) == _remote_shards(pair.ref_base)


def test_offload_rolls_back_on_a_failing_client(pair, monkeypatch):
    for mod in (backend, ref_backend):
        plain = mod.LocalDirRemote.write_object
        calls = []

        def failing(self, key, src, plain=plain, calls=calls):
            calls.append(key)
            if len(calls) == 3:
                raise OSError("tier unreachable")
            return plain(self, key, src)
        monkeypatch.setattr(mod.LocalDirRemote, "write_object", failing)
    for store, base, spec, mod in pair.both():
        with pytest.raises(OSError, match="tier unreachable"):
            store.offload_ec_shards(VID, spec, collection=COL)
        assert pair.keys(spec, mod) == []  # the two uploaded objects went
        assert "remote_shards" not in files.read_vif(base + ".vif")
        assert all(os.path.exists(base + files.shard_ext(s)) for s in range(14))
        assert store.find_ec_volume(VID).remote_shard_ids() == []
    pair.reads_equal()


def test_promote_rolls_back_a_short_download(pair, monkeypatch):
    for store, _, spec, _ in pair.both():
        store.offload_ec_shards(VID, spec, collection=COL)
    for mod in (backend, ref_backend):
        plain = mod.LocalDirRemote.read_object_to
        calls = []

        def short(self, key, dst, plain=plain, calls=calls):
            plain(self, key, dst)
            calls.append(key)
            if len(calls) == 4:
                with open(dst, "ab") as f:
                    f.write(b"!")
        monkeypatch.setattr(mod.LocalDirRemote, "read_object_to", short)
    for store, base, spec, mod in pair.both():
        with pytest.raises(OSError, match="short promote of shard 3"):
            store.promote_ec_shards(VID, collection=COL)
        assert not [n for n in os.listdir(os.path.dirname(base))
                    if ".ec0" in n and not n.endswith(".tiertmp")]
        assert len(pair.keys(spec, mod)) == 14  # the tier keeps every copy
        assert "remote_shards" in files.read_vif(base + ".vif")
    pair.reads_equal()


def _expected_reconstructs(ev):
    n = 0
    for nid in range(1, 81):
        off, size = ev.find_needle(nid)
        n += sum(iv.shard_and_offset(GEO)[0] in LOST for iv in locate(
            GEO, ev.dat_size, off, record_size_from_header(size)))
    return n


def test_degraded_reads_with_survivors_from_the_tier_match_reference(pair):
    pair.lose(LOST)
    for store, _, spec, _ in pair.both():
        assert store.offload_ec_shards(VID, spec, collection=COL) == \
            12 * store.find_ec_volume(VID).shard_size
    ev, rev = pair.a.find_ec_volume(VID), pair.r.find_ec_volume(VID)
    assert ev.remote_shard_ids() == rev.remote_shard_ids() == \
        [s for s in range(14) if s not in LOST]
    stats = {}
    with cf.ThreadPoolExecutor(2) as pool:
        reader = make_shard_reader(pair.a, VID, lambda *a: None, pool, stats)
        for nid, (cookie, data) in pair.want.items():
            assert pair.a.read_needle(VID, nid, cookie=cookie,
                                      shard_reader=reader).data == data
        assert stats["reconstructs"] == _expected_reconstructs(ev) > 0
        # one degraded interval against the JAX coder on the same survivors,
        # read from the reference's tier
        off, ln = 700, 900
        present = tuple(s for s in range(14) if s not in LOST)[:10]
        sl = np.stack([np.frombuffer(rev.shards[s].read_at(off, ln), np.uint8)
                       for s in present])
        want = np.asarray(pair.r.coder().reconstruct(sl, present, (0,)))[0]
        assert reader(0, off, ln) == want.tobytes()


def test_rebuild_from_the_tier_then_promote(pair):
    pair.lose(LOST)
    pair.a.offload_ec_shards(VID, pair.spec, collection=COL)
    held = pair.a.find_ec_volume(VID)
    st = {}
    got = pair.a.rebuild_ec_shards(
        VID, COL, shard_reader=lambda sid, off, ln: held.shards[sid].read_at(off, ln),
        remote_shards=held.remote_shard_ids(), wanted=list(LOST), stats=st)
    assert got == list(LOST)
    assert st["remote_bytes_read"] == st["bytes_read"] == 10 * held.shard_size
    assert {s: _sha(pair.base + files.shard_ext(s)) for s in LOST} == \
        {s: pair.hashes[s] for s in LOST}
    ev = pair.a.find_ec_volume(VID)
    assert sorted(ev.shards) == list(range(14)) and ev.remote_shard_ids() == \
        [s for s in range(14) if s not in LOST]
    assert pair.a.promote_ec_shards(VID, COL) == 12 * ev.shard_size
    assert {s: _sha(pair.base + files.shard_ext(s)) for s in range(14)} == pair.hashes
    assert pair.keys(pair.spec, backend) == []


def test_promote_keep_remote_matches_reference(pair):
    for store, _, spec, _ in pair.both():
        store.offload_ec_shards(VID, spec, collection=COL)
        store.promote_ec_shards(VID, collection=COL, keep_remote=True)
        assert store.promote_ec_shards(VID, collection=COL) == 0  # nothing mapped
    assert pair.keys(pair.spec, backend) == pair.keys(pair.ref_spec, ref_backend)
    assert len(pair.keys(pair.spec, backend)) == 14
    assert open(pair.base + ".vif").read() == pair.vif
    assert pair.a.find_ec_volume(VID).remote_shard_ids() == []
    pair.reads_equal()


def test_promote_cleans_dual_copy_objects_like_reference(pair):
    """A shard present both locally and remotely serves local, and the
    promote deletes its remote object too."""
    for store, base, spec, mod in pair.both():
        store.offload_ec_shards(VID, spec, collection=COL)
        mod.open_remote(spec).read_object_to(f"{COL}/{VID}.ec03",
                                             base + files.shard_ext(3))
        ev = store.mount_ec_shards(VID, COL)
        assert 3 not in ev.remote_shard_ids() and len(ev.remote_shard_ids()) == 13
    assert [s.promote_ec_shards(VID, COL) for s, _, _, _ in pair.both()] == \
        [13 * pair.a.find_ec_volume(VID).shard_size] * 2
    assert pair.keys(pair.spec, backend) == pair.keys(pair.ref_spec, ref_backend) == []


def test_reap_of_an_offloaded_volume_and_restore_match_reference(pair):
    recs = []
    size = pair.a.find_ec_volume(VID).shard_size
    for store, base, spec, mod in pair.both():
        store.offload_ec_shards(VID, spec, collection=COL)
        # one shard back on disk: the reap counts local bytes only
        mod.open_remote(spec).read_object_to(f"{COL}/{VID}.ec07",
                                             base + files.shard_ext(7))
        store.mount_ec_shards(VID, COL)
        (files if mod is backend else ref_files).update_vif(
            base + ".vif", {"destroy_time": 1000.0})
        ev = store.mount_ec_shards(VID, COL)
        assert ev.destroy_time == 1000.0
        assert store.delete_expired_ec_volumes(now=999.5) == []
        recs.append(store.delete_expired_ec_volumes(now=1000.0))
        assert store.find_ec_volume(VID) is None
        assert len(pair.keys(spec, mod)) == 14  # soft delete keeps the tier
    assert recs[0] == recs[1] == [{"vid": VID, "collection": COL,
                                   "from": TIER_REMOTE, "bytes": size}]
    assert TIER_EC == "ec" and TIER_REMOTE == "remote"
    assert sorted(os.listdir(pair.tmp / "a" / ".trash")) == \
        sorted(os.listdir(pair.tmp / "ref" / ".trash"))
    for store, _, _, _ in pair.both():
        ev = store.restore_ec_volume_from_trash(VID, COL)
        assert len(ev.remote_shard_ids()) == 13
    pair.reads_equal()


def test_hard_destroy_deletes_the_remote_objects(pair):
    for store, base, spec, mod in pair.both():
        store.offload_ec_shards(VID, spec, collection=COL)
        store.find_ec_volume(VID).destroy()
        assert pair.keys(spec, mod) == []
        assert not [n for n in os.listdir(os.path.dirname(base))
                    if n.startswith(f"{COL}_{VID}.")]


def test_remount_of_an_offloaded_volume_matches_reference(pair):
    for store, _, spec, _ in pair.both():
        store.offload_ec_shards(VID, spec, collection=COL)
        ev = store.mount_ec_shards(VID, COL)  # rescans the disk and the .vif
        assert ev.remote_shard_ids() == list(range(14))
    bits = [s.collect_heartbeat()["ec_shards"][0]["ec_index_bits"]
            for s, _, _, _ in pair.both()]
    assert bits == [(1 << 14) - 1] * 2
    pair.reads_equal()
    ev = pair.a.find_ec_volume(VID)
    assert ev.close_idle(0) is False  # no fd to close; the block caches stay
    assert all(sh._f._cache for sh in ev.shards.values() if sh.reads)
    again = Store("127.0.0.1", 0, "", [DiskLocation(str(pair.tmp / "a"))],
                  ec_geometry=GEO, device="cpu")
    try:
        ev = again.find_ec_volume(VID)
        assert ev is not None and ev.remote_shard_ids() == list(range(14))
        nid, (cookie, data) = next(iter(pair.want.items()))
        assert again.read_needle(VID, nid, cookie=cookie).data == data
    finally:
        again.close()


def test_remote_claims_merge_and_drop_match_reference(tmp_path):
    paths = []
    for d, fm in (("port", files), ("ref", ref_files)):
        (tmp_path / d).mkdir()
        p = str(tmp_path / d / "1.vif")
        fm.write_vif(p, d=10, p=4, remote_shards={
            "spec": "local:/t", "keys": {"1": "c/1.ec01", "2": "c/1.ec02"},
            "sizes": {"1": 100, "2": 100}})
        info = fm.read_vif(p)
        assert fm.remote_claims(info, [2, 9]) == {
            "spec": "local:/t", "keys": {"2": "c/1.ec02"}, "sizes": {"2": 100}}
        assert fm.remote_claims(info, [9]) is None
        fm.merge_remote_claims(p, {"spec": "local:/t", "keys": {"5": "c/1.ec05"},
                                   "sizes": {"5": 7}})
        fm.merge_remote_claims(p, None)
        with pytest.raises(ValueError, match="conflicts"):
            fm.merge_remote_claims(p, {"spec": "local:/other", "keys": {"6": "x"}})
        assert fm.drop_remote_claims(p, [1, 9]) == [1]
        assert fm.drop_remote_claims(p, [9]) == []
        paths.append(p)
    assert open(paths[0]).read() == open(paths[1]).read()
    assert files.drop_remote_claims(paths[0], [2, 5]) == [2, 5]
    assert "remote_shards" not in files.read_vif(paths[0])
    assert files.drop_remote_claims(paths[0], [2]) == []
    files.merge_remote_claims(paths[0], {"spec": "local:/t", "keys": {"3": "k"}})
    assert files.read_vif(paths[0])["remote_shards"] == {
        "spec": "local:/t", "keys": {"3": "k"}, "sizes": {}}


def test_read_in_flight_across_the_offload_swap(pair, monkeypatch):
    """A read that started on the old EcVolume, whose shard files were
    idle-closed, finishes byte-equal after the offload unlinked them: the
    offload pins the old object's fds open before the unlink, and the old
    object never reopens a path."""
    ev = pair.a.find_ec_volume(VID)
    assert ev.close_idle(0)
    assert all(sh._f.closed for sh in ev.shards.values())
    started, go = threading.Event(), threading.Event()
    plain = ec_volume.EcVolumeShard.read_at

    def gated(self, offset, length):
        if not started.is_set():
            started.set()
            assert go.wait(30)
        return plain(self, offset, length)
    monkeypatch.setattr(ec_volume.EcVolumeShard, "read_at", gated)
    nid, (cookie, data) = next(iter(pair.want.items()))
    with cf.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(pair.a.read_needle, VID, nid, cookie)
        assert started.wait(30)
        pair.a.offload_ec_shards(VID, pair.spec, collection=COL)
        assert not os.path.exists(pair.base + files.shard_ext(0))
        go.set()
        assert fut.result(timeout=30).data == data
    assert pair.a.find_ec_volume(VID) is not ev
    # the old object keeps serving every needle off its pinned fds
    for i, (c, d) in pair.want.items():
        assert ev.read_needle(i, cookie=c).data == d
    ev.close_idle(0)
    assert not any(sh._f.closed for sh in ev.shards.values())
    pair.reads_equal()


def test_vif_writers_never_lose_the_remote_mapping(pair):
    """The idle-close stamp and its clear rewrite the .vif on another thread
    while offloads and promotes seal and drop remote_shards: every write
    goes through update_vif, so none is lost."""
    stop = threading.Event()
    errors = []

    def stamper():
        while not stop.is_set():
            try:
                ev = pair.a.find_ec_volume(VID)
                ev.close_idle(0)    # stamps last_read_wall
                ev.close_idle(1e9)  # "reads resumed": clears the stamp
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=stamper)
    t.start()
    try:
        for _ in range(4):
            pair.a.offload_ec_shards(VID, pair.spec, collection=COL)
            assert len(files.read_vif(pair.base + ".vif")["remote_shards"]["keys"]) == 14
            pair.a.promote_ec_shards(VID, COL)
            assert "remote_shards" not in files.read_vif(pair.base + ".vif")
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not t.is_alive() and not errors, errors[:3]
    assert {s: _sha(pair.base + files.shard_ext(s)) for s in range(14)} == pair.hashes
    pair.reads_equal()


def test_move_volume_local_matches_reference_under_reads(tmp_path):
    stores, layouts = [], []
    for name, S, L, N, kw in (("port", Store, DiskLocation, Needle, dict(device="cpu")),
                              ("ref", RefStore, RefLocation, RefNeedle,
                               dict(coder_name="numpy"))):
        root = tmp_path / name
        s = S("127.0.0.1", 0, "", [L(str(root / "hdd"), disk_type="hdd", max_volume_count=4),
                                   L(str(root / "ssd"), disk_type="ssd", max_volume_count=4)],
              **kw)
        v = s.add_volume(3, disk_type="hdd")
        rng = np.random.default_rng(4)
        payloads = {i: rng.bytes(4000) for i in range(1, 30)}
        for i, data in payloads.items():
            v.write_needle(N(id=i, cookie=9, data=data))
        assert s.move_volume_local(3, "hdd") == str(root / "hdd")  # already there
        assert s.move_volume_local(3, "ssd") == str(root / "ssd")
        layouts.append(sorted(os.listdir(root / "hdd")) + ["|"] +
                       sorted(os.listdir(root / "ssd")))
        stores.append((s, payloads))
    assert layouts[0] == layouts[1] == ["|", "3.dat", "3.idx"]
    s, payloads = stores[0]
    stop = threading.Event()
    errors = []

    def reader(seed):
        i = seed
        while not stop.is_set():
            i = (i % 29) + 1
            try:
                if s.read_needle(3, i, cookie=9).data != payloads[i]:
                    errors.append(f"wrong bytes for {i}")
                    return
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"read {i}: {type(e).__name__}: {e}")
                return

    ts = [threading.Thread(target=reader, args=(k,)) for k in range(3)]
    for t in ts:
        t.start()
    try:
        for _ in range(3):
            s.move_volume_local(3, "hdd")
            s.move_volume_local(3, "ssd")
    finally:
        stop.set()
        for t in ts:
            t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in ts), errors[:3]
    v = s.find_volume(3)
    assert v.dir == str(tmp_path / "port" / "ssd") and not v.read_only
    v.write_needle(Needle(id=99, cookie=1, data=b"after"))  # the freeze thawed
    with pytest.raises(KeyError):
        s.move_volume_local(4, "ssd")
    for st, _ in stores:
        st.close()


def test_move_volume_local_rolls_back_a_failed_copy(tmp_path, monkeypatch):
    s = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "hdd"), disk_type="hdd"),
                                   DiskLocation(str(tmp_path / "ssd"), disk_type="ssd")],
              device="cpu")
    v = s.add_volume(2, disk_type="hdd")
    v.write_needle(Needle(id=1, cookie=1, data=b"stay"))
    plain = shutil.copyfile

    def failing(src, dst, *a, **k):
        if src.endswith(".idx"):
            raise OSError("disk full")
        return plain(src, dst, *a, **k)
    monkeypatch.setattr(shutil, "copyfile", failing)
    with pytest.raises(OSError, match="disk full"):
        s.move_volume_local(2, "ssd")
    assert os.listdir(tmp_path / "ssd") == []
    assert s.find_volume(2) is v and not v.read_only
    assert s.read_needle(2, 1).data == b"stay"
    s.close()


def test_tier_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """chip_smoke.py's phase 10 (vacuum, move, the tier round trip of the
    .dat, EC at RS(14,2) offloaded, served, rebuilt and promoted from the
    tier, decode), every check of it, at a small size on the plain
    versions."""
    import chip_smoke
    geo = EcGeometry(d=14, p=2, large_block=1 << 16, small_block=4096)
    res = chip_smoke.tier_round_trip(np, str(tmp_path), 17, "cpu", geo,
                                     needles=3000, sample=300, device="cpu")
    assert res["k3_tiered"] == 0 and res["degraded_reads"] > 0
    assert res["lengths"] and all(0 < ln <= 1200 for ln in res["lengths"])
    assert not os.listdir(tmp_path / "tier" / "default")
