"""The port's EC volume (seaweedfs_tpu_torch/ec/volume.py) against the JAX
package's: shard bits, needle reads through the stripe map (local shards and
a shard_reader), deletes and their journal, the idle close and its .vif
stamp, destroy, and volumes encoded by either package read by the other."""

import json
import os
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import files as ref_files
from seaweedfs_tpu.ec import volume as ref_volume
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.ops.coder import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu_torch.ec import encoder, files
from seaweedfs_tpu_torch.ec import volume as ec_volume
from seaweedfs_tpu_torch.ec.locate import EcGeometry, locate
from seaweedfs_tpu_torch.ops.coder import NumpyCoder
from seaweedfs_tpu_torch.storage.needle import Needle, record_size_from_header
from seaweedfs_tpu_torch.storage.volume import Volume

GEO = EcGeometry(d=10, p=4, large_block=8192, small_block=1024)
REF_GEO = RefGeometry(d=10, p=4, large_block=8192, small_block=1024)


def _needle_volume(dirname, vid=7, n=60, seed=1):
    """A port Volume of n needles of 0..3000 B; returns {id: (cookie, data)}."""
    rng = np.random.default_rng(seed)
    v = Volume(str(dirname), "", vid)
    want = {}
    for i in range(1, n + 1):
        data = rng.bytes(int(rng.integers(0, 3000)))
        cookie = int(rng.integers(0, 1 << 32))
        v.write_needle(Needle(id=i, cookie=cookie, data=data))
        want[i] = (cookie, data)
    v.close()
    return os.path.join(str(dirname), str(vid)), want


def _encoded(tmp_path, package="port", seed=1):
    """The needle volume encoded by one package; returns (base, want)."""
    d = tmp_path / package
    d.mkdir()
    base, want = _needle_volume(d, seed=seed)
    if package == "port":
        encoder.encode_volume(base + ".dat", base, GEO, NumpyCoder(10, 4),
                              idx_path=base + ".idx")
    else:
        ref_encoder.encode_volume(base + ".dat", base, REF_GEO,
                                  RefNumpyCoder(10, 4), idx_path=base + ".idx")
    return base, want


def test_shard_bits_match_reference():
    rng = np.random.default_rng(2)
    for _ in range(20):
        ids = sorted({int(i) for i in rng.integers(0, 32, 8)})
        drop = ids[::3]
        a = ec_volume.ShardBits().add(*ids).remove(*drop)
        b = ref_volume.ShardBits().add(*ids).remove(*drop)
        assert (a.bits, a.ids(), a.count(), repr(a)) == \
            (b.bits, b.ids(), b.count(), repr(b))
        assert [a.has(i) for i in range(32)] == [b.has(i) for i in range(32)]


def test_needle_reads_match_reference(tmp_path):
    base, want = _encoded(tmp_path)
    ev = ec_volume.EcVolume(base, 7)
    ref = ref_volume.EcVolume(base, 7)
    assert (ev.geo.d, ev.geo.p, ev.dat_size, ev.codec, ev.shard_size) == \
        (ref.geo.d, ref.geo.p, ref.dat_size, ref.codec, ref.shard_size)
    assert ev.shard_bits().bits == ref.shard_bits().bits == (1 << 14) - 1
    for nid, (cookie, data) in want.items():
        assert ev.find_needle(nid) == ref.find_needle(nid)
        n = ev.read_needle(nid, cookie=cookie)
        assert n.data == data == ref.read_needle(nid, cookie=cookie).data
    with pytest.raises(KeyError):
        ev.read_needle(10_000)
    with pytest.raises(PermissionError):
        ev.read_needle(3, cookie=want[3][0] ^ 1)
    assert ev.reads == len(want) + 2
    ev.close()
    ref.close()


def test_reads_through_shard_reader(tmp_path):
    """Shards off this disk come through the shard_reader; without one, a
    read that needs them raises KeyError, as in the reference."""
    base, want = _encoded(tmp_path)
    shards = {s: open(base + files.shard_ext(s), "rb").read() for s in range(14)}
    for s in (0, 3, 9):
        os.unlink(base + files.shard_ext(s))
    ev = ec_volume.EcVolume(base, 7)
    ref = ref_volume.EcVolume(base, 7)
    asked = []

    def reader(sid, off, ln):
        asked.append(sid)
        return shards[sid][off:off + ln]
    for nid, (cookie, data) in want.items():
        assert ev.read_needle(nid, shard_reader=reader).data == data == \
            ref.read_needle(nid, shard_reader=reader).data
    assert set(asked) == {0, 3, 9}
    def shards_of(nid):
        off, size = ev.find_needle(nid)
        return {iv.shard_and_offset(GEO)[0] for iv in locate(
            GEO, ev.dat_size, off, record_size_from_header(size))}
    hits = [nid for nid in want if shards_of(nid) & {0, 3, 9}]
    assert hits
    with pytest.raises(KeyError, match="not local"):
        ev.read_needle(hits[0])
    with pytest.raises(KeyError):
        ref.read_needle(hits[0])


def test_delete_and_journal_match_reference(tmp_path):
    base, want = _encoded(tmp_path)
    ref_base = str(tmp_path / "ref_copy")
    for ext in [files.shard_ext(s) for s in range(14)] + [".ecx", ".vif"]:
        shutil.copy(base + ext, ref_base + ext)
    ev = ec_volume.EcVolume(base, 7)
    ref = ref_volume.EcVolume(ref_base, 7)
    for nid in (5, 17, 5, 999):
        assert ev.delete_needle(nid) == ref.delete_needle(nid)
    with pytest.raises(KeyError):
        ev.read_needle(5)
    assert ev.read_needle(6).data == want[6][1]
    for ext in (".ecx", ".ecj"):
        assert open(base + ext, "rb").read() == open(ref_base + ext, "rb").read()
    assert files.read_ecj(base + ".ecj") == ref_files.read_ecj(ref_base + ".ecj") == [5, 17]


class _Clock:
    def __init__(self):
        self.mono, self.wall = 500.0, 1_700_000_000.0

    def advance(self, s):
        self.mono += s
        self.wall += s


def test_close_idle_stamp_and_lazy_reopen_match_reference(tmp_path, monkeypatch):
    base, want = _encoded(tmp_path)
    ref_base = str(tmp_path / "ref_copy")
    for ext in [files.shard_ext(s) for s in range(14)] + [".ecx", ".vif"]:
        shutil.copy(base + ext, ref_base + ext)
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", lambda: clock.mono)
    monkeypatch.setattr(time, "time", lambda: clock.wall)
    ev = ec_volume.EcVolume(base, 7)
    ref = ref_volume.EcVolume(ref_base, 7)
    ev.read_needle(1)
    ref.read_needle(1)
    assert ev.close_idle(60) is ref.close_idle(60) is False
    clock.advance(100)
    assert ev.read_age_s() == ref.read_age_s() == 100
    assert ev.close_idle(60) is ref.close_idle(60) is True
    vif, ref_vif = files.read_vif(base + ".vif"), ref_files.read_vif(ref_base + ".vif")
    assert vif == ref_vif and vif["last_read_wall"] == clock.wall - 100
    assert all(s._f.closed for s in ev.shards.values())
    assert ev.close_idle(60) is ref.close_idle(60) is False  # already closed
    # a read reopens lazily and clears the stamp at the next idle check
    assert ev.read_needle(2).data == want[2][1]
    ref.read_needle(2)
    assert ev.close_idle(60) is ref.close_idle(60) is False
    assert files.read_vif(base + ".vif") == ref_files.read_vif(ref_base + ".vif")
    assert "last_read_wall" not in files.read_vif(base + ".vif")
    # a restart keeps the read age through the persisted stamp
    clock.advance(100)
    ev.close_idle(60)
    ref.close_idle(60)
    clock.advance(1000)
    again = ec_volume.EcVolume(base, 7)
    ref_again = ref_volume.EcVolume(ref_base, 7)
    assert again.read_age_s() == ref_again.read_age_s() == 1100
    for v in (ev, ref, again, ref_again):
        v.close()


def test_update_vif_merges_and_removes(tmp_path):
    path = str(tmp_path / "x.vif")
    files.write_vif(path, d=10, p=4, codec="rs")
    assert files.update_vif(path, {"last_read_wall": 5.0}) == \
        {"d": 10, "p": 4, "codec": "rs", "last_read_wall": 5.0}
    assert files.update_vif(path, remove=("last_read_wall", "absent")) == \
        {"d": 10, "p": 4, "codec": "rs"}
    assert files._vif_lock(path) is files._vif_lock(
        os.path.join(str(tmp_path), ".", "x.vif"))
    assert json.load(open(path)) == {"d": 10, "p": 4, "codec": "rs"}


@pytest.mark.parametrize("trash", [True, False])
def test_destroy_matches_reference(tmp_path, trash):
    base, _ = _encoded(tmp_path)
    ref_base = str(tmp_path / "ref" / "7")
    os.makedirs(os.path.dirname(ref_base))
    for ext in [files.shard_ext(s) for s in range(14)] + [".ecx", ".vif"]:
        shutil.copy(base + ext, ref_base + ext)
    ev = ec_volume.EcVolume(base, 7)
    ev.delete_needle(3)
    ref = ref_volume.EcVolume(ref_base, 7)
    ref.delete_needle(3)
    t_port = str(tmp_path / "port" / ".trash") if trash else None
    t_ref = str(tmp_path / "ref" / ".trash") if trash else None
    ev.destroy(to_trash=t_port)
    ref.destroy(to_trash=t_ref)
    for b in (base, ref_base):
        assert not any(os.path.exists(b + ext) for ext in
                       [files.shard_ext(s) for s in range(14)]
                       + [".ecx", ".ecj", ".vif"])
    if trash:
        assert sorted(os.listdir(t_port)) == sorted(os.listdir(t_ref))
        assert len(os.listdir(t_port)) == 14 + 3


def test_remote_tier_vif_raises(tmp_path):
    """Offloaded shards open on the remote kind their .vif names (an
    `azure:` tier through the port's Blob client, no request made at open)
    and raise on a kind no client serves (no other kind in its place)."""
    base, _ = _encoded(tmp_path)
    files.update_vif(base + ".vif", {"remote_shards": {
        "spec": f"local:{tmp_path / 'tier'}", "keys": {"3": "k3"},
        "sizes": {"3": 10}}})
    os.unlink(base + files.shard_ext(3))
    ev = ec_volume.EcVolume(base, 7)
    assert ev.remote_shard_ids() == [3] and ev.shards[3].size == 10
    files.update_vif(base + ".vif", {"remote_shards": {
        "spec": "azure:http://127.0.0.1:9/c?acct:a2V5", "keys": {"3": "k3"},
        "sizes": {"3": 10}}})
    ev = ec_volume.EcVolume(base, 7)
    client = ev.shards[3]._f.client
    assert (type(client).__name__, client.endpoint, client.container,
            client.account) == ("AzureBlobClient", "http://127.0.0.1:9", "c",
                                "acct")
    ev.close()
    files.update_vif(base + ".vif", {"remote_shards": {
        "spec": "ftp:whatever", "keys": {"3": "k3"}}})
    with pytest.raises(ValueError, match="unknown remote backend"):
        ec_volume.EcVolume(base, 7)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_volume_encoded_by_either_package_read_by_the_other(tmp_path, writer):
    base, want = _encoded(tmp_path, package=writer, seed=4)
    reader = ec_volume.EcVolume if writer == "reference" else ref_volume.EcVolume
    ev = reader(base, 7)
    for nid, (cookie, data) in want.items():
        assert ev.read_needle(nid, cookie=cookie).data == data
    ev.close()
