"""The layered codecs through the port's Store (seaweedfs_tpu_torch/
storage/store.py) and its EC read path (server/volume_server.
make_shard_reader) against the JAX package's Store(coder_name="numpy"):
generate_ec_shards(codec=...) byte for byte, degraded needle reads (the
piggyback strip, msr `repair` and `general` plans, ragged spans across
sub-symbols), rebuild_ec_shards with fragment_reader from a second Store,
and volumes sealed by either package rebuilt and decoded by the other. The
port's Stores run with device="cpu"."""

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
from seaweedfs_tpu_torch.ops.coder import NumpyCoder, TorchCoder, repair_read_bytes
from seaweedfs_tpu_torch.server.volume_server import make_shard_reader
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle, record_size_from_header
from seaweedfs_tpu_torch.storage.store import Store

VID = 4
LB, SB = 8192, 1024
GEOS = {"msr": (14, 2), "piggyback": (10, 4)}


def _geo(codec):
    return EcGeometry(*GEOS[codec], large_block=LB, small_block=SB)


def _store(dirname, codec, **kw):
    return Store("127.0.0.1", 0, "", [DiskLocation(str(dirname))],
                 ec_geometry=_geo(codec), coder_name="torch", device="cpu",
                 ec_codec=codec, **kw)


def _ref_store(dirname, codec):
    d, p = GEOS[codec]
    return RefStore("127.0.0.1", 0, "", [RefLocation(str(dirname))],
                    ec_geometry=RefGeometry(d, p, large_block=LB, small_block=SB),
                    coder_name="numpy", ec_codec=codec)


def _write(store, n=120, seed=2):
    rng = np.random.default_rng(seed)
    store.add_volume(VID)
    want = {i: rng.bytes(int(rng.integers(0, 3000))) for i in range(1, n + 1)}
    store.write_needles_bulk(VID, [Needle(id=i, cookie=7, data=d)
                                   for i, d in want.items()])
    store.find_volume(VID).sync()
    return want


def _encoded(tmp_path, codec):
    """Port store A and the reference store on copies of one volume, both
    EC-encoded with `codec` (passed per call to the port) and mounted;
    asserts every file equal. Returns (a, ref, base, ref_base, want,
    shards, dat)."""
    a = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "a"))],
              ec_geometry=_geo(codec), coder_name="torch", device="cpu")
    want = _write(a)
    (tmp_path / "ref").mkdir()
    for ext in (".dat", ".idx"):
        shutil.copy(tmp_path / "a" / f"{VID}{ext}", tmp_path / "ref" / f"{VID}{ext}")
    dat = open(tmp_path / "a" / f"{VID}.dat", "rb").read()
    ref = _ref_store(tmp_path / "ref", codec)
    base = a.generate_ec_shards(VID, codec=codec)
    ref_base = ref.generate_ec_shards(VID, codec=codec)
    n = sum(GEOS[codec])
    for ext in [files.shard_ext(s) for s in range(n)] + [".ecx", ".vif"]:
        assert open(base + ext, "rb").read() == open(ref_base + ext, "rb").read(), ext
    shards = {s: open(base + files.shard_ext(s), "rb").read() for s in range(n)}
    for s in (a, ref):
        s.delete_volume(VID)
        s.mount_ec_shards(VID)
    assert a.find_ec_volume(VID).codec == codec
    return a, ref, base, ref_base, want, shards, dat


def _lose(store, base, sids):
    for s in sids:
        os.unlink(base + files.shard_ext(s))
    store.mount_ec_shards(VID)


def _on(ev, geo, nid, sids):
    off, size = ev.find_needle(nid)
    return any(iv.shard_and_offset(geo)[0] in sids for iv in locate(
        geo, ev.dat_size, off, record_size_from_header(size)))


@pytest.mark.parametrize("codec", ["msr", "piggyback"])
def test_store_sealed_codec_and_inner_device(tmp_path, codec, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = _store(tmp_path / "s", codec)
    coder = s.coder()
    assert coder.codec == codec
    assert isinstance(coder.inner, TorchCoder) and coder.inner.device.type == "cpu"
    assert s.coder(codec="rs").device.type == "cpu"
    n = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "n"))],
              ec_geometry=_geo(codec), coder_name="numpy", ec_codec=codec)
    assert isinstance(n.coder().inner, NumpyCoder)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "c"))],
              ec_geometry=_geo(codec), ec_codec=codec)  # device="cuda"
    # the default codec of new encodes seals, as the codec= argument does
    want = _write(s)
    base = s.generate_ec_shards(VID)
    assert files.read_vif(base + ".vif")["codec"] == codec
    s.delete_volume(VID)
    s.mount_ec_shards(VID)
    assert s.read_needle(VID, 3, cookie=7).data == want[3]
    s.close()
    n.close()


def test_msr_degraded_reads_repair_and_general_plans(tmp_path):
    codec = "msr"
    a, ref, base, ref_base, want, shards, _ = _encoded(tmp_path, codec)
    geo = _geo(codec)
    ev = a.find_ec_volume(VID)
    sub = ev.shard_size // 256
    # B holds 9..15; A keeps 0..8 and loses 5: every helper reachable
    (tmp_path / "b").mkdir()
    b_base = str(tmp_path / "b" / str(VID))
    for s in range(9, 16):
        os.replace(base + files.shard_ext(s), b_base + files.shard_ext(s))
    for ext in (".ecx", ".vif"):
        shutil.copy(base + ext, b_base + ext)
    b = _store(tmp_path / "b", codec)
    _lose(a, base, (5,))

    def fetch(sid, off, ln):
        sh = b.find_ec_volume(VID).shards.get(sid)
        return None if sh is None else sh.read_at(off, ln)
    frags = []

    def fetch_fragment(sid, ranges):
        frags.append(sid)
        sh = b.find_ec_volume(VID).shards.get(sid)
        return None if sh is None else b"".join(sh.read_at(o, n) for o, n in ranges)

    with cf.ThreadPoolExecutor(4) as pool:
        st = {}
        reader = make_shard_reader(a, VID, fetch, pool, st, fetch_fragment)
        hit = [i for i in want if _on(ev, geo, i, {5})]
        assert hit
        for i in want:
            got = a.read_needle(VID, i, cookie=7, shard_reader=reader)
            assert got.data == want[i] == ref.read_needle(VID, i).data
        assert st["reconstructs"] >= len(hit)
        assert set(st["msr_mode"]) <= {"repair", "repair+repair",
                                       "repair+repair+repair"}
        assert frags and set(frags) <= set(range(9, 16))
        # ragged spans: inside one sub-symbol, across two, across many
        for off, ln in [(sub + 3, 10), (2 * sub - 5, 11), (sub - 1, 3 * sub + 2),
                        (0, ev.shard_size)]:
            before = dict(st["msr_mode"])
            assert reader(5, off, ln) == shards[5][off:off + ln]
            mode = [m for m in st["msr_mode"]
                    if st["msr_mode"][m] != before.get(m, 0)]
            assert len(mode) == 1 and set(mode[0].split("+")) == {"repair"}
        assert "repair+repair+repair" in st["msr_mode"]
        # a second loss: closure-restricted general decodes over 14 survivors
        _lose(b, b_base, (14,))
        st2 = {}
        reader = make_shard_reader(a, VID, fetch, pool, st2, fetch_fragment)
        for i in hit:
            assert a.read_needle(VID, i, cookie=7, shard_reader=reader).data == want[i]
        assert set(m for k in st2["msr_mode"] for m in k.split("+")) == {"general"}
        assert reader(5, sub - 1, sub + 2) == shards[5][sub - 1:2 * sub + 1]
        # a helper that stops answering mid-plan: replanned over the rest
        st3 = {}

        def flaky(sid, ranges):
            if sid == 9:
                raise OSError("holder went away")
            return fetch_fragment(sid, ranges)
        shutil.copy(ref_base + files.shard_ext(14), b_base + files.shard_ext(14))
        b.mount_ec_shards(VID)
        reader = make_shard_reader(a, VID, fetch, pool, st3, flaky)
        assert reader(5, sub + 2, 5) == shards[5][sub + 2:sub + 7]
        assert st3["msr_mode"] == {"general": 1}
    for s in (a, b, ref):
        s.close()


def test_piggyback_degraded_reads_strip_through_piggybacked_parity(tmp_path):
    codec = "piggyback"
    a, ref, base, ref_base, want, shards, _ = _encoded(tmp_path, codec)
    geo = _geo(codec)
    ev = a.find_ec_volume(VID)
    half = ev.shard_size // 2
    _lose(a, base, (3, 7))  # survivors used: 0-2, 4-6, 8-11 (11 piggybacked)
    with cf.ThreadPoolExecutor(4) as pool:
        st = {}
        reader = make_shard_reader(a, VID, lambda *x: None, pool, st)
        hit = [i for i in want if _on(ev, geo, i, {3, 7})]
        for i in want:
            assert a.read_needle(VID, i, cookie=7, shard_reader=reader).data == \
                want[i] == ref.read_needle(VID, i).data
        assert st["reconstructs"] >= len(hit) > 0
        strips = st.get("strips", 0)
        assert reader(3, half + 5, 300) == shards[3][half + 5:half + 305]
        assert reader(7, 10, 200) == shards[7][10:210]
        assert reader(7, half - 50, 100) == shards[7][half - 50:half + 50]
        assert st["strips"] == strips + 2
    # only plain survivors (0..d) in the first d: no strip
    for s in (3, 7):
        shutil.copy(ref_base + files.shard_ext(s), base + files.shard_ext(s))
    _lose(a, base, (2,))
    with cf.ThreadPoolExecutor(4) as pool:
        st = {}
        reader = make_shard_reader(a, VID, lambda *x: None, pool, st)
        assert reader(2, half + 1, 500) == shards[2][half + 1:half + 501]
        assert st["reconstructs"] == 1 and "strips" not in st
    a.close()
    ref.close()


@pytest.mark.parametrize("codec", ["msr", "piggyback"])
def test_rebuild_with_fragment_reader_from_second_store(tmp_path, codec):
    a, ref, base, ref_base, want, shards, _ = _encoded(tmp_path, codec)
    d, p = GEOS[codec]
    n = d + p
    (tmp_path / "b").mkdir()
    b_base = str(tmp_path / "b" / str(VID))
    far = list(range(7, n))
    for s in far:
        os.replace(base + files.shard_ext(s), b_base + files.shard_ext(s))
    for ext in (".ecx", ".vif"):
        shutil.copy(base + ext, b_base + ext)
    b = _store(tmp_path / "b", codec)
    held = b.find_ec_volume(VID)
    calls = {"range": 0, "fragment": 0}

    def shard_reader(sid, off, ln):
        calls["range"] += 1
        return held.shards[sid].read_at(off, ln)

    def fragment_reader(sid, ranges):
        calls["fragment"] += 1
        return b"".join(held.shards[sid].read_at(o, k) for o, k in ranges)

    _lose(a, base, (1,))
    size = len(shards[0])
    st = {}
    assert a.rebuild_ec_shards(VID, shard_reader=shard_reader, remote_shards=far,
                               stats=st, fragment_reader=fragment_reader) == [1]
    assert open(base + files.shard_ext(1), "rb").read() == shards[1]
    assert st["path"] == "ranged"
    assert st["bytes_read"] == repair_read_bytes(codec, d, p, [1], size)
    assert calls["fragment" if codec == "msr" else "range"] > 0
    # general: two losses on A, survivors on both
    _lose(a, base, (0, 2))
    st = {}
    assert a.rebuild_ec_shards(VID, shard_reader=shard_reader, remote_shards=far,
                               stats=st, fragment_reader=fragment_reader) == [0, 2]
    assert st["path"] == "general"
    for s in (0, 2):
        assert open(base + files.shard_ext(s), "rb").read() == shards[s]
    for i in (5, 50, 100):
        assert a.read_needle(VID, i, cookie=7, shard_reader=shard_reader).data \
            == want[i]
    for s in (a, b, ref):
        s.close()


@pytest.mark.parametrize("codec", ["msr", "piggyback"])
@pytest.mark.parametrize("sealer", ["reference", "port"])
def test_cross_package_rebuild_and_decode(tmp_path, codec, sealer):
    a, ref, base, ref_base, want, shards, dat = _encoded(tmp_path, codec)
    d, p = GEOS[codec]
    # the other package works on a copy of what `sealer` wrote
    src = ref_base if sealer == "reference" else base
    (tmp_path / "x").mkdir()
    x_base = str(tmp_path / "x" / str(VID))
    for ext in [files.shard_ext(s) for s in range(d + p)] + [".ecx", ".vif"]:
        shutil.copy(src + ext, x_base + ext)
    if sealer == "reference":
        x = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "x"))],
                  coder_name="torch", device="cpu")
    else:
        x = RefStore("127.0.0.1", 0, "", [RefLocation(str(tmp_path / "x"))],
                     coder_name="numpy")
    assert x.find_ec_volume(VID).base == x_base
    for lost in [(0,), (d,), (1, d + p - 1)]:
        for s in lost:
            os.unlink(x_base + files.shard_ext(s))
        x.mount_ec_shards(VID)
        assert x.rebuild_ec_shards(VID) == list(lost)
        for s in lost:
            assert open(x_base + files.shard_ext(s), "rb").read() == shards[s]
    os.unlink(x_base + files.shard_ext(2))
    x.mount_ec_shards(VID)
    v = x.ec_shards_to_volume(VID)
    assert open(v.file_name() + ".dat", "rb").read() == dat
    assert x.read_needle(VID, 9).data == want[9]
    for s in (a, ref, x):
        s.close()


def test_codec_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """chip_smoke.py's phase 11 (msr RS(14,2) and piggyback RS(10,4) on one
    Store: encode, degraded reads, ranged and general rebuilds, decode),
    every check of it, at a small size on the plain versions."""
    import chip_smoke
    res = chip_smoke.codec_round_trip(np, str(tmp_path), 19, "cpu",
                                      (1 << 16, 4096), needles=3000,
                                      sample=300, device="cpu")
    assert all(res[k] > 0 for k in ("msr_repair_reads", "msr_general_reads",
                                    "pb_strip_reads", "pb_plain_reads"))
