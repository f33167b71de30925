"""The port's rebuild with remote survivors (seaweedfs_tpu_torch/ec/repair.py
and ec/encoder.rebuild_shards) against the JAX package's: survivor readers
over local files and a `shard_reader`, short reads, and rebuilt shards and
byte counts equal to the reference's (NumpyCoder and JaxCoder on the CPU)."""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import repair as ref_repair
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.ops.coder import get_coder as ref_get_coder
from seaweedfs_tpu_torch.ec import encoder, files, repair
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.ops.coder import NumpyCoder, TorchCoder, codec_coder

GEO = EcGeometry(d=10, p=4, large_block=16384, small_block=2048)
REF_GEO = RefGeometry(d=10, p=4, large_block=16384, small_block=2048)
SIZE = GEO.large_block * GEO.d + 7 * GEO.small_block * GEO.d + 1234


def _encode(tmp_path, name="v", size=SIZE, seed=3, coder=None):
    """One RS(10,4) shard set under tmp_path/name (plain RS unless `coder`
    names another codec); returns (base, shards)."""
    dat = tmp_path / f"{name}.dat"
    dat.write_bytes(np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes())
    base = str(tmp_path / name)
    encoder.encode_volume(str(dat), base, GEO, coder or NumpyCoder(10, 4))
    return base, {s: open(base + files.shard_ext(s), "rb").read()
                  for s in range(GEO.n)}


def _split(base, far_dir, remote):
    """Move the `remote` shards of `base` into far_dir; returns a
    shard_reader serving them and the list of calls it answered."""
    os.makedirs(far_dir, exist_ok=True)
    for s in remote:
        shutil.move(base + files.shard_ext(s),
                    os.path.join(far_dir, os.path.basename(base) + files.shard_ext(s)))
    calls = []

    def shard_reader(sid, off, ln):
        calls.append(sid)
        with open(os.path.join(far_dir, os.path.basename(base)
                               + files.shard_ext(sid)), "rb") as f:
            f.seek(off)
            return f.read(ln)
    return shard_reader, calls


@pytest.mark.parametrize("kind", ["local", "remote"])
@pytest.mark.parametrize("package", ["reference", "port"])
def test_short_survivor_read_raises_oserror(tmp_path, kind, package):
    base, shards = _encode(tmp_path)
    size = len(shards[0])
    mod = ref_repair if package == "reference" else repair
    counter = mod.RepairCounter("rs")
    if kind == "local":
        readers, _, close = mod.make_readers(
            base, {0: base + files.shard_ext(0)}, None, (), counter)
    else:
        readers, _, close = mod.make_readers(
            base, {}, lambda sid, off, ln: b"\x00" * (ln - 1), [0], counter)
    try:
        with pytest.raises(OSError, match="short"):
            readers[0](size - 8, 16)
    finally:
        close()


def test_make_readers_counts_bytes_by_kind(tmp_path):
    base, shards = _encode(tmp_path)
    counter = repair.RepairCounter("rs")
    readers, frag, close = repair.make_readers(
        base, {1: base + files.shard_ext(1)},
        lambda sid, off, ln: shards[sid][off:off + ln], [1, 2, 3], counter)
    try:
        assert sorted(readers) == sorted(frag) == [1, 2, 3]
        assert readers[1](5, 100).tobytes() == shards[1][5:105]
        assert readers[3](7, 50).tobytes() == shards[3][7:57]
        # fragment reads: gathered preads locally, one ranged fetch per run
        # remotely when no fragment_reader is wired
        assert frag[1]([(0, 4), (9, 6)]).tobytes() == shards[1][:4] + shards[1][9:15]
        assert frag[2]([(3, 5)]).tobytes() == shards[2][3:8]
    finally:
        close()
    assert (counter.bytes_read, counter.remote_bytes_read) == (165, 55)
    packed = []

    def fragment_reader(sid, ranges):
        packed.append((sid, list(ranges)))
        return b"".join(shards[sid][o:o + ln] for o, ln in ranges)
    counter = repair.RepairCounter("msr")
    _, frag, close = repair.make_readers(
        base, {}, lambda sid, off, ln: b"", [4], counter,
        fragment_reader=fragment_reader)
    try:
        assert frag[4]([(1, 2), (7, 3)]).tobytes() == shards[4][1:3] + shards[4][7:10]
        with pytest.raises(OSError, match="short fragment"):
            repair.make_readers(base, {}, lambda *a: b"", [5], counter,
                                fragment_reader=lambda sid, r: b"x")[1][5]([(0, 2)])
    finally:
        close()
    assert packed == [(4, [(1, 2), (7, 3)])] and counter.remote_bytes_read == 5


@pytest.mark.parametrize("ref_coder", ["numpy", "jax"])
@pytest.mark.parametrize("lost,remote", [((0, 5, 10, 13), (6, 7, 8, 9, 11, 12)),
                                         ((2,), (0, 1, 3, 4, 5)),
                                         ((10, 11, 12, 13), tuple(range(10)))])
def test_rebuild_with_remote_survivors_matches_reference(tmp_path, ref_coder,
                                                         lost, remote):
    got_stats, want_stats = {}, {}
    rebuilt = {}
    for package in ("port", "reference"):
        (tmp_path / package).mkdir()
        base, shards = _encode(tmp_path / package)
        for s in lost:
            os.unlink(base + files.shard_ext(s))
        reader, calls = _split(base, str(tmp_path / package / "far"), remote)
        if package == "port":
            got = encoder.rebuild_shards(
                base, GEO, TorchCoder(10, 4, device="cpu"), chunk=1024,
                batch=3, shard_reader=reader, remote_shards=list(remote),
                stats=got_stats)
        else:
            got = ref_encoder.rebuild_shards(
                base, REF_GEO, ref_get_coder(ref_coder, 10, 4), chunk=1024,
                batch=3, shard_reader=reader, remote_shards=list(remote),
                stats=want_stats)
        assert got == sorted(lost)
        rebuilt[package] = {s: open(base + files.shard_ext(s), "rb").read()
                            for s in lost}
        assert rebuilt[package] == {s: shards[s] for s in lost}
        assert set(calls) <= set(remote) and calls
    shard_size = len(shards[0])
    keys = ("bytes_read", "bytes_written", "codec", "path", "shard_size")
    assert {k: got_stats[k] for k in keys} == {k: want_stats[k] for k in keys}
    assert got_stats["bytes_read"] == GEO.d * shard_size
    assert got_stats["remote"] == len(remote)
    used = sorted(set(range(GEO.n)) - set(lost))[:GEO.d]
    assert got_stats["remote_bytes_read"] == \
        len(set(used) & set(remote)) * shard_size
    assert rebuilt["port"] == rebuilt["reference"]


def test_wanted_shard_is_never_a_survivor(tmp_path):
    """A shard both wanted and listed remote (a stale holder list) is
    rebuilt, not read: in both packages, the reader never serves it."""
    base, shards = _encode(tmp_path)
    ref_base = str(tmp_path / "r")
    for s in range(GEO.n):
        shutil.copy(base + files.shard_ext(s), ref_base + files.shard_ext(s))
    shutil.copy(base + ".vif", ref_base + ".vif")
    for b in (base, ref_base):
        for s in (3, 4):
            os.unlink(b + files.shard_ext(s))
    stale = {}

    def make_reader(tag):
        stale[tag] = []

        def reader(sid, off, ln):
            stale[tag].append(sid)
            return b"\xAA" * ln  # a stale copy: wrong bytes
        return reader
    got, want = {}, {}
    assert encoder.rebuild_shards(base, GEO, TorchCoder(10, 4, device="cpu"),
                                  wanted=[3, 4], shard_reader=make_reader("port"),
                                  remote_shards=[3, 4], stats=got) == [3, 4]
    assert ref_encoder.rebuild_shards(ref_base, REF_GEO,
                                      ref_get_coder("numpy", 10, 4),
                                      wanted=[3, 4],
                                      shard_reader=make_reader("ref"),
                                      remote_shards=[3, 4], stats=want) == [3, 4]
    assert stale == {"port": [], "ref": []}
    assert got["remote"] == 0 and got["bytes_read"] == want["bytes_read"]
    for b in (base, ref_base):
        for s in (3, 4):
            assert open(b + files.shard_ext(s), "rb").read() == shards[s]


def test_rebuild_refuses_too_few_survivors_and_layered_codecs(tmp_path):
    """Too few survivors is refused as in the reference; the layered codecs
    now rebuild through their own rebuilders (never positionally), with a
    fragment_reader accepted beside the shard_reader."""
    base, _ = _encode(tmp_path)
    for s in range(5):
        os.unlink(base + files.shard_ext(s))
    with pytest.raises(RuntimeError, match="only 9 shards"):
        encoder.rebuild_shards(base, GEO, NumpyCoder(10, 4))
    assert sorted(repair.REBUILDERS) == sorted(ref_repair.REBUILDERS) == \
        ["msr", "piggyback"]
    assert sorted(repair.OVERLAYS) == sorted(ref_repair.OVERLAYS)
    for codec in ("piggyback", "msr"):
        pbase, shards = _encode(tmp_path, name=codec, coder=codec_coder(
            codec, 10, 4, backend="torch", device="cpu"))
        shard_reader, calls = _split(pbase, str(tmp_path / f"far_{codec}"),
                                     [0, 11, 12, 13])
        frags = []

        def fragment_reader(sid, ranges):
            frags.append(sid)
            return b"".join(shard_reader(sid, o, ln) for o, ln in ranges)
        os.unlink(pbase + files.shard_ext(3))
        st = {}
        assert encoder.rebuild_shards(
            pbase, GEO, codec_coder(codec, 10, 4, backend="torch", device="cpu"),
            shard_reader=shard_reader, remote_shards=[0, 11, 12, 13], stats=st,
            fragment_reader=fragment_reader) == [3]
        assert st["path"] == "ranged" and st["codec"] == codec
        assert open(pbase + files.shard_ext(3), "rb").read() == shards[3]
        assert bool(frags) == (codec == "msr")


def test_open_outputs_and_pwrite(tmp_path):
    base = str(tmp_path / "o")
    fds = repair._open_outputs(base, [2, 7], 4096)
    try:
        data = np.arange(3000, dtype=np.uint8)
        repair._pwrite(fds[7], data, 1000)
    finally:
        for fd in fds.values():
            os.close(fd)
    assert os.path.getsize(base + files.shard_ext(2)) == 4096
    raw = open(base + files.shard_ext(7), "rb").read()
    assert len(raw) == 4096 and raw[1000:4000] == data.tobytes()
    assert raw[:1000] == b"\x00" * 1000
