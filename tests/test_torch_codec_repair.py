"""The port's file-level layered-codec paths (seaweedfs_tpu_torch/ec/
repair.py, ec/stream.py's overlay seal, ec/encoder.rebuild_shards' codec
dispatch) against the JAX package's, byte for byte: piggyback and msr
shard files and .vif seals, the single-loss ranged and general rebuilders
with local and remote survivors (ranges and packed fragments), the
`ranged`, `ranged-folded`, `general` and `full` dispatch paths, the
piggyback degraded-interval decode (`reconstruct_interval`), and decode.
The port's coders run with device="cpu" (the plain PyTorch version of K1)
or on their numpy backend; the reference's on numpy."""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import repair as ref_repair
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.ops.coder import codec_coder as ref_codec_coder
from seaweedfs_tpu_torch.ec import encoder, files, repair
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.ops.coder import NumpyCoder, codec_coder, repair_read_bytes

LB, SB = 4096, 512
CASES = [("piggyback", 10, 4), ("piggyback", 4, 2), ("msr", 4, 2),
         ("msr", 10, 4), ("msr", 14, 2)]


class Pending:
    def __init__(self, arr):
        self._arr = arr

    def wait(self):
        return self._arr


class PendingCoder(NumpyCoder):
    """NumpyCoder whose outputs come back as pending results (no
    __array__), as TorchCoder's DeviceResult on the card."""

    def encode(self, data):
        return Pending(super().encode(data))

    def reconstruct(self, survivors, present, wanted):
        return Pending(super().reconstruct(survivors, present, wanted))


def _port(codec, d, p, backend="torch"):
    return codec_coder(codec, d, p, backend=backend, device="cpu")


def _dat(tmp_path, d, seed=1):
    """A .dat of two large rows, a few small rows and a ragged tail."""
    size = 2 * LB * d + 3 * SB * d + 777
    path = tmp_path / "src.dat"
    path.write_bytes(np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes())
    return str(path)


def _encode_both(tmp_path, codec, d, p, backend="torch"):
    """The same .dat encoded by the port (into tmp/port) and the reference
    (into tmp/ref); asserts every file equal; returns (base, ref_base,
    shards)."""
    dat = _dat(tmp_path, d)
    for sub in ("port", "ref"):
        os.makedirs(tmp_path / sub, exist_ok=True)
    base, ref_base = str(tmp_path / "port" / "v"), str(tmp_path / "ref" / "v")
    stats = {}
    encoder.encode_volume(dat, base, EcGeometry(d, p, LB, SB),
                          _port(codec, d, p, backend), stats=stats)
    ref_encoder.encode_volume(dat, ref_base, RefGeometry(d, p, LB, SB),
                              ref_codec_coder(codec, d, p))
    shards = {}
    for s in range(d + p):
        shards[s] = open(base + files.shard_ext(s), "rb").read()
        assert shards[s] == open(ref_base + files.shard_ext(s), "rb").read(), s
    assert open(base + ".vif", "rb").read() == open(ref_base + ".vif", "rb").read()
    assert files.read_vif(base + ".vif")["codec"] == codec
    assert stats["overlay_s"] > 0 and stats["seal_s"] >= stats["overlay_s"]
    return base, ref_base, shards


@pytest.mark.parametrize("codec,d,p", CASES)
@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_overlay_encode_matches_reference(tmp_path, codec, d, p, backend):
    _, _, shards = _encode_both(tmp_path, codec, d, p, backend)
    # data shards are plain striped bytes; the codec shows in the parities
    rs = {}
    os.makedirs(tmp_path / "rs")
    encoder.encode_volume(_dat(tmp_path, d), str(tmp_path / "rs" / "v"),
                          EcGeometry(d, p, LB, SB), NumpyCoder(d, p))
    for s in range(d + p):
        rs[s] = open(str(tmp_path / "rs" / "v") + files.shard_ext(s), "rb").read()
    assert all(shards[s] == rs[s] for s in range(d))
    assert any(shards[s] != rs[s] for s in range(d, d + p))


def test_msr_refuses_shards_not_divisible_by_alpha(tmp_path):
    dat = _dat(tmp_path, 5)
    for pkg, geo, coder in [
            (encoder, EcGeometry(5, 3, LB, SB), _port("msr", 5, 3)),
            (ref_encoder, RefGeometry(5, 3, LB, SB), ref_codec_coder("msr", 5, 3))]:
        with pytest.raises(ValueError, match="alpha"):
            pkg.encode_volume(dat, str(tmp_path / "x"), geo, coder)
        assert not os.path.exists(str(tmp_path / "x") + ".vif")


def _losses(codec, d, p):
    """(lost shards, the path both packages take)."""
    single_data = "ranged" if codec == "msr" or p > 2 else "general"
    return [((1,), single_data), ((d - 1,), single_data),
            ((d,), "ranged" if codec == "msr" else "general"),
            ((0, d + p - 1), "general"), ((d, d + 1), "general")]


@pytest.mark.parametrize("codec,d,p", CASES)
def test_rebuild_paths_match_reference(tmp_path, codec, d, p):
    base, ref_base, shards = _encode_both(tmp_path, codec, d, p)
    size = len(shards[0])
    coder, ref_coder = _port(codec, d, p), ref_codec_coder(codec, d, p)
    for lost, path in _losses(codec, d, p):
        for b in (base, ref_base):
            for s in lost:
                os.unlink(b + files.shard_ext(s))
        got, want = {}, {}
        assert encoder.rebuild_shards(base, EcGeometry(d, p, LB, SB), coder,
                                      stats=got) == list(lost)
        ref_encoder.rebuild_shards(ref_base, RefGeometry(d, p, LB, SB),
                                   ref_coder, stats=want)
        assert got["path"] == want["path"] == path, lost
        assert got["bytes_read"] == want["bytes_read"]
        assert got["bytes_written"] == want["bytes_written"] == len(lost) * size
        if path == "ranged":
            assert got["bytes_read"] == repair_read_bytes(codec, d, p, lost, size)
        for s in lost:
            assert open(base + files.shard_ext(s), "rb").read() == shards[s]
            assert open(ref_base + files.shard_ext(s), "rb").read() == shards[s]


def test_rs_codec_takes_the_full_path(tmp_path):
    dat = _dat(tmp_path, 4)
    base = str(tmp_path / "v")
    encoder.encode_volume(dat, base, EcGeometry(4, 2, LB, SB), NumpyCoder(4, 2))
    want = open(base + files.shard_ext(2), "rb").read()
    os.unlink(base + files.shard_ext(2))
    st = {}
    encoder.rebuild_shards(base, EcGeometry(4, 2, LB, SB), NumpyCoder(4, 2), stats=st)
    assert st["path"] == "full" and st["bytes_read"] == 4 * len(want)
    assert open(base + files.shard_ext(2), "rb").read() == want


def _far(base, tmp_path, sids):
    """Move `sids` of `base` to a far directory; returns (shard_reader,
    fragment_reader, calls) serving them."""
    far = tmp_path / "far"
    far.mkdir(exist_ok=True)
    for s in sids:
        shutil.move(base + files.shard_ext(s), str(far / f"v{files.shard_ext(s)}"))
    calls = {"range": 0, "fragment": 0}

    def read(sid, off, ln):
        with open(far / f"v{files.shard_ext(sid)}", "rb") as f:
            f.seek(off)
            return f.read(ln)

    def shard_reader(sid, off, ln):
        calls["range"] += 1
        return read(sid, off, ln)

    def fragment_reader(sid, ranges):
        calls["fragment"] += 1
        return b"".join(read(sid, o, ln) for o, ln in ranges)
    return shard_reader, fragment_reader, calls


@pytest.mark.parametrize("with_fragments", [True, False])
def test_msr_single_loss_with_remote_survivors(tmp_path, with_fragments):
    d, p = 10, 4
    base, ref_base, shards = _encode_both(tmp_path, "msr", d, p)
    size = len(shards[0])
    os.unlink(base + files.shard_ext(3))
    remote = list(range(7, 14))
    shard_reader, fragment_reader, calls = _far(base, tmp_path, remote)
    st = {}
    got = encoder.rebuild_shards(
        base, EcGeometry(d, p, LB, SB), _port("msr", d, p), wanted=[3],
        shard_reader=shard_reader, remote_shards=remote, stats=st,
        fragment_reader=fragment_reader if with_fragments else None)
    assert got == [3] and st["path"] == "ranged"
    assert open(base + files.shard_ext(3), "rb").read() == shards[3]
    assert st["bytes_read"] == repair_read_bytes("msr", d, p, [3], size)
    assert st["remote_bytes_read"] == len(remote) * size // 4
    if with_fragments:
        assert calls == {"range": 0, "fragment": len(remote)}
    else:
        assert calls["fragment"] == 0 and calls["range"] > len(remote)


def test_msr_general_reads_each_survivor_once(tmp_path):
    d, p = 14, 2
    base, _, shards = _encode_both(tmp_path, "msr", d, p)
    for s in (0, 14):
        os.unlink(base + files.shard_ext(s))
    st = {}
    encoder.rebuild_shards(base, EcGeometry(d, p, LB, SB), _port("msr", d, p), stats=st)
    assert st["path"] == "general" and st["bytes_read"] == d * len(shards[0])
    assert all(open(base + files.shard_ext(s), "rb").read() == shards[s]
               for s in (0, 14))


def test_ranged_folded_dispatch_is_byte_identical(tmp_path):
    """A fold planner's relay groups replace their survivors' fragments by
    one folded partial; local survivors never fold."""
    from seaweedfs_tpu_torch.geo import repair_fold
    from seaweedfs_tpu_torch.ops import gf8
    d, p = 10, 4
    base, _, shards = _encode_both(tmp_path, "msr", d, p)
    size = len(shards[0])
    os.unlink(base + files.shard_ext(2))
    remote = list(range(5, 14))
    shard_reader, fragment_reader, calls = _far(base, tmp_path, remote)
    group = tuple(remote[:6])  # |group| > q: folding pays
    relayed = []

    def fetch(ranges):
        relayed.append(len(ranges))
        rows = [np.frombuffer(fragment_reader(sid, ranges), np.uint8)
                .reshape(len(ranges), -1) for sid in group]
        mat = repair_fold.stacked_matrix(d, p, 2, group)
        return gf8.np_gf_apply(mat, np.concatenate(rows))

    def planner(coder, f):
        assert f == 2
        return [(group, fetch), ((0, 1), lambda ranges: None)]  # 0, 1 local

    st = {}
    encoder.rebuild_shards(base, EcGeometry(d, p, LB, SB), _port("msr", d, p),
                           shard_reader=shard_reader, remote_shards=remote,
                           stats=st, fragment_reader=fragment_reader,
                           fold_planner=planner)
    assert st["path"] == "ranged-folded" and relayed
    assert open(base + files.shard_ext(2), "rb").read() == shards[2]
    # flat helpers ship size/q each; the group's partials add up to one
    # shard-equivalent (alpha rows of every window)
    assert st["bytes_read"] == (d + p - 1 - len(group)) * size // p + size
    # a planner with no groups, or one naming only local survivors: flat
    for plan in ([], [((0, 1), None)]):
        os.unlink(base + files.shard_ext(2))
        st = {}
        encoder.rebuild_shards(base, EcGeometry(d, p, LB, SB), _port("msr", d, p),
                               shard_reader=shard_reader, remote_shards=remote,
                               stats=st, fragment_reader=fragment_reader,
                               fold_planner=lambda c, f, plan=plan: plan)
        assert st["path"] == "ranged"
        assert open(base + files.shard_ext(2), "rb").read() == shards[2]


def test_piggyback_rebuilders_take_inner_outputs_through_host_result(tmp_path):
    d, p = 10, 4
    base, _, shards = _encode_both(tmp_path, "piggyback", d, p)
    coder = _port("piggyback", d, p, backend="numpy")
    coder.inner = PendingCoder(d, p)
    for lost, path in [((4,), "ranged"), ((3, 7), "general"), ((12,), "general")]:
        for s in lost:
            os.unlink(base + files.shard_ext(s))
        st = {}
        encoder.rebuild_shards(base, EcGeometry(d, p, LB, SB), coder, stats=st)
        assert st["path"] == path
        assert all(open(base + files.shard_ext(s), "rb").read() == shards[s]
                   for s in lost)


@pytest.mark.parametrize("inner", ["torch", "pending"])
def test_reconstruct_interval_matches_reference(tmp_path, inner):
    d, p = 10, 4
    _, _, shards = _encode_both(tmp_path, "piggyback", d, p)
    size = len(shards[0])
    coder = _port("piggyback", d, p)
    if inner == "pending":
        coder.inner = PendingCoder(d, p)
    ref_coder = ref_codec_coder("piggyback", d, p)
    arr = {s: np.frombuffer(shards[s], np.uint8) for s in shards}
    half = size // 2
    for f, lost_too in [(3, 0), (7, 3), (1, 10)]:
        present = [s for s in range(d + p) if s not in (f, lost_too)][:d]
        for off, ln in [(5, 100), (half - 40, 80), (half + 9, 300), (size - 17, 17)]:
            gathered = {s: shards[s][off:off + ln] for s in present}
            pairs = []

            def fetch_pair(sid, o, n):
                pairs.append(sid)
                return arr[sid][o:o + n].tobytes()
            got = repair.reconstruct_interval(coder, gathered, f, off, ln,
                                              size, fetch_pair)
            want = ref_repair.reconstruct_interval(ref_coder, gathered, f, off,
                                                   ln, size, fetch_pair)
            assert got == want == shards[f][off:off + ln]
            assert bool(pairs) == (off + ln > half and max(present) > d)


def test_decode_rebuilds_missing_data_through_the_codec(tmp_path):
    d, p = 4, 2
    base, _, shards = _encode_both(tmp_path, "msr", d, p)
    dat = open(_dat(tmp_path, d), "rb").read()
    os.unlink(base + files.shard_ext(1))
    encoder.decode_volume(base, str(tmp_path / "out.dat"),
                          EcGeometry(d, p, LB, SB), _port("msr", d, p))
    assert open(tmp_path / "out.dat", "rb").read() == dat
    assert open(base + files.shard_ext(1), "rb").read() == shards[1]


def test_counter_times_codec_rebuilds(tmp_path):
    d, p = 4, 2
    base, _, _ = _encode_both(tmp_path, "msr", d, p)
    os.unlink(base + files.shard_ext(0))
    st = {}
    encoder.rebuild_shards(base, EcGeometry(d, p, LB, SB), _port("msr", d, p), stats=st)
    assert st["local_read_s"] > 0 and st["write_s"] > 0 and st["flush_s"] > 0
    assert st["remote_bytes_read"] == 0 and st["remote_read_s"] == 0
