"""The port's streaming encode, rebuild and decode (seaweedfs_tpu_torch/ec)
against the JAX package's: the same .dat and .idx through both packages give
the same .ec*, .ecx and .vif bytes, and a volume encoded by either package
rebuilds and decodes with the other."""

import errno
import glob
import os
import threading

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import stream as ref_stream
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.ops.coder import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu.ops.coder import codec_coder as ref_codec_coder
from seaweedfs_tpu_torch.ec import encoder, files, stream
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.ops import coder as coder_mod
from seaweedfs_tpu_torch.ops.coder import NumpyCoder, TorchCoder

GEO = EcGeometry(d=4, p=2, large_block=4096, small_block=512)
REF_GEO = RefGeometry(d=4, p=2, large_block=4096, small_block=512)

# the JAX package's matrix (tests/test_ec_pipeline.py): empty volume /
# sub-block / exact small row / one byte past the large tier / two large
# rows + ragged padded tail / sub-small-block
NASTY_SIZES = [0, 77, GEO.small_block * GEO.d,
               GEO.large_block * GEO.d + 1,
               GEO.large_block * GEO.d * 2 + GEO.small_block * 3 + 123,
               GEO.small_block - 1]


def _write_idx(path, n, seed):
    """Synthetic .idx: n entries with repeated keys and one tombstone."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, max(2, n // 2 + 1), n).astype("<u8")
    offs = np.arange(n, dtype="<u4")
    sizes = rng.integers(1, 5000, n).astype("<u4")
    if n:
        sizes[-1] = 0xFFFFFFFF
    arr = np.zeros((n, 16), np.uint8)
    arr[:, 0:8] = keys.reshape(-1, 1).view(np.uint8).reshape(-1, 8)
    arr[:, 8:12] = offs.reshape(-1, 1).view(np.uint8).reshape(-1, 4)
    arr[:, 12:16] = sizes.reshape(-1, 1).view(np.uint8).reshape(-1, 4)
    path.write_bytes(arr.tobytes())


def _make_jobs(tmp_path, sizes, seed=7):
    rng = np.random.default_rng(seed)
    srcs = []
    for i, size in enumerate(sizes):
        dat = tmp_path / f"{i}.dat"
        dat.write_bytes(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        idx = tmp_path / f"{i}.idx"
        _write_idx(idx, i * 3, seed + i)
        srcs.append((str(dat), str(idx)))
    return srcs


def _jobs(srcs, tmp_path, tag):
    return [(dat, str(tmp_path / f"{tag}{i}"), idx)
            for i, (dat, idx) in enumerate(srcs)]


def _outputs(base, n):
    exts = [files.shard_ext(s) for s in range(n)] + [".ecx", ".vif"]
    return {e: open(base + e, "rb").read() for e in exts
            if os.path.exists(base + e)}


@pytest.mark.parametrize("coder_name", ["numpy", "torch-cpu"])
@pytest.mark.parametrize("writers", [1, 3])
def test_encode_volumes_matches_reference(tmp_path, coder_name, writers):
    """NASTY_SIZES through one shared stream (batch=3 forces cross-volume
    spanning and a partial final batch; chunk=256 < small_block forces
    multi-chunk rows), sync (numpy) and async (torch) drain paths: every
    output file equals the JAX package's NumpyCoder encode."""
    srcs = _make_jobs(tmp_path, NASTY_SIZES)
    ref_jobs = _jobs(srcs, tmp_path, "ref")
    ref_stream.encode_volumes(ref_jobs, REF_GEO, RefNumpyCoder(4, 2),
                              chunk=256, batch=3, writers=writers)
    coder = (NumpyCoder(4, 2) if coder_name == "numpy"
             else TorchCoder(4, 2, device="cpu"))
    jobs = _jobs(srcs, tmp_path, "port")
    stats = {}
    stream.encode_volumes(jobs, GEO, coder, chunk=256, batch=3,
                          writers=writers, stats=stats)
    assert stats["mode"] == ("sync" if coder_name == "numpy" else "async")
    assert stats["open_s"] >= 0.0 and stats["seal_s"] > 0.0
    for (_, ref_base, _), (_, base, _) in zip(ref_jobs, jobs):
        want, got = _outputs(ref_base, GEO.n), _outputs(base, GEO.n)
        assert set(got) == set(want) and ".vif" in got
        for ext in want:
            assert got[ext] == want[ext], (base, ext)


def _round_trip(tmp_path, enc_pkg, dec_pkg, lost):
    srcs = _make_jobs(tmp_path, [GEO.large_block * GEO.d * 2 + 3000], seed=21)
    dat, idx = srcs[0]
    base = str(tmp_path / "v")
    if enc_pkg == "ref":
        ref_encoder.encode_volume(dat, base, REF_GEO, RefNumpyCoder(4, 2),
                                  idx_path=idx, chunk=512, batch=3)
    else:
        encoder.encode_volume(dat, base, GEO, TorchCoder(4, 2, device="cpu"),
                              idx_path=idx, chunk=512, batch=3)
    orig = _outputs(base, GEO.n)
    for s in lost:
        os.unlink(base + files.shard_ext(s))
    stats = {}
    if dec_pkg == "ref":
        assert ref_encoder.rebuild_shards(base, REF_GEO, RefNumpyCoder(4, 2),
                                          chunk=512, batch=3) == list(lost)
    else:
        assert encoder.rebuild_shards(base, GEO, TorchCoder(4, 2, device="cpu"),
                                      chunk=512, batch=3,
                                      stats=stats) == list(lost)
        shard_size = len(orig[".ec00"])
        assert {k: stats[k] for k in ("bytes_read", "bytes_written", "codec",
                                      "path", "shard_size")} == {
            "bytes_read": GEO.d * shard_size,
            "bytes_written": len(lost) * shard_size,
            "codec": "rs", "path": "full", "shard_size": shard_size}
        assert all(stats[k] >= 0.0 for k in ("read_s", "write_s", "flush_s",
                                             "wall_s"))
    assert _outputs(base, GEO.n) == orig
    # lose the data shards again: decode rebuilds them itself
    for s in lost:
        if s < GEO.d:
            os.unlink(base + files.shard_ext(s))
    out = str(tmp_path / "decoded.dat")
    if dec_pkg == "ref":
        ref_encoder.decode_volume(base, out, REF_GEO, RefNumpyCoder(4, 2))
    else:
        encoder.decode_volume(base, out, GEO, TorchCoder(4, 2, device="cpu"))
    assert open(out, "rb").read() == open(dat, "rb").read()


@pytest.mark.parametrize("enc_pkg,dec_pkg", [("ref", "port"), ("port", "ref")])
def test_cross_package_round_trip(tmp_path, enc_pkg, dec_pkg):
    _round_trip(tmp_path, enc_pkg, dec_pkg, lost=(0, 5))


def test_port_rebuild_with_numpy_coder(tmp_path):
    srcs = _make_jobs(tmp_path, [9000], seed=5)
    base = str(tmp_path / "v")
    encoder.encode_volume(srcs[0][0], base, GEO, NumpyCoder(4, 2), chunk=512)
    orig = _outputs(base, GEO.n)
    os.unlink(base + ".ec01")
    os.unlink(base + ".ec04")
    assert encoder.rebuild_shards(base, GEO, NumpyCoder(4, 2)) == [1, 4]
    assert _outputs(base, GEO.n) == orig
    assert encoder.rebuild_shards(base, GEO, NumpyCoder(4, 2)) == []
    for s in (0, 1, 2):
        os.unlink(base + files.shard_ext(s))
    with pytest.raises(RuntimeError, match="need 4"):
        encoder.rebuild_shards(base, GEO, NumpyCoder(4, 2))


def test_async_pipe_recycling_gated_on_writers():
    """next_buffer must not hand out a buffer a writer still reads."""
    pipe = stream.AsyncPipe((2, 2, 4), depth=0)  # pool of 2 buffers
    first = pipe.next_buffer()
    pipe.retain(first)
    got = []

    def spin():
        pipe.next_buffer()          # the other buffer: free
        got.append(pipe.next_buffer())  # back to `first`: must block

    t = threading.Thread(target=spin, daemon=True)
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive(), "recycle was not gated on the writer hold"
    pipe.release(first)
    t.join(timeout=2)
    assert not t.is_alive() and got and got[0] is first
    assert pipe.recycle_wait_s > 0.0


def test_async_pipe_takes_buffers_from_the_coder():
    shapes = []

    def alloc(shape):
        shapes.append(shape)
        return np.zeros(shape, np.uint8)

    pipe = stream.AsyncPipe((3, 4, 8), depth=1, alloc=alloc)
    assert shapes == [(3, 4, 8)] * 3 and len(pipe.pool) == 3
    drained = []
    pipe.submit(np.ones(2, np.uint8), "a", lambda arr, ctx: drained.append(ctx))
    pipe.submit(np.ones(2, np.uint8), "b", lambda arr, ctx: drained.append(ctx))
    assert drained == ["a"]
    pipe.flush()
    assert drained == ["a", "b"]


def test_writer_pool_enospc_fails_cleanly(tmp_path, monkeypatch):
    srcs = _make_jobs(tmp_path, [5000, 6000], seed=3)

    def no_space(fd, data, off):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(stream.os, "pwrite", no_space)
    with pytest.raises(OSError) as ei:
        stream.encode_volumes(_jobs(srcs, tmp_path, "v"), GEO,
                              TorchCoder(4, 2, device="cpu"), chunk=512,
                              batch=4, writers=2)
    assert ei.value.errno == errno.ENOSPC
    monkeypatch.undo()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("swtpu-torch-ec-writer")]
    assert glob.glob(str(tmp_path / "v*")) == []


def test_fit_chunk_matches_reference():
    for chunk in (1000, 100, 512, 1, 45, 300):
        assert stream.fit_chunk(GEO, chunk) == ref_stream.fit_chunk(REF_GEO, chunk)


def test_codecs_not_ported_raise(tmp_path):
    """Every coder of the JAX package is ported: native and mesh are compute
    backends, so as erasure codecs they are refused as the reference
    refuses them; the layered codecs are registered and stream their slabs
    as plain RS through their inner coder, sealing the codec's parities and
    the .vif as the JAX package does."""
    for name in ("mesh", "native"):
        with pytest.raises(ValueError, match=f"unknown erasure codec '{name}'"):
            coder_mod.codec_coder(name, 4, 2)
        with pytest.raises(ValueError, match=f"unknown erasure codec '{name}'"):
            ref_codec_coder(name, 4, 2)
    assert isinstance(coder_mod.get_coder("native", 4, 2),
                      coder_mod.ErasureCoder)
    assert not getattr(coder_mod, "_NOT_PORTED", ())
    assert coder_mod.registered_codecs() == ["msr", "piggyback", "rs"]
    assert coder_mod.repair_read_bytes("rs", 10, 4, [0, 3], 1000) == 10_000
    srcs = _make_jobs(tmp_path, [100, GEO.large_block * GEO.d + 5])
    for codec in ("piggyback", "msr"):
        port = coder_mod.codec_coder(codec, 4, 2, backend="torch", device="cpu")
        assert port.inner.device.type == "cpu"
        stats = {}
        stream.encode_volumes(_jobs(srcs, tmp_path, codec), GEO, port, batch=4,
                              stats=stats)
        assert stats["mode"] == "async" and stats["overlay_s"] > 0
        ref_stream.encode_volumes(_jobs(srcs, tmp_path, "ref" + codec), REF_GEO,
                                  ref_codec_coder(codec, 4, 2), batch=4)
        for i in range(len(srcs)):
            for ext in [files.shard_ext(s) for s in range(6)] + [".vif"]:
                assert (tmp_path / f"{codec}{i}{ext}").read_bytes() == \
                    (tmp_path / f"ref{codec}{i}{ext}").read_bytes(), (codec, i, ext)
