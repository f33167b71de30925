"""The port's needle-CRC scrub (seaweedfs_tpu_torch/storage/scrub.py) against
the JAX package's scrub_volume on the same volumes: the cases of
tests/test_scrub.py on device="cpu" (K3's plain version) and "off" (the host
loop), each result (scanned, corrupt ids, bytes_checked, error) equal to the
reference's; its refusal to choose a device on its own; and
ECPipeline.scrub's mismatch count against the JAX pipeline's."""

import struct

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models.ec_pipeline import ECPipeline as RefPipeline
from seaweedfs_tpu.storage import scrub as ref_scrub
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch.models.ec_pipeline import ECPipeline
from seaweedfs_tpu_torch.ops import crc_cuda
from seaweedfs_tpu_torch.storage import scrub
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

DEVICES = ["cpu", "off"]


def _fill(v: Volume, n: int = 50) -> dict:
    rng = np.random.default_rng(7)
    out = {}
    for i in range(1, n + 1):
        data = rng.integers(0, 256, int(rng.integers(1, 9000)),
                            dtype=np.uint8).tobytes()
        v.write_needle(Needle(id=i, cookie=1, data=data))
        out[i] = data
    return out


def _poke(v, off: int, data: bytes) -> None:
    with open(v.dat_path, "r+b") as f:
        f.seek(off)
        f.write(data)


def _flip(v, off: int) -> None:
    with open(v.dat_path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def _result(r):
    return r.scanned, r.corrupt, r.bytes_checked, r.error


def _against_reference(v: Volume, device: str):
    """Scrub with the port on `device`, then the reference (host loop and,
    for the batched path, its device path on the CPU) on the same files."""
    got = scrub.scrub_volume(v, device=device)
    v.sync()  # the reference opens the same .idx
    rv = ref_volume.Volume(v.dir, v.collection, v.id, create_if_missing=False)
    try:
        want = ref_scrub.scrub_volume(rv, device="off")
        assert _result(got) == _result(want)
        if device == "cpu":
            dev = ref_scrub.scrub_volume(rv, device="auto")
            assert (dev.mode, _result(dev)) == ("device", _result(got))
    finally:
        rv.close()
    assert got.mode == ("device" if device == "cpu" else "cpu")
    return got


@pytest.mark.parametrize("device", DEVICES)
def test_clean_volume_scans_all(tmp_path, device):
    v = Volume(str(tmp_path), "", 1)
    data = _fill(v, 60)
    res = _against_reference(v, device)
    assert res.scanned == 60 and res.corrupt == [] and res.error == ""
    assert res.bytes_checked == sum(len(d) for d in data.values())
    v.close()


@pytest.mark.parametrize("device", DEVICES)
def test_detects_flipped_bytes(tmp_path, device):
    v = Volume(str(tmp_path), "", 1)
    _fill(v, 20)
    _flip(v, v.nm.get(7).offset + 20)       # first data byte of needle 7
    _flip(v, v.nm.get(12).offset + 20 + 500)
    res = _against_reference(v, device)
    assert res.scanned == 20 and res.corrupt == [7, 12]
    v.close()


@pytest.mark.parametrize("device", DEVICES)
def test_detects_rotted_stored_crc(tmp_path, device):
    v = Volume(str(tmp_path), "", 1)
    _fill(v, 10)
    nv = v.nm.get(4)
    _flip(v, nv.offset + 16 + nv.size + 2)  # a byte of the stored crc
    assert _against_reference(v, device).corrupt == [4]
    v.close()


@pytest.mark.parametrize("device", DEVICES)
def test_tombstones_garbage_and_empty_needles_skipped(tmp_path, device):
    v = Volume(str(tmp_path), "", 1)
    v.write_needle(Needle(id=1, cookie=1, data=b"keep"))
    v.write_needle(Needle(id=2, cookie=1, data=b"gone"))
    v.write_needle(Needle(id=3, cookie=1, data=b""))  # zero-length
    v.write_needle(Needle(id=4, cookie=1, data=b"old version" * 20))
    old4 = v.nm.get(4).offset
    v.write_needle(Needle(id=4, cookie=1, data=b"new version"))
    v.delete_needle(2, cookie=1)
    _flip(v, old4 + 25)                      # rot in a garbage record
    v.sync()
    res = _against_reference(v, device)
    assert res.scanned == 3 and res.corrupt == [] and res.error == ""
    v.close()


@pytest.mark.parametrize("device", DEVICES)
def test_torn_walk_reported(tmp_path, device):
    """Header rot (a rotted size field) desyncs the record chain: the
    error reads as the reference's and the tail goes unscanned."""
    v = Volume(str(tmp_path), "", 1)
    _fill(v, 10)
    _poke(v, v.nm.get(5).offset + 12, struct.pack("<I", 0x0FFFFFFF))
    res = _against_reference(v, device)
    assert res.error.startswith("record walk torn at offset ")
    assert "trailing bytes unscanned (header rot or torn write)" in res.error
    assert res.scanned < 10
    v.close()


@pytest.mark.parametrize("device", DEVICES)
def test_rotted_length_field_reported_corrupt(tmp_path, device):
    v = Volume(str(tmp_path), "", 1)
    _fill(v, 8)
    _poke(v, v.nm.get(3).offset + 16, struct.pack("<I", 0x7FFFFFFF))
    res = _against_reference(v, device)
    assert res.corrupt == [3] and res.scanned == 8
    v.close()


@pytest.mark.parametrize("batch", [1, 3, 4096])
def test_batches_and_padding(tmp_path, batch):
    """Small batches, and one long needle padding its batch to 16 KiB."""
    v = Volume(str(tmp_path), "", 1)
    rng = np.random.default_rng(batch)
    for i in range(1, 13):
        n = 9000 if i == 6 else int(rng.integers(1, 700))
        v.write_needle(Needle(id=i, cookie=2, data=rng.bytes(n)))
    _flip(v, v.nm.get(6).offset + 20 + 8999)
    _flip(v, v.nm.get(11).offset + 20)
    stats = {}
    res = scrub.scrub_volume(v, device="cpu", batch=batch, stats=stats)
    off = scrub.scrub_volume(v, device="off", batch=batch)
    assert _result(res) == _result(off)
    assert res.corrupt == [6, 11]
    assert set(stats) == {"walk_s", "pack_s", "crc_s", "compare_s"}
    assert all(s >= 0 for s in stats.values())
    assert scrub._pad_pow2(0) == scrub._pad_pow2(512) == 512
    assert scrub._pad_pow2(513) == 1024 and scrub._pad_pow2(9000) == 16384
    v.close()


def test_devices_agree_and_needles_per_s(tmp_path):
    v = Volume(str(tmp_path), "", 1)
    _fill(v, 40)
    r_cpu = scrub.scrub_volume(v, device="off")
    r_dev = scrub.scrub_volume(v, device="cpu")
    assert _result(r_cpu) == _result(r_dev)
    assert r_dev.needles_per_s > 0 and r_dev.elapsed_s > 0
    v.close()


@pytest.mark.parametrize("device", ["auto", "on", "tpu", ""])
def test_no_implicit_device(tmp_path, device):
    v = Volume(str(tmp_path), "", 1)
    with pytest.raises(ValueError, match="'cuda', 'cpu', 'off'"):
        scrub.scrub_volume(v, device=device)
    v.close()


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = Volume(str(tmp_path), "", 1)
    _fill(v, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scrub.scrub_volume(v, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scrub.scrub_volume(v)  # the default is the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ECPipeline().scrub(np.zeros((1, 512), np.uint8), np.array([0]))
    v.close()


def test_k3_launch_failure_is_not_swallowed(tmp_path, monkeypatch):
    """A failure of K3 propagates out of the scrub; nothing falls back to
    the host loop."""
    def broken(blocks):
        raise RuntimeError("crc32c_states launch failed: CUDA error 700")
    monkeypatch.setattr(crc_cuda, "crc_states", broken)
    v = Volume(str(tmp_path), "", 1)
    _fill(v, 3)
    with pytest.raises(RuntimeError, match="launch failed"):
        scrub.scrub_volume(v, device="cpu")
    v.close()


def test_tiered_volume_refused(tmp_path):
    """The scrub refuses to read a tiered volume: skipped-tiered, nothing
    scanned, on every device (as the reference's scrub)."""
    v = Volume(str(tmp_path), "", 5)
    _fill(v, 3)
    v.close()
    (tmp_path / "5.vif").write_text(
        '{"remote": {"spec": "local:%s", "key": "5.dat"}}' % (tmp_path / "t"))
    v = Volume(str(tmp_path), "", 5)  # .dat kept local, tiered read-only
    for device in DEVICES + ["cuda"]:
        res = scrub.scrub_volume(v, device=device)
        assert (res.mode, res.scanned, res.corrupt) == ("skipped-tiered", 0, [])
    r = ref_volume.Volume(str(tmp_path), "", 5)
    assert ref_scrub.scrub_volume(r, device="off").mode == "skipped-tiered"
    r.close()
    v.close()


@pytest.mark.parametrize("width", [512, 768, 1024])
def test_pipeline_scrub_count_matches_jax(width):
    """ECPipeline.scrub's mismatch count (rows whose padding or length
    disagree with the needle) against the JAX pipeline on the CPU mesh."""
    rng = np.random.default_rng(width)
    rows = 16
    lengths = rng.integers(1, width, rows)
    blocks = np.zeros((rows, width), dtype=np.uint8)
    for i, n in enumerate(lengths):
        blocks[i, width - n:] = rng.integers(0, 256, n, dtype=np.uint8)
    for i in (1, 5, 9):
        blocks[i, width - lengths[i] - 1] = 7   # rot in the left pad
    lengths[3] -= 1                              # a length that disagrees
    want = RefPipeline().scrub(blocks, lengths)
    assert want == 4
    pipe = ECPipeline(device="cpu")  # a world of one, released below
    try:
        assert pipe.scrub(blocks, lengths) == want
    finally:
        pipe.close()
    np.testing.assert_array_equal(ECPipeline._expected(blocks, lengths),
                                  RefPipeline._expected(blocks, lengths))


def test_one_long_needle_pads_only_its_own_block(tmp_path, monkeypatch):
    """One 8 MiB needle among 4,096: the reference pads the whole batch to
    its width (a [4096, 8 MiB] block, 32 GiB: its shape is recorded and the
    allocation refused); the port groups the batch by padded width, so its
    largest block stays within scrub.BLOCK_BYTES, with verdicts equal to
    the reference's host loop."""
    v = Volume(str(tmp_path), "", 1)
    rng = np.random.default_rng(11)
    for i in range(1, 4096):
        v.write_needle(Needle(id=i, cookie=1, data=rng.integers(
            0, 256, int(rng.integers(1, 700)), dtype=np.uint8).tobytes()))
    v.write_needle(Needle(id=4096, cookie=1, data=rng.integers(
        0, 256, 8 << 20, dtype=np.uint8).tobytes()))
    _flip(v, v.nm.get(4096).offset + 20 + (5 << 20))
    _flip(v, v.nm.get(77).offset + 20)
    v.sync()

    shapes = []

    class _Np:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def zeros(shape, dtype=float):
            shapes.append(tuple(shape))
            raise MemoryError(f"refused a {shape} block")

    rv = ref_volume.Volume(v.dir, v.collection, v.id, create_if_missing=False)
    try:
        want = ref_scrub.scrub_volume(rv, device="off")
        monkeypatch.setattr(ref_scrub, "np", _Np())
        with pytest.raises(MemoryError):
            ref_scrub.scrub_volume(rv, device="auto")
    finally:
        monkeypatch.undo()
        rv.close()
    assert shapes == [(4096, 8 << 20)]  # 32 GiB of host memory

    blocks = []
    real = scrub._BatchCrc.crcs

    def crcs(self, block, lengths):
        blocks.append(block.shape)
        return real(self, block, lengths)

    monkeypatch.setattr(scrub._BatchCrc, "crcs", crcs)
    got = scrub.scrub_volume(v, device="cpu")
    assert _result(got) == _result(want) and got.corrupt == [77, 4096]
    assert max(r * w for r, w in blocks) <= scrub.BLOCK_BYTES
    assert (1, 8 << 20) in blocks and sum(r for r, _ in blocks) == 4096
    v.close()
