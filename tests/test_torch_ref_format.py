"""The port's reader of the Go reference's big-endian volume format
(seaweedfs_tpu_torch/storage/ref_format.py) against the JAX package's, on
seeded v2 and v3 Go volumes written field by field by chip_smoke.py's
writer (independent of both readers): tombstones in the .dat and .idx,
aligned records padded by a whole 8 bytes, CRCs stored raw and in the
scrambled `Value()` form, named, typed and dated needles. Both packages
parse them the same, `write_sorted_ecx` is byte-equal, and the port's
RS(14,2) shards of the Go .dat (its plain coder on the CPU) equal the JAX
package's NumpyCoder's. Exact comparisons; no tolerance applies."""

import dataclasses
import os
import struct

import numpy as np
import pytest

import chip_smoke
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.ops.coder import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu.storage import ref_format as ref_rf
from seaweedfs_tpu_torch.ec import encoder, files
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.ops.coder import TorchCoder
from seaweedfs_tpu_torch.ops.crc32c import crc32c
from seaweedfs_tpu_torch.storage import ref_format as rf


@pytest.fixture(scope="module", params=[2, 3])
def go_volume(request, tmp_path_factory):
    version = request.param
    base = str(tmp_path_factory.mktemp(f"go_v{version}") / "weed")
    want, deleted = chip_smoke.write_go_volume(np, base, 700, 23,
                                               seed=version, version=version)
    return version, base, want, deleted


def _fields(needles):
    return [dataclasses.asdict(n) for n in needles]


def test_walk_dat_equals_reference(go_volume):
    version, base, want, deleted = go_volume
    sb, recs = rf.walk_dat(base + ".dat")
    ref_sb, ref_recs = ref_rf.walk_dat(base + ".dat")
    assert dataclasses.asdict(sb) == dataclasses.asdict(ref_sb)
    assert _fields(recs) == _fields(ref_recs)
    assert sb.version == version and sb.block_size == 8
    live = [r for r in recs if not r.is_tombstone]
    assert len(recs) == 723 and len(live) == 700
    assert all(r.crc_ok for r in live)
    assert {r.id: (r.cookie, r.data) for r in live} == want
    assert sorted(r.id for r in recs if r.is_tombstone) == sorted(deleted)


def test_the_volume_holds_every_case(go_volume):
    version, base, *_ = go_volume
    _, recs = rf.walk_dat(base + ".dat")
    live = [r for r in recs if not r.is_tombstone]
    scrambled = [r for r in live if r.checksum != crc32c(r.data)]
    assert scrambled and all(r.checksum == rf.crc32c_scrambled(crc32c(r.data))
                             for r in scrambled)
    assert any(rf.padding_length(r.size, version) == 8 for r in live)
    assert any(r.name for r in live) and any(r.mime for r in live)
    assert any(r.last_modified for r in live)
    if version == 3:
        assert all(r.append_at_ns for r in live)


def test_read_idx_and_sorted_ecx_equal_reference(go_volume, tmp_path):
    _, base, want, deleted = go_volume
    entries = rf.read_idx(base + ".idx")
    assert entries == ref_rf.read_idx(base + ".idx")
    assert sum(e[2] == rf.TOMBSTONE for e in entries) == len(deleted)
    ours, theirs = str(tmp_path / "ours.ecx"), str(tmp_path / "theirs.ecx")
    assert rf.write_sorted_ecx(base + ".idx", ours) == \
        ref_rf.write_sorted_ecx(base + ".idx", theirs) == len(entries)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        got = a.read()
        assert got == b.read()
    keys = [struct.unpack_from(">Q", got, i)[0] for i in range(0, len(got), 16)]
    assert keys == sorted(keys)


def test_parse_needle_at_every_offset_equals_reference(go_volume):
    version, base, *_ = go_volume
    with open(base + ".dat", "rb") as f:
        buf = f.read()
    for key, off, size in rf.read_idx(base + ".idx")[::7]:
        got = rf.parse_needle(buf, off * 8, version)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            ref_rf.parse_needle(buf, off * 8, version))
        assert got.id == key


@pytest.mark.parametrize("version", [1, 2, 3])
def test_sizes_and_super_block_equal_reference(version):
    for size in list(range(0, 70)) + [1024, 1087, 0xFFFF]:
        assert rf.record_size(size, version) == \
            ref_rf.record_size(size, version)
        assert rf.padding_length(size, version) == \
            ref_rf.padding_length(size, version)
        assert rf.record_size(size, version) % 8 == 0
    for extra in (0, 16):
        raw = bytes([version, 1, 2, 3]) + struct.pack(">HH", 7, extra)
        assert dataclasses.asdict(rf.parse_super_block(raw)) == \
            dataclasses.asdict(ref_rf.parse_super_block(raw))
    with pytest.raises(ValueError):
        rf.parse_super_block(b"\x03")
    for raw in (0, 1, 0xE3069283, 0xFFFFFFFF):
        assert rf.crc32c_scrambled(raw) == ref_rf.crc32c_scrambled(raw)


def test_a_damaged_crc_is_caught_like_reference(go_volume, tmp_path):
    version, base, *_ = go_volume
    with open(base + ".dat", "rb") as f:
        buf = bytearray(f.read())
    key, off, size = rf.read_idx(base + ".idx")[5]
    buf[off * 8 + 16 + 4 + 10] ^= 0x40  # a data byte of needle `key`
    got = rf.parse_needle(bytes(buf), off * 8, version)
    assert not got.crc_ok and got.crc_ok == \
        ref_rf.parse_needle(bytes(buf), off * 8, version).crc_ok


def test_rs14_2_shards_of_the_go_dat_equal_reference(go_volume, tmp_path):
    _, base, *_ = go_volume
    geo = EcGeometry(14, 2, large_block=65536, small_block=4096)
    ref_geo = RefGeometry(14, 2, large_block=65536, small_block=4096)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    encoder.encode_volume(base + ".dat", ours, geo,
                          TorchCoder(14, 2, device="cpu"))
    ref_encoder.encode_volume(base + ".dat", theirs, ref_geo,
                              RefNumpyCoder(14, 2))
    for s in range(16):
        with open(ours + files.shard_ext(s), "rb") as a, \
                open(theirs + files.shard_ext(s), "rb") as b:
            assert a.read() == b.read(), s
    assert files.read_vif(ours + ".vif")["dat_size"] == \
        os.path.getsize(base + ".dat")
