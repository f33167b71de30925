"""The benchmark's plain reference against the program, at a small size
on the CPU. Only this file imports both."""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.ec.volume import read_runs
from seaweedfs_tpu_torch.ops import crc32c as port_crc
from seaweedfs_tpu_torch.ops import gf8, rs_torch
from seaweedfs_tpu_torch.storage.needle import Needle
from weedbench.reference import crc32c, gf256, needles, stripes


@pytest.mark.parametrize("d,p", [(10, 4), (14, 2), (6, 3)])
def test_encode_matrix_is_the_programs(d, p):
    assert np.array_equal(gf256.encode_matrix(d, p), gf8.encode_matrix(d, p))


@pytest.mark.parametrize("d,p", [(10, 4), (14, 2)])
def test_parity_matches_the_plain_torch_kernel(d, p):
    rng = np.random.default_rng(d * 100 + p)
    data = rng.integers(0, 256, (d, 1000), dtype=np.uint8)
    par = gf256.parity(data, p)
    got = rs_torch.gf_apply(gf8.parity_matrix(d, p),
                            torch.from_numpy(data[None]))
    assert np.array_equal(par, got[0].numpy())


def test_crc32c_matches_the_programs():
    rng = np.random.default_rng(3)
    check = np.frombuffer(b"123456789", np.uint8)[None]
    assert crc32c.crc32c_rows(check).tolist() == [0xE3069283]
    rows = rng.integers(0, 256, (64, 1037), dtype=np.uint8)
    want = [port_crc.crc32c(r.tobytes()) for r in rows]
    assert crc32c.crc32c_rows(rows).tolist() == want


def test_stripe_runs_match_read_runs():
    rng = np.random.default_rng(5)
    for d, p, large, small in [(10, 4, 1 << 16, 1 << 10),
                               (14, 2, 1 << 20, 1 << 12)]:
        geo = stripes.Geometry(d, p, large, small)
        port = EcGeometry(d, p, large, small)
        for _ in range(200):
            size = int(rng.integers(1, 3 * d * large))
            off = int(rng.integers(0, size))
            n = int(rng.integers(1, 5 * small))
            want = [(r.shard_id, r.offset, r.size)
                    for r in read_runs(port, size, off, n)]
            assert stripes.runs(geo, size, off, n) == want
            assert geo.shard_size(size) == port.shard_file_size(size)
            first = stripes.first_shard(geo, size, [off])[0]
            assert first == want[0][0]


def test_record_layout_and_dat_walk(tmp_path):
    from seaweedfs_tpu_torch.storage.volume import Volume
    vols = needles.generate({"volumes": 1, "needles": 300,
                             "needle_bytes": 1024}, 2**40 + 7)
    v = Volume(str(tmp_path), "c", 1)
    try:
        offs = v.write_needles([Needle(id=i + 1, cookie=int(vols[0].cookies[i]),
                                       data=vols[0].needle(i))
                                for i in range(vols[0].n)])
        path = v.dat_path
    finally:
        v.close()
    assert offs == vols[0].offsets().tolist()
    assert os.path.getsize(path) == vols[0].dat_size()
    with open(path, "rb") as f:
        parsed = needles.parse_dat(f.read())
    assert parsed.ids.tolist() == list(range(1, 301))
    assert parsed.cookies.tolist() == vols[0].cookies.tolist()
    assert parsed.crcs.tolist() == [port_crc.crc32c(vols[0].needle(i))
                                    for i in range(300)]
    assert needles.record_size(1024) == len(
        Needle(id=1, cookie=1, data=b"x" * 1024).to_bytes(now_ns=1))


def test_same_seed_same_needles_and_every_seed_same_sizes():
    cfg = {"volumes": 2, "objects": 4, "object_bytes": 10 << 10,
           "chunk_bytes": 4 << 10}
    a, b = needles.generate(cfg, 2**33 + 1), needles.generate(cfg, 2**33 + 1)
    c = needles.generate(cfg, 12)
    assert [v.data for v in a] == [v.data for v in b]
    assert [v.data for v in a] != [v.data for v in c]
    assert [v.sizes.tolist() for v in a] == [v.sizes.tolist() for v in c]
    assert a[0].sizes.tolist() == [4096, 4096, 2048] * 2
