"""The port's geo repair fold (seaweedfs_tpu_torch/geo/repair_fold.py)
against the JAX package's (seaweedfs_tpu/geo/repair_fold.py): the per-helper
repair matrices probed from each package's own `repair_decode`, their
stacked relay matrix, the grouping of far helpers, and a folded msr rebuild
(ec/repair.rebuild_msr_single with relay groups combined by gf8.np_gf_apply)
byte-identical to the flat one."""

import os

import numpy as np
import pytest

from seaweedfs_tpu.geo import repair_fold as ref_fold
from seaweedfs_tpu_torch.ec import encoder, files, repair
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.geo import repair_fold
from seaweedfs_tpu_torch.ops import gf8
from seaweedfs_tpu_torch.ops.coder import codec_coder


@pytest.mark.parametrize("d,p,fs", [(4, 2, (0, 3, 5)), (5, 3, (0, 7)),
                                    (10, 4, (2, 13)), (14, 2, (5,))])
def test_helper_and_stacked_matrices_match_reference(d, p, fs):
    for f in fs:
        mats, ref = repair_fold.helper_matrices(d, p, f), ref_fold.helper_matrices(d, p, f)
        assert sorted(mats) == sorted(ref) == [s for s in range(d + p) if s != f]
        for sid in mats:
            np.testing.assert_array_equal(mats[sid], ref[sid])
            assert not mats[sid].flags.writeable
        sids = tuple(s for s in range(d + p) if s != f)[-(p + 1):]
        np.testing.assert_array_equal(repair_fold.stacked_matrix(d, p, f, sids),
                                      ref_fold.stacked_matrix(d, p, f, sids))


def test_helper_matrices_refuse_like_reference():
    for fn in (repair_fold.helper_matrices, ref_fold.helper_matrices):
        with pytest.raises(ValueError, match="q >= 2"):
            fn(4, 1, 0)
        with pytest.raises(ValueError, match="out of range"):
            fn(4, 2, 6)


def test_fold_groups_match_reference():
    dcs = {s: ("dc1" if s < 5 else "dc2" if s < 11 else "dc3" if s < 14 else "")
           for s in range(16)}
    for local, q in [("dc1", 2), ("dc2", 2), ("dc1", 4), ("", 2)]:
        assert repair_fold.fold_groups(dcs, local, q) == \
            ref_fold.fold_groups(dcs, local, q)
    assert repair_fold.fold_groups(dcs, "dc1", 2) == [
        ("dc2", (5, 6, 7, 8, 9, 10)), ("dc3", (11, 12, 13))]


def test_folded_rebuild_is_byte_identical_to_flat(tmp_path):
    d, p, f = 14, 2, 5
    geo = EcGeometry(d, p, 4096, 512)
    dat = tmp_path / "v.dat"
    dat.write_bytes(np.random.default_rng(4).integers(
        0, 256, 3 * 4096 * d + 999, dtype=np.uint8).tobytes())
    base = str(tmp_path / "v")
    coder = codec_coder("msr", d, p, backend="torch", device="cpu")
    encoder.encode_volume(str(dat), base, geo, coder)
    want = open(base + files.shard_ext(f), "rb").read()
    size = len(want)
    present = {s: base + files.shard_ext(s) for s in range(d + p) if s != f}
    groups = [(6, 7, 8, 9), (11, 12, 13, 14, 15)]
    rows = {}
    for mode in ("flat", "folded"):
        os.unlink(base + files.shard_ext(f))
        counter = repair.RepairCounter("msr")
        readers, frags, close = repair.make_readers(base, present, None, (), counter)

        def relay(sids):
            def fetch(ranges):
                stacked = np.concatenate(
                    [frags[s](ranges).reshape(len(ranges), -1) for s in sids])
                return gf8.np_gf_apply(
                    repair_fold.stacked_matrix(d, p, f, sids), stacked)
            return fetch
        folds = [(g, relay(g)) for g in groups] if mode == "folded" else ()
        try:
            repair.rebuild_msr_single(base, coder, f, readers, frags, size,
                                      counter, window=4096, folds=folds)
        finally:
            close()
        rows[mode] = open(base + files.shard_ext(f), "rb").read()
        assert counter.bytes_written == size
    assert rows["flat"] == rows["folded"] == want
