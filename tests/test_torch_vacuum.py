"""The port's vacuum (seaweedfs_tpu_torch/storage/vacuum.py) and the tail
readers of its Volume against the JAX package's on the same volume, byte for
byte: compact + commit_compact give the same .dat and .idx, the diff replay
of writes and deletes that land between the two calls, no read-cache entry
outliving the commit, and read_records_since / offset_by_append_ns /
last_record_append_ns / append_records. Every needle's append_at_ns comes
from one seeded clock, so both packages write the same bytes."""

import itertools
import os
import shutil
import types

import numpy as np
import pytest

from seaweedfs_tpu.storage import needle as ref_needle_mod
from seaweedfs_tpu.storage import vacuum as ref_vacuum
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.storage.needle import Needle as RefNeedle
from seaweedfs_tpu_torch.storage import needle as needle_mod
from seaweedfs_tpu_torch.storage import read_cache, vacuum, volume
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE

VID = 4
T0 = 1_700_000_000_000_000_000

PORT = (volume.Volume, Needle, vacuum)
REF = (ref_volume.Volume, RefNeedle, ref_vacuum)


@pytest.fixture
def clock(monkeypatch):
    """Both packages' needle clocks on one counter; `reset()` rewinds it so
    each package replays the same timestamps."""
    state = {}

    def reset():
        state["it"] = itertools.count(T0, 1000)
    reset()
    fake = types.SimpleNamespace(time_ns=lambda: next(state["it"]))
    monkeypatch.setattr(needle_mod, "time", fake)
    monkeypatch.setattr(ref_needle_mod, "time", fake)
    return reset


def _payload(rng):
    return rng.bytes(int(rng.integers(0, 4000)))


def _seed_volume(dirname, n=60, seed=3):
    """n needles written by the port; the files are copied for the other
    package by the caller."""
    rng = np.random.default_rng(seed)
    os.makedirs(dirname, exist_ok=True)
    v = volume.Volume(str(dirname), "", VID)
    for i in range(1, n + 1):
        v.write_needle(Needle(id=i, cookie=i, data=_payload(rng)))
    v.sync()
    v.close()


def _twin(tmp_path):
    _seed_volume(tmp_path / "port")
    (tmp_path / "ref").mkdir()
    for ext in (".dat", ".idx"):
        shutil.copy(tmp_path / "port" / f"{VID}{ext}", tmp_path / "ref" / f"{VID}{ext}")
    return {PORT: str(tmp_path / "port"), REF: str(tmp_path / "ref")}


def _churn(v, N, kind, rng):
    if kind in ("deletes", "mixed"):
        for i in range(3, 60, 4):
            v.delete_needle(i, i)
    if kind in ("overwrites", "mixed"):
        for i in range(2, 60, 5):
            v.write_needle(N(id=i, cookie=i, data=_payload(rng)))
    if kind == "all-deleted":
        for i in range(1, 61):
            v.delete_needle(i, i)


def _files(d):
    return [open(os.path.join(d, f"{VID}{ext}"), "rb").read() for ext in (".dat", ".idx")]


@pytest.mark.parametrize("kind", ["clean", "deletes", "overwrites", "mixed", "all-deleted"])
def test_compact_and_commit_match_reference(tmp_path, clock, kind):
    dirs = _twin(tmp_path)
    out = {}
    for pkg, d in dirs.items():
        V, N, vac = pkg
        clock()
        v = V(d, "", VID)
        _churn(v, N, kind, np.random.default_rng(9))
        garbage = v.garbage_ratio()
        live, reclaimed = vac.compact(v)
        nv = vac.commit_compact(v)
        out[pkg] = (live, reclaimed, garbage, nv.garbage_ratio(), nv.file_count,
                    nv.content_size, nv.super_block.compaction_revision,
                    {i: nv.read_needle(i).data for i in range(1, 61)
                     if nv.nm.get(i) is not None}, _files(d))
        nv.close()
    assert out[PORT] == out[REF]
    live, reclaimed, garbage, after, count = out[PORT][:5]
    assert after == 0.0 and count == live and out[PORT][6] == 1
    assert (reclaimed > 0) == (kind != "clean") and (garbage > 0) == (kind != "clean")


def test_diff_replay_of_writes_and_deletes_between_compact_and_commit(tmp_path, clock):
    dirs = _twin(tmp_path)
    out = {}
    for pkg, d in dirs.items():
        V, N, vac = pkg
        clock()
        v = V(d, "", VID)
        v.delete_needle(7, 7)
        vac.compact(v)
        # land after the snapshot: replayed by the commit
        v.write_needle(N(id=100, cookie=1, data=b"new" * 300))
        v.write_needle(N(id=8, cookie=8, data=b"over"))
        v.delete_needle(9, 9)
        v.delete_needle(100, 1)
        v.write_needle(N(id=101, cookie=2, data=b""))
        with v._lock:
            replayed = vac._makeup_diff(v, v.file_name() + ".cpd.probe", v.file_name() + ".cpx.probe")
        nv = vac.commit_compact(v)
        reads = {}
        for i in (7, 8, 9, 10, 100, 101):
            try:
                reads[i] = nv.read_needle(i).data
            except KeyError:
                reads[i] = None
        out[pkg] = (replayed, reads, nv.file_count, _files(d))
        for ext in (".cpd.probe", ".cpx.probe"):
            os.unlink(nv.file_name() + ext)
        nv.close()
    assert out[PORT] == out[REF]
    replayed, reads = out[PORT][:2]
    assert replayed == 5
    assert reads == {7: None, 8: b"over", 9: None, 10: reads[10], 100: None, 101: b""}
    assert reads[10] is not None


def test_commit_without_compact_raises(tmp_path):
    _seed_volume(tmp_path)
    v = volume.Volume(str(tmp_path), "", VID)
    with pytest.raises(FileNotFoundError, match="run compact"):
        vacuum.commit_compact(v)
    v.close()


def test_no_stale_read_cache_hit_after_commit(tmp_path):
    _seed_volume(tmp_path)
    cache = read_cache.ReadCache(1 << 20)
    v = volume.Volume(str(tmp_path), "", VID)
    for i in range(1, 11):
        assert cache.put(VID, i, v.read_needle(i), epoch=cache.epoch(VID))
    v.delete_needle(1, 1)
    vacuum.compact(v)
    stale_epoch = cache.epoch(VID)
    stale = v.read_needle(2)  # a fill that read before the swap
    nv = vacuum.commit_compact(v)
    try:
        assert len(cache) == 0 and all(cache.get(VID, i) is None for i in range(1, 11))
        assert not cache.put(VID, 2, stale, epoch=stale_epoch)  # raced the swap
        assert cache.put(VID, 2, nv.read_needle(2), epoch=cache.epoch(VID))
        assert cache.get(VID, 2).data == nv.read_needle(2).data
        assert nv.nm.get(2).offset < v.nm.get(2).offset  # the needle moved
    finally:
        nv.close()


def test_tail_readers_match_reference(tmp_path, clock):
    dirs = _twin(tmp_path)
    out = {}
    for pkg, d in dirs.items():
        V, N, vac = pkg
        clock()
        v = V(d, "", VID)
        _churn(v, N, "mixed", np.random.default_rng(4))
        first = v.record_append_ns(SUPER_BLOCK_SIZE, v.nm.get(1).size)
        last = v.last_record_append_ns()
        marks = [0, first, first + 1, T0 + 1000 * 30 + 5, last - 1, last, last + 1]
        offsets = [v.offset_by_append_ns(t) for t in marks]
        batches = [list(v.read_records_since(t, max_batch=4096)) for t in marks[:4]]
        raw = b"".join(rec for rec, _, _ in v.read_records_since(first + 1))
        # replay the tail into a fresh follower volume, then a torn tail
        os.makedirs(os.path.join(d, "follower"))
        f = V(os.path.join(d, "follower"), "", VID)
        applied = f.append_records(raw)
        torn = f.append_records(raw[:100])
        f.sync()
        follower = (applied, torn, f.content_size, f.file_count, f.last_append_at_ns,
                    _files(os.path.join(d, "follower")))
        f.close()
        # the probes of the whole .idx and of a cut end (the port's are
        # computed in one numpy pass)
        probes = [v._probe_entries(end) for end in
                  (v._append_offset, v._append_offset // 2, SUPER_BLOCK_SIZE)]
        out[pkg] = (first, last, offsets, batches, follower, probes)
        v.close()
    assert out[PORT] == out[REF]
    first, last, offsets, batches, follower, probes = out[PORT]
    assert len(probes[0]) > len(probes[1]) > 0 and probes[2] == []
    assert offsets[0] == SUPER_BLOCK_SIZE and offsets[-1] == offsets[-2] > offsets[0]
    assert len(batches[0]) > len(batches[2]) > 0 and follower[1] == 0


def test_tail_readers_after_a_compaction(tmp_path, clock):
    """Compaction copies in offset (append) order, so the tail search finds
    the same live records after it; the tombstones are gone."""
    _seed_volume(tmp_path)
    v = volume.Volume(str(tmp_path), "", VID)
    v.delete_needle(5, 5)
    mid = v.record_append_ns(v.nm.get(30).offset, v.nm.get(30).size)
    want = [(rec, ns) for rec, ns, nsize in v.read_records_since(mid)
            if not t.is_tombstone(nsize)]
    vacuum.compact(v)
    nv = vacuum.commit_compact(v)
    try:
        got = [(rec, ns) for rec, ns, _ in nv.read_records_since(mid)]
        assert got == want and len(got) == 30
        assert nv.last_record_append_ns() == got[-1][1]
    finally:
        nv.close()
