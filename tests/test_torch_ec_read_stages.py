"""The degraded EC read's stage timers (tracing.stage over
SeaweedFS_ec_degraded_read_seconds, SeaweedFS_ec_shard_fetch_seconds and
SeaweedFS_ec_shard_serve_seconds) on two port volume servers joined by
LocalPeers, RS(4,2) with device="cpu" coders: shards 1 and 2 on A, 3 and
4 on B, 0 and 5 lost, so every interval of shard 0 is rebuilt on A from
its two local survivors and two fetched from B. The counts move by what
was read, sampled or not; under a device capture the stages are ranges
of the exported Chrome trace; without one the profiler is never touched.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch import stats, tracing
from seaweedfs_tpu_torch.ec import files
from seaweedfs_tpu_torch.ec.locate import EcGeometry, locate
from seaweedfs_tpu_torch.server.volume_server import LocalPeers, VolumeServer
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle, record_size_from_header
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.utils import profiling, retry

VID = 7
GEO = dict(large_block=8192, small_block=1024)
HOLD = {"a": (1, 2), "b": (3, 4)}
LOST = (0, 5)
PHASES = ("gather", "stage", "wait")


class _Counted(LocalPeers):
    """LocalPeers that counts the shard reads it serves."""

    def __init__(self, servers):
        super().__init__(servers)
        self.reads = 0

    def read_shard(self, addr, vid, sid, offset, size):
        self.reads += 1
        return super().read_shard(addr, vid, sid, offset, size)


def _store(path):
    return Store("127.0.0.1", 0, "", [DiskLocation(str(path))],
                 ec_geometry=EcGeometry(4, 2, **GEO), coder_name="torch",
                 device="cpu")


@pytest.fixture
def pair(tmp_path):
    """(A, B, peers, needles): the EC volume spread over the two servers."""
    retry.reset_breakers()
    src = tmp_path / "src"
    src.mkdir()
    store = _store(src)
    rng = np.random.default_rng(24)
    want = {k: rng.bytes(int(rng.integers(500, 4000))) for k in range(1, 41)}
    store.add_volume(VID)
    for k, data in want.items():
        store.write_needle(VID, Needle(id=k, cookie=0x5EED, data=data))
    base = os.path.basename(store.generate_ec_shards(VID))
    store.delete_volume(VID)
    store.close()
    servers = {}
    for name, keep in HOLD.items():
        shutil.copytree(src, tmp_path / name)
        for s in range(6):
            if s not in keep:
                os.unlink(str(tmp_path / name / base) + files.shard_ext(s))
        st = _store(tmp_path / name)
        st.mount_ec_shards(VID)
        servers[f"{name}:1"] = VolumeServer(st)
    peers = _Counted(servers)
    a, b = servers["a:1"], servers["b:1"]
    try:
        yield a, b, peers, want
    finally:
        for vs in (a, b):
            vs._ec_read_pool.shutdown(wait=True)
            vs.store.close()
        retry.reset_breakers()


@pytest.fixture(autouse=True)
def _full_sampling():
    tracing.configure(sample=1.0)
    yield
    tracing.configure(sample=1.0)


def _counts() -> dict:
    out = {p: stats.EC_DEGRADED_READ_SECONDS.count(p) for p in PHASES}
    out["degraded"] = stats.DEGRADED_EC_READS.value()
    out["fetch"] = sum(stats.EC_SHARD_FETCH_SECONDS.count(role)
                       for role in ("survivor", "direct"))
    out["serve"] = stats.EC_SHARD_SERVE_SECONDS.count("range")
    return out


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items()}


def _intervals(a, lost):
    """{needle id: its intervals on the shards `lost`}."""
    ev = a.store.find_ec_volume(VID)
    out = {}
    for k in range(1, 41):
        off, size = ev.find_needle(k)
        ivs = locate(ev.geo, ev.dat_size, off, record_size_from_header(size))
        out[k] = [iv for iv in ivs if iv.shard_and_offset(ev.geo)[0] in lost]
    return out


@pytest.mark.parametrize("sample", [1.0, 0.0])
def test_each_degraded_interval_moves_every_stage_once(pair, sample):
    """Needle reads on A: gather, stage and wait each count one a degraded
    interval, as SeaweedFS_degraded_ec_reads_total does; every shard read
    A sends to B is one fetch on A and one range answer on B (healthy
    intervals of B's shards among them), however tracing samples."""
    a, b, peers, want = pair
    tracing.configure(sample=sample)
    lost = _intervals(a, LOST)
    expected = sum(len(v) for v in lost.values())
    assert expected > 0
    before, reads = _counts(), peers.reads
    reader = a._make_shard_reader(VID)
    for k, data in want.items():
        assert a.store.read_needle(VID, k, cookie=0x5EED,
                                   shard_reader=reader).data == data
    d = _delta(before)
    assert d["degraded"] == expected
    assert [d[p] for p in PHASES] == [expected] * 3
    assert d["fetch"] == d["serve"] == peers.reads - reads
    # each rebuilt interval fetched shards 3 and 4, and B's own intervals
    # were fetched whole
    on_b = sum(len(v) for v in _intervals(a, HOLD["b"]).values())
    assert d["fetch"] == 2 * expected + on_b


def test_one_rebuilt_interval_fetches_two_survivors(pair):
    """An interval of lost shard 0 read through A's shard reader: one
    observation of each phase, two fetches on A, two answers on B."""
    a, b, peers, _ = pair
    before = _counts()
    got = a._make_shard_reader(VID)(0, 0, 1024)
    assert len(got) == 1024
    assert _delta(before) == {"gather": 1, "stage": 1, "wait": 1,
                              "degraded": 1, "fetch": 2, "serve": 2}
    assert stats.EC_DEGRADED_READ_SECONDS.sum("gather") > 0


def test_stages_are_ranges_of_a_running_capture(pair, tmp_path):
    """Under a device capture (CPU activity here), one rebuilt interval
    leaves user_annotation ranges ec.gather, k1.stage and k1.wait in that
    order of start, and the fetches and answers of the pool threads as
    ec.fetch and ec.serve; the capture's flag is down after the stop."""
    a, _, _, _ = pair
    reader = a._make_shard_reader(VID)
    path = profiling.start_device_trace(out_dir=str(tmp_path))
    try:
        assert profiling.capturing
        reader(0, 1024, 1024)
    finally:
        profiling.stop_device_trace()
    assert not profiling.capturing
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((e["ts"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation")
    names = [n for _, n in ranges]
    assert [n for n in names if n in ("ec.gather", "k1.stage", "k1.wait")] \
        == ["ec.gather", "k1.stage", "k1.wait"]
    assert names.count("ec.fetch") == names.count("ec.serve") == 2


def test_no_capture_never_enters_the_profiler(pair, monkeypatch):
    a, _, _, want = pair

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a capture")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.capturing
    before = _counts()
    reader = a._make_shard_reader(VID)
    for k, data in want.items():
        assert a.store.read_needle(VID, k, cookie=0x5EED,
                                   shard_reader=reader).data == data
    assert _delta(before)["gather"] > 0


def test_stage_observes_a_failed_block_and_reraises():
    seen = []

    class Hist:
        def observe(self, *labels, value):
            seen.append((labels, value))

    with pytest.raises(KeyError):
        with tracing.stage("x", Hist(), "gather"):
            raise KeyError("boom")
    assert len(seen) == 1 and seen[0][0] == ("gather",) and seen[0][1] >= 0
