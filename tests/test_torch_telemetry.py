"""The port's telemetry slice (seaweedfs_tpu_torch/telemetry/: the
space-saving sketch and the volume server's hot-key recording) against the
JAX package's on seeded streams, and a port volume server read by the JAX
package's fleet collector: its `top_k()` lists the port server's hot volume
and its `merged_profile()` holds the port server's sampler summary. Every
comparison is exact; no tolerance applies."""

import time

import numpy as np
import pytest
import requests

from conftest import free_port_pair
from seaweedfs_tpu.telemetry import TelemetryCollector
from seaweedfs_tpu.telemetry import hot as ref_hot
from seaweedfs_tpu.telemetry.topk import SpaceSaving as RefSpaceSaving
from seaweedfs_tpu_torch import profiling, stats, telemetry
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import file_id
from seaweedfs_tpu_torch.telemetry import SpaceSaving, hot


def _zipf_stream(seed, n, keys, weighted):
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.3, n) % keys
    amounts = rng.integers(1, 5000, n) if weighted else np.ones(n, int)
    return [(f"k{int(r)}", float(a)) for r, a in zip(ranks, amounts)]


@pytest.mark.parametrize("seed,capacity,weighted", [
    (0, 4, False), (1, 8, False), (2, 32, True), (3, 1, True), (4, 16, True),
])
def test_space_saving_equals_reference(seed, capacity, weighted):
    ours, theirs = SpaceSaving(capacity), RefSpaceSaving(capacity)
    stream = _zipf_stream(seed, 5000, 300, weighted)
    for key, amount in stream:
        ours.offer(key, amount)
        theirs.offer(key, amount)
    assert ours.items() == theirs.items()
    assert ours.items(limit=3) == theirs.items(limit=3)
    assert (ours.total, len(ours)) == (theirs.total, len(theirs))
    # the sketch's guarantees: count - error <= true <= count, and every
    # key heavier than N/k tracked
    true: dict = {}
    for key, amount in stream:
        true[key] = true.get(key, 0.0) + amount
    tracked = {it["key"]: it for it in ours.items()}
    for key, it in tracked.items():
        assert it["count"] - it["error"] <= true[key] <= it["count"]
    for key, w in true.items():
        if w > ours.total / capacity:
            assert key in tracked


def test_space_saving_edges_like_reference():
    for cls in (SpaceSaving, RefSpaceSaving):
        with pytest.raises(ValueError):
            cls(0)
    ours, theirs = SpaceSaving(2), RefSpaceSaving(2)
    for sk in (ours, theirs):
        sk.offer("a", 0)
        sk.offer("a", -1)  # non-positive offers are ignored
        sk.offer("b", 2.5)
    assert ours.items() == theirs.items() and ours.total == theirs.total == 2.5
    ours.clear()
    assert ours.items() == [] and ours.total == 0.0


def test_hot_keys_record_and_snapshot_equal_reference():
    ours, theirs = hot.HotKeys(capacity=4), ref_hot.HotKeys(capacity=4)
    rng = np.random.default_rng(7)
    for _ in range(2000):
        vid = int(rng.integers(1, 9))
        kw = dict(volume=str(vid) if vid != 8 else None,
                  tenant=("" if vid == 3 else f"t{vid % 3}"),
                  method=("get", "post", "bulk")[vid % 3],
                  nbytes=int(rng.integers(0, 4096)))
        ours.record(**kw)
        theirs.record(**kw)
    assert ours.snapshot(limit=10) == theirs.snapshot(limit=10)
    assert ours.snapshot(limit=2) == theirs.snapshot(limit=2)


def test_hot_gauges_mirror_the_sketches():
    sketches = hot.HOT  # the process's sketches, behind the scrape hook
    sketches.clear()
    hot.record(volume="12", tenant="pics", method="get", nbytes=100)
    hot.record(volume="12", method="get", nbytes=50)
    hot.record(volume=None, method="post")
    sketches.refresh_gauges()
    assert stats.HOT_REQUESTS.value("volume", "12") == 2.0
    assert stats.HOT_BYTES.value("volume", "12") == 150.0
    assert stats.HOT_REQUESTS.value("method", "post") == 1.0
    # the scrape hook refreshes them on every /metrics render
    hot.record(volume="12", method="get")
    body, _ = stats.scrape_payload("")
    assert 'SeaweedFS_hot_requests{kind="volume",key="12"} 3' in body


def test_hot_record_never_raises(monkeypatch):
    class Broken:
        def record(self, **kw):
            raise RuntimeError("boom")
    monkeypatch.setattr(hot, "HOT", Broken())
    hot.record(volume="1")


def test_telemetry_package_exports_only_its_slice():
    assert telemetry.__all__ == ["SpaceSaving", "hot"]
    for name in ("TelemetryCollector", "RingTSDB", "SloEngine",
                 "merge_buckets"):
        assert not hasattr(telemetry, name)


def test_jax_collector_reads_a_port_volume_server(tmp_path, monkeypatch):
    """The JAX package's TelemetryCollector scrapes a port volume server:
    its /metrics hot gauges merge into top_k() and its
    /debug/profile?mode=summary into merged_profile()."""
    hot.HOT.clear()
    # a sampler of this test's own, at a rate of its own
    monkeypatch.setattr(profiling.sampler, "_default", None)
    monkeypatch.setattr(profiling.sampler, "_refs", 0)
    monkeypatch.setenv("SWTPU_PROFILE_HZ", "97")
    vid = 41
    store = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "v"))],
                  coder_name="torch", device="cpu")
    port = free_port_pair()
    store.port, store.public_url = port, f"127.0.0.1:{port}"
    vs = VolumeServer(store, "127.0.0.1", port)
    vs.start()
    collector = TelemetryCollector(
        "master", lambda: [{"node": "port-volume",
                            "url": f"http://{vs.url}/metrics"}],
        interval_s=0)
    try:
        vs.allocate_volume(vid)
        http = requests.Session()
        for i in range(1, 6):
            fid = file_id(vid, i, 0x1234 + i)
            assert http.post(f"http://{vs.url}/{fid}", data=b"x" * 300,
                             timeout=10).status_code == 201
            for _ in range(4):
                assert http.get(f"http://{vs.url}/{fid}",
                                timeout=10).status_code == 200
        deadline = time.monotonic() + 10
        while vs._sampler.summary()["samples"] == 0:
            assert time.monotonic() < deadline, "the sampler took no sample"
            time.sleep(0.02)
        collector._cycle()
        top = collector.top_k()
        vols = {it["key"]: it["count"] for it in top["requests"]["volume"]}
        assert vols.get(str(vid)) == 25.0  # 5 POSTs + 20 GETs
        methods = {it["key"] for it in top["requests"]["method"]}
        assert {"get", "post"} <= methods
        assert {it["key"] for it in top["bytes"]["volume"]} == {str(vid)}
        merged = collector.merged_profile()
        assert merged["nodes"]["port-volume"]["samples"] > 0
        assert merged["nodes"]["port-volume"]["hz"] == 97.0
        assert merged["samples"] == sum(
            c["on_cpu"] + c["waiting"] for c in merged["classes"].values())
        assert "event_loop" in merged["classes"]
    finally:
        collector.stop()
        vs.stop()
