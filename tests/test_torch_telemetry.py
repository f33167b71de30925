"""The port's telemetry (seaweedfs_tpu_torch/telemetry/) against the JAX
package's on seeded inputs: the space-saving sketch and the volume
server's hot-key recording; the fleet half -- the ring TSDB's window
deltas across counter resets, the histogram merge, quantiles and
summaries, the SLO engine's burn rates and decisions, and a whole
collector's snapshots cycle by cycle under one injected clock; and a port
volume server read by the JAX package's fleet collector: its `top_k()`
lists the port server's hot volume and its `merged_profile()` holds the
port server's sampler summary. Integer counts and decisions are compared
exactly, floating quantiles and burn rates to 1e-12 relative."""

import math
import time

import numpy as np
import pytest
import requests

from conftest import free_port_pair
from seaweedfs_tpu.telemetry import TelemetryCollector
from seaweedfs_tpu.telemetry import collector as ref_collector
from seaweedfs_tpu.telemetry import merge as ref_merge
from seaweedfs_tpu.telemetry import slo as ref_slo
from seaweedfs_tpu.telemetry import tsdb as ref_tsdb
from seaweedfs_tpu.telemetry import hot as ref_hot
from seaweedfs_tpu.telemetry.topk import SpaceSaving as RefSpaceSaving
from seaweedfs_tpu_torch import profiling, stats, telemetry
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import file_id
from seaweedfs_tpu_torch.telemetry import SpaceSaving, hot
from seaweedfs_tpu_torch.telemetry import collector as port_collector
from seaweedfs_tpu_torch.telemetry import merge as port_merge
from seaweedfs_tpu_torch.telemetry import slo as port_slo
from seaweedfs_tpu_torch.telemetry import tsdb as port_tsdb


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
    """The package exports the reference's names, each the port's own,
    and `hot`, which the volume server records into."""
    import seaweedfs_tpu.telemetry as ref_telemetry
    assert telemetry.__all__ == ref_telemetry.__all__ + ["hot"]
    for name in ref_telemetry.__all__:
        assert getattr(telemetry, name).__module__.startswith(
            "seaweedfs_tpu_torch.telemetry.")


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


# -- the fleet half: tsdb, merge, slo, collector ------------------------------

def _close(a, b) -> bool:
    """Equal structures, floats to 1e-12 relative (NaN equal to NaN)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_close(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_close(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) or isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0) or a == b
    return a == b


BOUNDS = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
          0.25, 0.5, 1.0, math.inf)


def _series(rng, n, reset_every):
    """n (ts, value) points of a counter that restarts now and then."""
    ts, v, out = 0.0, 0.0, []
    for i in range(n):
        ts += float(rng.uniform(0.5, 3.0))
        v = (float(rng.integers(0, 5)) if reset_every and i
             and i % reset_every == 0 else v + float(rng.integers(0, 50)))
        out.append((ts, v))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tsdb_window_deltas_equal_reference(seed):
    rng = np.random.default_rng(seed)
    dbs = (port_tsdb.RingTSDB(max_points=int(rng.integers(8, 40))),)
    dbs += (ref_tsdb.RingTSDB(max_points=dbs[0].max_points),)
    end = 0.0
    for node in ("n1", "n2", "n3"):
        for tenant in ("a", "b"):
            lb = (("outcome", "ok"), ("tenant", tenant))
            for ts, v in _series(rng, 60, int(rng.integers(0, 15))):
                for db in dbs:
                    db.add(node, "q_total", lb, ts, v)
                end = max(end, ts)
        for le in BOUNDS:
            lb = (("le", "+Inf" if le == math.inf else repr(le)),
                  ("type", "get"))
            for ts, v in _series(rng, 30, 0):
                for db in dbs:
                    db.add(node, "h_seconds_bucket", lb, ts, v)
    for db in dbs:
        db.mark_stale("n3")
    for now in np.linspace(end / 4, end + 5, 9):
        for window in (2.0, 10.0, 45.0, 400.0):
            got = [(db.window_delta("n1", "q_total",
                                    (("outcome", "ok"), ("tenant", "a")),
                                    window, now),
                    db.sum_window_delta("q_total", window, now),
                    db.sum_window_delta("q_total", window, now,
                                        include_stale=True),
                    db.sum_window_delta("q_total", window, now,
                                        label_filter={"tenant": "b"}),
                    db.grouped_window_delta("q_total", "tenant", window,
                                            now),
                    db.histogram_window("h_seconds", window, now))
                   for db in dbs]
            assert got[0] == got[1], (now, window)


def _cum(rng, n):
    obs = rng.exponential(float(rng.uniform(0.001, 0.2)), n)
    return [(le, float((obs <= le).sum())) for le in BOUNDS]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_merge_quantiles_and_summaries_equal_reference(seed):
    rng = np.random.default_rng(seed)
    nodes = [_cum(rng, int(rng.integers(0, 500)))
             for _ in range(int(rng.integers(1, 6)))]
    merged = port_merge.merge_buckets(nodes)
    assert merged == ref_merge.merge_buckets(nodes)
    for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert _close(port_merge.quantile(merged, q),
                      ref_merge.quantile(merged, q))
    for thr in (0.0001, 0.003, 0.01, 0.2, 5.0):
        assert _close(port_merge.fraction_at_most(merged, thr),
                      ref_merge.fraction_at_most(merged, thr))
    sum_ = float(rng.uniform(0, 10))
    assert _close(port_merge.summarize(merged, sum_=sum_),
                  ref_merge.summarize(merged, sum_=sum_))
    with pytest.raises(ValueError, match="boundaries differ"):
        port_merge.merge_buckets([[(0.1, 1.0), (math.inf, 2.0)],
                                  [(0.2, 1.0), (math.inf, 2.0)]])


SLO_DOC = {
    "slos": [
        {"name": "get-latency", "kind": "latency", "verb": "get",
         "threshold_s": 0.005, "objective": 0.9},
        {"name": "avail", "kind": "availability", "objective": 0.99},
        {"name": "tenant-a", "kind": "availability", "tenant": "a",
         "class": "interactive", "objective": 0.95},
    ],
    "windows": [{"name": "fast", "long_s": 16, "short_s": 4, "burn": 3},
                {"name": "slow", "long_s": 60, "short_s": 10, "burn": 1.5}],
}


def _feed(rng, dbs, ts, state, slow_share, shed_share):
    """One scrape's worth of counters into both TSDBs."""
    n = int(rng.integers(20, 200))
    slow = int(n * slow_share)
    state["fast"] += n - slow
    state["slow"] += slow
    for tenant in ("a", "b"):
        shed = int(rng.binomial(n, shed_share))
        state[f"ok_{tenant}"] += n - shed
        state[f"shed_{tenant}"] += shed
    for db in dbs:
        for le in BOUNDS:
            lb = (("le", "+Inf" if le == math.inf else repr(le)),
                  ("type", "get"))
            db.add("v1", "SeaweedFS_volumeServer_request_seconds_bucket",
                   lb, ts, float(state["fast"] + (state["slow"]
                                                   if le > 0.01 else 0)))
        for tenant in ("a", "b"):
            for outcome in ("ok", "shed"):
                lb = (("class", "interactive"), ("outcome", outcome),
                      ("tenant", tenant))
                db.add("v1", "SeaweedFS_qos_requests_total", lb, ts,
                       float(state[f"{outcome}_{tenant}"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_engine_burn_decisions_equal_reference(seed):
    """Both engines over equal TSDB contents, through a healthy spell, a
    slow and shedding spell and a recovery: equal payloads each step
    (burn rates to 1e-12), the same burning sets, health items and
    slo.burn / slo.ok transitions."""
    from seaweedfs_tpu.ops import events as ref_events
    from seaweedfs_tpu_torch.ops import events as port_events
    rng = np.random.default_rng(seed)
    dbs = (port_tsdb.RingTSDB(max_points=128),
           ref_tsdb.RingTSDB(max_points=128))
    engines = (port_slo.SloEngine(port_slo.parse_slo_policy(SLO_DOC),
                                  dbs[0]),
               ref_slo.SloEngine(ref_slo.parse_slo_policy(SLO_DOC), dbs[1]))
    seqs = (port_events.JOURNAL.last_seq, ref_events.JOURNAL.last_seq)
    state = dict.fromkeys(("fast", "slow", "ok_a", "shed_a", "ok_b",
                           "shed_b"), 0)
    ts, burned = 0.0, set()
    for step in range(60):
        ts += float(rng.uniform(1.5, 2.5))
        bad = 20 <= step < 38
        _feed(rng, dbs, ts, state, 0.6 if bad else 0.02,
              0.2 if bad else 0.001)
        out = [e.evaluate(ts) for e in engines]
        assert _close(out[0], out[1]), step
        assert engines[0].health_items() == engines[1].health_items()
        burned |= set(out[0]["burning"])
    assert burned == {"get-latency", "avail", "tenant-a"}
    assert out[0]["burning"] == []
    kinds = [[(e["type"], e["attrs"]["slo"])
              for e in j.JOURNAL.snapshot(since=seq) if e["type"] in
              ("slo.burn", "slo.ok")]
             for j, seq in zip((port_events, ref_events), seqs)]
    assert kinds[0] == kinds[1]
    assert set(kinds[0]) == {(t, n) for t in ("slo.burn", "slo.ok")
                             for n in burned}


def _exposition(rng, state) -> str:
    """A node's /metrics text: the GET latency histogram, the QoS
    counter and the hot-key gauges, advanced by a seeded step."""
    lines = ["# HELP SeaweedFS_volumeServer_request_seconds h",
             "# TYPE SeaweedFS_volumeServer_request_seconds histogram"]
    n = int(rng.integers(10, 100))
    obs = rng.exponential(0.004, n)
    for i, le in enumerate(BOUNDS):
        state["h"][i] += float((obs <= le).sum())
    state["sum"] += float(obs.sum())
    for i, le in enumerate(BOUNDS):
        tag = "+Inf" if le == math.inf else repr(le)
        lines.append('SeaweedFS_volumeServer_request_seconds_bucket'
                     f'{{type="get",le="{tag}"}} {state["h"][i]:g}')
    lines.append('SeaweedFS_volumeServer_request_seconds_sum{type="get"} '
                 f'{state["sum"]!r}')
    lines.append('SeaweedFS_volumeServer_request_seconds_count{type="get"} '
                 f'{state["h"][-1]:g}')
    lines += ["# HELP SeaweedFS_qos_requests_total q",
              "# TYPE SeaweedFS_qos_requests_total counter"]
    for outcome in ("ok", "shed"):
        state[outcome] += int(rng.integers(0, 40 if outcome == "ok" else 3))
        lines.append('SeaweedFS_qos_requests_total{tenant="a",'
                     f'class="interactive",outcome="{outcome}"}} '
                     f'{state[outcome]}')
    lines += ["# HELP SeaweedFS_hot_requests r",
              "# TYPE SeaweedFS_hot_requests gauge"]
    for vid in range(1, 6):
        state[vid] += int(rng.integers(0, 10 * vid))
        lines.append(f'SeaweedFS_hot_requests{{kind="volume",key="{vid}"}} '
                     f'{state[vid]}')
    return "\n".join(lines) + "\n"


def test_collector_snapshots_equal_reference(monkeypatch):
    """A port collector and a JAX one ingest the same seeded scrapes
    under one injected clock: every cycle's /cluster/telemetry snapshot
    (merged percentiles, hot keys, SLO status) is equal."""
    clock = [1_000_000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    rng = np.random.default_rng(15)
    state = {"h": [0.0] * len(BOUNDS), "sum": 0.0, "ok": 0, "shed": 0,
             **dict.fromkeys(range(1, 6), 0)}
    text = [""]
    policies = (port_slo.parse_slo_policy(SLO_DOC),
                ref_slo.parse_slo_policy(SLO_DOC))
    cols = [mod.TelemetryCollector("master@m", lambda: [], interval_s=0,
                                   slo_policy=pol,
                                   local_scrape=lambda: text[0])
            for mod, pol in zip((port_collector, ref_collector), policies)]
    try:
        for _ in range(25):
            clock[0] += float(rng.uniform(1.0, 3.0))
            text[0] = _exposition(rng, state)
            for c in cols:
                c.trigger()
            snaps = [c.snapshot(top_limit=3) for c in cols]
            assert _close(snaps[0], snaps[1])
        assert snaps[0]["merged"]["SeaweedFS_volumeServer_request_seconds"]
        assert snaps[0]["top"]["requests"]["volume"][0]["key"] == "5"
    finally:
        for c in cols:
            c.stop()
