"""The port's profiling plane (seaweedfs_tpu_torch/profiling/) against the
JAX package's on the same inputs: `handle_profile_query`'s 400s and modes
(status, content type and body equal), the flight recorder's ring,
threshold, filters and `/debug/flight` payload (entries equal once their
display timestamps are removed), `MonitoredPool.queued()` and its metrics,
the loop-lag probe, the sampler's thread classes and its aggregate read
back as collapsed text and as the summary the telemetry collector merges.
Every comparison is exact; no tolerance applies."""

import asyncio
import json
import threading
import time

import pytest

from seaweedfs_tpu import profiling as ref_prof
from seaweedfs_tpu.profiling import sampler as ref_sampler
from seaweedfs_tpu_torch import profiling as prof
from seaweedfs_tpu_torch import stats, tracing
from seaweedfs_tpu_torch.profiling import sampler

PACKAGES = {"port": prof, "reference": ref_prof}


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        time.sleep(0.005)


@pytest.fixture
def idle_samplers(monkeypatch):
    """A paused sampler as each package's process default, so the hz and
    mode queries act on it and start no thread."""
    ours = prof.ContinuousSampler(hz=0, max_stacks=100)
    theirs = ref_prof.ContinuousSampler(hz=0, max_stacks=100)
    monkeypatch.setattr(sampler, "_default", ours)
    monkeypatch.setattr(ref_sampler, "_default", theirs)
    return ours, theirs


@pytest.mark.parametrize("query", [
    {"seconds": "abc"}, {"seconds": "nan"}, {"seconds": "inf"},
    {"seconds": "0"}, {"seconds": "-2"},
    {"hz": "abc"}, {"hz": "nan"}, {"hz": "-1"}, {"hz": "inf"},
    {"mode": "bogus"}, {"mode": "summary", "top": "x"},
])
def test_profile_query_400s_equal_reference(query, idle_samplers):
    got = prof.handle_profile_query(dict(query))
    want = ref_prof.handle_profile_query(dict(query))
    assert got == want and got[0] == 400 and "error" in json.loads(got[2])


def test_profile_query_modes_equal_reference(idle_samplers):
    ours, theirs = idle_samplers
    for q in ({"hz": "0"}, {"hz": "7.5"}, {"hz": "0"}):
        assert prof.handle_profile_query(dict(q)) == \
            ref_prof.handle_profile_query(dict(q))
    assert ours.hz == theirs.hz == 0.0
    for s in idle_samplers:
        s.stop()  # hz 7.5 started the thread; the aggregate below is set
        s.reset()
        s._agg.update({"other;on_cpu;x.py:f": 3, "read_pool;waiting;q.py:get": 5,
                       "grpc;on_cpu;a.py:b;c.py:d": 1})
        s._samples, s._ticks = 9, 4
    for q in ({"mode": "continuous"}, {"mode": "summary"},
              {"mode": "summary", "top": "1"}, {"mode": "summary", "top": "0"},
              {"hz": "0", "mode": "summary"}):
        got = prof.handle_profile_query(dict(q))
        assert got == ref_prof.handle_profile_query(dict(q)), q
        assert got[0] == 200
    summary = json.loads(prof.handle_profile_query({"mode": "summary"})[2])
    assert summary["samples"] == 9 and summary["classes"]["read_pool"] == \
        {"on_cpu": 0, "waiting": 5}


def test_profile_query_without_a_sampler_equals_reference(monkeypatch):
    monkeypatch.setattr(sampler, "_default", None)
    monkeypatch.setattr(ref_sampler, "_default", None)
    for q in ({"mode": "continuous"}, {"mode": "summary"}):
        assert prof.handle_profile_query(dict(q)) == \
            ref_prof.handle_profile_query(dict(q))


def test_profile_capture_clamped_like_reference(monkeypatch, idle_samplers):
    monkeypatch.setenv("SWTPU_PROFILE_MAX_SECONDS", "0.2")
    t0 = time.perf_counter()
    code, ctype, body = prof.handle_profile_query({"seconds": "86400"})
    assert (code, ctype) == (200, "text/plain; charset=utf-8")
    assert body.startswith("# sampled") and time.perf_counter() - t0 < 5


def _entries(recorder):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in recorder.snapshot(limit=1000)]


def _offer(recorder):
    """One seeded sequence of finished requests."""
    out = [recorder.record("volume.get", 0.002),
           recorder.record("volume.get", 0.002, status=500, path="/3,01"),
           recorder.record("volume.get", 0.005, path="/3,02")]
    for i in range(9):
        out.append(recorder.record(
            "volume.bulk" if i % 3 else "volume.bulk-read",
            0.010 + i * 0.0015, status=200, path=f"/bulk?vid={i}",
            stages={"recv_parse": 0.0001 * i, "store": 0.009},
            qos_class="ingest", cache="miss" if i % 2 else None,
            loop_lag_s=0.0005 * i, queue_depths={"read": i, "ec_read": 1},
            node="127.0.0.1:8080"))
    return out


def test_flight_ring_and_threshold_equal_reference():
    ours = prof.FlightRecorder(capacity=5, slow_ms=5.0)
    theirs = ref_prof.FlightRecorder(capacity=5, slow_ms=5.0)
    got, want = _offer(ours), _offer(theirs)
    assert [e is None for e in got] == [e is None for e in want] == \
        [True, False, False] + [False] * 9
    assert ours.recorded() == theirs.recorded() == 11
    assert _entries(ours) == _entries(theirs)
    assert len(_entries(ours)) == 5  # the ring's bound
    durs = [e["duration_ms"] for e in _entries(ours)]
    assert durs == sorted(durs, reverse=True)
    for kw in ({"min_ms": 20.0}, {"kind": "volume.bulk"},
               {"kind": "volume.bulk-read"}, {"limit": 2}, {"limit": 0}):
        strip = [{k: v for k, v in e.items() if k != "ts"}
                 for e in ours.snapshot(**kw)]
        assert strip == [{k: v for k, v in e.items() if k != "ts"}
                         for e in theirs.snapshot(**kw)], kw
    ours.clear()
    theirs.clear()
    assert _entries(ours) == _entries(theirs) == []


def test_flight_entry_carries_the_active_trace():
    fr = prof.FlightRecorder(capacity=8, slow_ms=1.0)
    with tracing.start_span("flight-test") as sp:
        entry = fr.record("volume.get", 0.050, path="/1,abc")
        assert (entry["trace_id"], entry["span_id"]) == \
            (sp.context.trace_id, sp.context.span_id)
        assert any(ev["name"] == "flight.recorded" and
                   ev["seq"] == entry["seq"] for ev in sp.events)


@pytest.mark.parametrize("query", [
    {}, {"min_ms": "abc"}, {"min_ms": "nan"}, {"min_ms": "-3"},
    {"limit": "many"}, {"min_ms": "12", "limit": "3"},
    {"type": "volume.bulk"}, {"limit": "5000"},
])
def test_debug_flight_payload_equals_reference(query, monkeypatch):
    ours = prof.FlightRecorder(capacity=16, slow_ms=5.0)
    theirs = ref_prof.FlightRecorder(capacity=16, slow_ms=5.0)
    monkeypatch.setattr(prof.flight, "FLIGHT", ours)
    monkeypatch.setattr(ref_prof.flight, "FLIGHT", theirs)
    _offer(ours)
    _offer(theirs)
    (code, body), (ref_code, ref_body) = (
        pkg.debug_flight_payload(dict(query)) for pkg in (prof, ref_prof))
    assert code == ref_code
    if code == 200:
        for b in (body, ref_body):
            for e in b["entries"]:
                e.pop("ts")
    assert body == ref_body


def test_record_flight_swallows_errors(monkeypatch):
    class Broken:
        def record(self, *a, **kw):
            raise RuntimeError("boom")
    monkeypatch.setattr(prof.flight, "FLIGHT", Broken())
    prof.record_flight("volume.get", 1.0)  # never raises into a request


def test_flight_env_knobs_as_reference(monkeypatch):
    monkeypatch.setenv("SWTPU_FLIGHT_SLOW_MS", "12.5")
    monkeypatch.setenv("SWTPU_FLIGHT_BUFFER", "7")
    ours, theirs = prof.FlightRecorder(), ref_prof.FlightRecorder()
    assert (ours.capacity, ours.slow_ms) == (theirs.capacity, theirs.slow_ms) \
        == (7, 12.5)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_monitored_pool_queued(package):
    pkg = PACKAGES[package]
    gate = threading.Event()
    label = f"test_queued_{package}"
    pool = pkg.MonitoredPool(label, max_workers=1,
                             thread_name_prefix=f"test-queued-{package}")
    try:
        assert pool.queued() == 0
        futs = [pool.submit(gate.wait, 10) for _ in range(4)]
        _wait_until(lambda: pool.queued() == 3)  # one runs, three wait
        gate.set()
        assert [f.result(timeout=10) for f in futs] == [True] * 4
        assert pool.queued() == 0
    finally:
        gate.set()
        pool.shutdown(wait=True)


def test_monitored_pool_books_port_metrics():
    gate = threading.Event()
    pool = prof.MonitoredPool("torch_pool_test", max_workers=1)
    wait0 = stats.POOL_QUEUE_WAIT.count("torch_pool_test")
    try:
        futs = [pool.submit(gate.wait, 10) for _ in range(3)]
        _wait_until(lambda: stats.POOL_QUEUE_WAIT.count("torch_pool_test")
                    == wait0 + 1)
        assert stats.POOL_QUEUE_DEPTH.value("torch_pool_test") == 2.0
        gate.set()
        for f in futs:
            f.result(timeout=10)
        _wait_until(lambda: stats.POOL_QUEUE_DEPTH.value("torch_pool_test")
                    == 0.0)
        assert stats.POOL_QUEUE_WAIT.count("torch_pool_test") == wait0 + 3
    finally:
        gate.set()
        pool.shutdown(wait=True)
    with pytest.raises(RuntimeError):
        pool.submit(time.sleep, 0)  # refused after shutdown: depth rolls back
    assert pool.queued() == 0


def test_loop_lag_probe_sees_a_blocked_loop():
    mon = prof.LoopLagMonitor("torch_lagtest", interval_s=0.02)
    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    try:
        loop.call_soon_threadsafe(mon.attach, loop)
        _wait_until(lambda: mon.probes >= 2)
        before = stats.EVENT_LOOP_LAG.count("torch_lagtest")
        probes0 = mon.probes
        loop.call_soon_threadsafe(time.sleep, 0.3)
        _wait_until(lambda: mon.probes > probes0)
        assert mon.last_lag_s > 0.15
        assert stats.EVENT_LOOP_LAG.count("torch_lagtest") > before
    finally:
        loop.call_soon_threadsafe(mon.close)
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=5)
        loop.close()


def test_loop_lag_interval_knob_as_reference(monkeypatch):
    monkeypatch.setenv("SWTPU_LOOP_PROBE_S", "0.125")
    assert prof.LoopLagMonitor("x").interval_s == \
        ref_prof.LoopLagMonitor("x").interval_s == 0.125


@pytest.mark.parametrize("name", [
    "vs-read-8080_0", "ec-degraded-read_3", "swtpu-ec-writer-1",
    "chunk-upload-2", "stream-write-0", "grpc-worker-5", "raft-rpc",
    "vs-http-8080", "master-http", "asyncio_0", "MainThread", "",
    "vs-hop-8080_1", "swtpu-profiler",
])
def test_thread_classes_equal_reference(name):
    assert prof.classify_thread(name) == ref_prof.classify_thread(name)


def test_port_ec_read_pool_has_its_own_class():
    assert prof.classify_thread("ec-read-8080_2") == "ec_read"
    assert ref_prof.classify_thread("ec-read-8080_2") == "other"
    assert set(prof.THREAD_CLASSES) == set(ref_prof.THREAD_CLASSES) | \
        {"ec_read"}


def test_sampler_aggregate_equals_reference():
    """The same aggregate read back as collapsed text and as the summary,
    overflow into ~other included, equal in both packages."""
    samplers = [pkg.ContinuousSampler(hz=0, max_stacks=3)
                for pkg in (prof, ref_prof)]
    for s in samplers:
        for i, (key, n) in enumerate((
                ("read_pool;waiting;threading.py:wait", 40),
                ("event_loop;on_cpu;fastweb.py:data_received", 11),
                ("grpc;on_cpu;rpc.py:call;x.py:f", 7),
                ("read_pool;on_cpu;~other", 2),
                ("other;waiting;queue.py:get", 1))):
            s._agg[key] = n
        s._samples, s._ticks = 61, 13
    ours, theirs = samplers
    assert ours.collapsed() == theirs.collapsed()
    assert ours.collapsed(min_count=5) == theirs.collapsed(min_count=5)
    for top in (1, 2, 200):
        assert ours.summary(top=top) == theirs.summary(top=top)
    assert sum(st["count"] for st in ours.summary(top=1)["stacks"]) == 61
    ours.reset()
    assert ours.summary()["samples"] == 0 and ours.collapsed().count("\n") == 1


def test_sampler_sets_hz_like_reference():
    for hz in (-3, 0, 19, 1000):
        a, b = prof.ContinuousSampler(hz=1), ref_prof.ContinuousSampler(hz=1)
        a.set_hz(hz)
        b.set_hz(hz)
        assert a.hz == b.hz


def test_sampler_thread_samples_into_port_metrics():
    s = prof.ContinuousSampler(hz=200, max_stacks=50)
    before = stats.PROFILE_SAMPLES.value("other", "waiting") + \
        stats.PROFILE_SAMPLES.value("other", "on_cpu")
    s.start()
    try:
        _wait_until(lambda: s.summary()["ticks"] >= 3)
    finally:
        s.stop()
    assert not s.running
    summary = s.summary()
    assert summary["samples"] >= summary["ticks"] >= 3
    after = stats.PROFILE_SAMPLES.value("other", "waiting") + \
        stats.PROFILE_SAMPLES.value("other", "on_cpu")
    assert after > before


def test_acquire_and_release_refcount(monkeypatch):
    monkeypatch.setattr(sampler, "_default", None)
    monkeypatch.setattr(sampler, "_refs", 0)
    monkeypatch.setenv("SWTPU_PROFILE_HZ", "50")
    a = prof.acquire_sampler()
    b = prof.acquire_sampler()
    try:
        assert a is b is prof.default_sampler() and a.running
        prof.release_sampler()
        assert a.running  # one holder left
    finally:
        prof.release_sampler()
    assert not a.running and prof.default_sampler() is a
    prof.release_sampler()  # an extra release stays at zero
    assert sampler._refs == 0
