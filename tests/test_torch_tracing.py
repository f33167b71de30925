"""The port's tracing (seaweedfs_tpu_torch/tracing/) against the JAX
package's: traceparent parsing and propagation, span trees, the bounded
buffer, /debug/traces payloads and the TRACE_SPANS counter; trace ids in
JSON log lines; and utils/profiling (cpu_profile as the reference's, and
start_device_trace, the torch.profiler counterpart of start_jax_profiler).
"""

import json
import logging
import os
import threading

import pytest
import torch

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu import tracing as ref_tracing
from seaweedfs_tpu_torch import stats, tracing
from seaweedfs_tpu_torch.utils import log, profiling

TRACEPARENTS = [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-00",
    "", "00", "00-xyz-abc-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "ff-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    " 00-" + "AB" * 16 + "-" + "CD" * 8 + "-01 ",
]


@pytest.fixture(autouse=True)
def _full_sampling():
    for mod in (tracing, ref_tracing):
        mod.configure(sample=1.0, slow_ms=0.0)
    yield
    for mod in (tracing, ref_tracing):
        mod.configure(sample=1.0, slow_ms=0.0)


def test_public_surface_matches_reference():
    # `stage` (tracing/stages.py) is the port's own
    assert [n for n in tracing.__all__ if n != "stage"] == ref_tracing.__all__
    assert "stage" in tracing.__all__
    assert tracing.TRACEPARENT_HEADER == ref_tracing.TRACEPARENT_HEADER


@pytest.mark.parametrize("value", TRACEPARENTS)
def test_parse_traceparent_matches_reference(value):
    got, want = tracing.parse_traceparent(value), ref_tracing.parse_traceparent(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id, got.sampled) == \
            (want.trace_id, want.span_id, want.sampled)
        assert got.to_traceparent() == want.to_traceparent()


def _tree(mod):
    """A parent with a child and a remote child; (spans, headers) as the
    package records and injects them."""
    mod.BUFFER.clear()
    with mod.start_span("parent", component="t", attrs={"k": 1}) as p:
        headers = mod.inject({})
        with mod.start_span("child", component="t") as c:
            c.set_attr("x", 2)
            mod.add_event("ev", n=3)
        remote = mod.extract(headers)
        with mod.start_span("remote", component="r", child_of=remote):
            pass
        try:
            with mod.start_span("fails", component="t"):
                raise ValueError("boom")
        except ValueError:
            pass
        ids = (p.context.trace_id, p.context.span_id, c.parent_id)
    return mod.BUFFER.snapshot(), headers, ids


def test_span_tree_and_propagation_match_reference():
    got, got_h, (trace, span, parent) = _tree(tracing)
    want, want_h, _ = _tree(ref_tracing)
    assert parent == span
    assert set(got_h) == set(want_h) == {tracing.TRACEPARENT_HEADER}
    assert got_h[tracing.TRACEPARENT_HEADER].split("-")[1] == trace

    def shape(spans):
        return [(s["name"], s["component"], s["status"], sorted(s["attrs"]),
                 [e["name"] for e in s["events"]], bool(s["parent_id"]))
                for s in spans]
    assert shape(got) == shape(want)
    assert {s["trace_id"] for s in got} == {trace}
    payload = tracing.debug_traces_payload({"trace_id": trace, "limit": "2"})
    ref_payload = ref_tracing.debug_traces_payload({"limit": "2"})
    assert sorted(payload) == sorted(ref_payload)
    assert payload["count"] == 2 and payload["buffered"] == 4


def test_sampling_zero_injects_nothing_and_records_nothing():
    for mod in (tracing, ref_tracing):
        mod.configure(sample=0.0)
        mod.BUFFER.clear()
        with mod.start_span("quiet", component="t"):
            assert mod.inject({}) == {} and mod.injectable() == ""
        assert len(mod.BUFFER) == 0


def test_buffer_bounds_and_trace_span_counter():
    buf = tracing.TraceBuffer(capacity=3)
    ref_buf = ref_tracing.TraceBuffer(capacity=3)
    before = stats.TRACE_SPANS.value("bounded")
    ref_before = ref_stats.TRACE_SPANS.value("bounded")
    for i in range(5):
        for mod, b in ((tracing, buf), (ref_tracing, ref_buf)):
            with mod.start_span(f"s{i}", component="bounded") as sp:
                pass
            b.add(sp)
    assert len(buf) == len(ref_buf) == 3 and buf.dropped == ref_buf.dropped == 2
    assert [s["name"] for s in buf.snapshot()] == ["s4", "s3", "s2"]
    # every finished span counts once: recorded by the shared buffer at
    # exit, and once more here by the explicit add
    assert stats.TRACE_SPANS.value("bounded") - before == \
        ref_stats.TRACE_SPANS.value("bounded") - ref_before == 10


def test_thread_pool_fanout_keeps_the_trace():
    import concurrent.futures as cf
    import contextvars
    tracing.BUFFER.clear()
    with tracing.start_span("root", component="t") as root:
        with cf.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(contextvars.copy_context().run,
                                tracing.current_trace_id) for _ in range(3)]
            assert {f.result() for f in futs} == {root.context.trace_id}
    assert tracing.current_trace_id() == ""


def test_json_log_lines_carry_trace_ids():
    records = []

    class _Keep(logging.Handler):
        def emit(self, record):
            records.append(log._JsonFormatter().format(record))

    lg = log.logger("trace_test")
    h = _Keep()
    lg.addHandler(h)
    try:
        with tracing.start_span("logged", component="t") as sp:
            lg.warning("inside")
        lg.warning("outside")
    finally:
        lg.removeHandler(h)
    inside, outside = (json.loads(r) for r in records)
    assert inside["trace_id"] == sp.context.trace_id
    assert inside["span_id"] == sp.context.span_id
    assert "trace_id" not in outside


def test_cpu_profile_samples_other_threads():
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(1000))

    t = threading.Thread(target=spin, name="spinner")
    t.start()
    try:
        out = profiling.cpu_profile(seconds=0.3, interval=0.005)
    finally:
        stop.set()
        t.join(10)
    assert out.startswith("# sampled ") and "== hottest lines ==" in out
    assert "spin" in out


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """One torch.profiler capture (CPU activity here: no card) written
    where start_device_trace says; one capture at a time."""
    path = profiling.start_device_trace(out_dir=str(tmp_path))
    try:
        assert os.path.dirname(path) == str(tmp_path)
        with pytest.raises(RuntimeError, match="already being captured"):
            profiling.start_device_trace(out_dir=str(tmp_path))
        a = torch.randn(64, 64)
        for _ in range(20):
            a = a @ a / 64
    finally:
        assert profiling.stop_device_trace() == path
    with pytest.raises(RuntimeError, match="no device trace"):
        profiling.stop_device_trace()
    with open(path) as f:
        trace = json.load(f)
    assert any(ev.get("cat") == "cpu_op" for ev in trace["traceEvents"])


def _degraded_span_tree(mod, store, server, saved, sid=0, length=1024):
    """Read `length` bytes of lost shard `sid` through `server`'s shard
    reader under a root span: shards 2 and 3 answer from `saved` through
    the server's fetch (holders listed, 50 ms a fetch), 0 and 5 have no
    holder, 1 and 4 are local. Returns the bytes and the span tree as
    sorted (name, parent's name, shard, status) rows."""
    import time as _time

    locs = {2: ["holder-a:1"], 3: ["holder-b:1"]}

    def inner(vid, s, offset, ln, holders, include_open, sp, *role):
        if not holders:
            return None
        _time.sleep(0.05)  # the holderless fetch of shard 5 ends first
        return saved[s][offset:offset + ln]

    server._lookup_ec_shards = lambda vid, failed=False: locs
    server._fetch_remote_shard_inner = inner
    mod.BUFFER.clear()
    with mod.start_span("test.read", component="test") as root:
        data = server._make_shard_reader(7)(sid, 0, length)
    spans = mod.BUFFER.snapshot(trace_id=root.context.trace_id, limit=100)
    names = {s["span_id"]: s["name"] for s in spans}
    rows = sorted((s["name"], names.get(s["parent_id"], ""),
                   s["attrs"].get("shard", -1), s["status"]) for s in spans)
    server._ec_read_pool.shutdown(wait=True)
    return data, rows


def test_degraded_read_span_tree_matches_reference(tmp_path):
    """One degraded EC read at RS(4,2) through each package's volume
    server, same seeded volume and same lost shards: equal bytes and the
    same span tree, every shard fetch under the read's ec.reconstruct
    span (the pool threads run in the submitter's context)."""
    import shutil

    import numpy as np

    from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
    from seaweedfs_tpu.storage.disk_location import DiskLocation as RefLocation
    from seaweedfs_tpu.storage.store import Store as RefStore
    from seaweedfs_tpu_torch.ec import files
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    geo = dict(large_block=8192, small_block=1024)
    src = tmp_path / "src"
    src.mkdir()
    store = Store("127.0.0.1", 0, "", [DiskLocation(str(src))],
                  ec_geometry=EcGeometry(4, 2, **geo), coder_name="torch",
                  device="cpu")
    rng = np.random.default_rng(11)
    store.add_volume(7)
    for k in range(1, 41):
        store.write_needle(7, Needle(id=k, cookie=0x5EED, data=rng.bytes(
            int(rng.integers(100, 3000)))))
    base = store.generate_ec_shards(7)
    saved = {s: open(base + files.shard_ext(s), "rb").read()
             for s in range(6)}
    store.delete_volume(7)
    store.close()
    for name in ("port", "ref"):
        shutil.copytree(src, tmp_path / name)
        for s in (0, 2, 3, 5):
            os.unlink(str(tmp_path / name / os.path.basename(base))
                      + files.shard_ext(s))

    port_store = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "port"))],
                       ec_geometry=EcGeometry(4, 2, **geo),
                       coder_name="torch", device="cpu")
    ref_store = RefStore("127.0.0.1", 0, "",
                         [RefLocation(str(tmp_path / "ref"))],
                         ec_geometry=RefGeometry(4, 2, **geo),
                         coder_name="numpy")
    try:
        port_store.mount_ec_shards(7)
        ref_store.mount_ec_shards(7)
        got, got_tree = _degraded_span_tree(
            tracing, port_store, VolumeServer(port_store), saved)
        want, want_tree = _degraded_span_tree(
            ref_tracing, ref_store, RefServer(ref_store, "127.0.0.1:1"),
            saved)
    finally:
        port_store.close()
        ref_store.close()
    assert got == want == saved[0][:1024]
    assert got_tree == want_tree
    fetches = [r for r in got_tree if r[0] == "ec.shard.fetch"]
    assert sorted(r[2] for r in fetches) == [0, 2, 3, 5]
    assert [r[1] for r in fetches if r[2] != 0] == ["ec.reconstruct"] * 3
