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
    assert tracing.__all__ == ref_tracing.__all__
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
