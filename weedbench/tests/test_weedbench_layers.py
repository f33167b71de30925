"""The benchmark's own arithmetic: the trace reader, the /metrics parser
and the per-layer readers on made-up inputs."""

import json
import types

import numpy as np
import pytest

from weedbench import promstat, spec, traces


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_drops_the_captures_warmup_and_clips_to_the_window(tmp_path):
    ev = [_k("fill", 0, 1)] + [_k("add", 10 + i, 1) for i in range(4)]
    # warm-up ends at 14 us; the start request returned at monotonic 100.0
    ev += [_k("rs_gf_apply_kernel", 1000, 100),      # before the window
           _k("rs_gf_apply_kernel", 2_000_000, 500),  # inside
           _k("Memcpy HtoD", 2_000_400, 200, "gpu_memcpy"),
           _k("rs_gf_apply_kernel", 2_999_990, 40),   # straddles the end
           {"ph": "X", "cat": "cpu_op", "name": "aten::copy_",
            "ts": 2_100_000, "dur": 800_000}]
    t = traces.read(_trace(tmp_path, ev), "r2", 4,
                    window=(100.0, 101.0, 103.0))
    # the window is [1_000_014, 3_000_014) us on the trace's clock
    assert t.kernel_s == pytest.approx({"rs_gf_apply_kernel": 524e-6})
    assert t.busy_s == pytest.approx(624e-6)
    assert t.device_events == 3
    assert t.gaps[0] == ("r2: no host op traced",
                         pytest.approx((2_000_000 - 1_000_014) / 1e6))
    assert t.gaps[1] == ("r2: aten::copy_",
                         pytest.approx((2_999_990 - 2_000_600) / 1e6))


def test_promstat_parses_and_subtracts():
    a = promstat.parse('x_sum{type="get",stage="store"} 1.5\n'
                       'x_sum{type="get",stage="recv_parse"} 0.5\n'
                       '# HELP x\nx_count{type="get",stage="store"} 3\n')
    b = promstat.parse('x_sum{type="get",stage="store"} 4.5\n'
                       'x_sum{type="get",stage="recv_parse"} 1.0\n'
                       'x_count{type="get",stage="store"} 9\n')
    d = promstat.delta(a, b)
    assert promstat.total(d, "x_sum", type="get", stage="store") == 3.0
    assert promstat.total(d, "x_sum", type="get", stage="!store") == 0.5
    assert promstat.total(d, "x_count", stage="store") == 6.0


def _run(**kw):
    base = dict(scrape_delta={}, traces=[], window_s=10.0, data={},
                device_kind="NVIDIA H100 80GB HBM3", t_end=10.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_stage_readers_split_the_get():
    name = "SeaweedFS_volumeServer_stage_seconds"
    series = {(f"{name}_sum", (("stage", s), ("type", "get"))): v
              for s, v in (("store", 2.0), ("recv_parse", 0.1),
                           ("queue_wait", 0.3))}
    series[(f"{name}_count", (("stage", "store"), ("type", "get")))] = 100
    run = _run(scrape_delta={"r2": series})
    assert spec.reader("vs_store_ms.get").read(run) == pytest.approx(20.0)
    assert spec.reader("vs_protocol_ms.get").read(run) == pytest.approx(4.0)
    assert spec.reader("vs_store_ms.get").read(_run()) is None


def test_the_idle_reader_reads_nothing_where_nothing_was_traced():
    t = traces.Trace("r2", busy_s=0.5, kernel_s={"rs_gf_apply_kernel": 0.01},
                     device_events=3)
    run = _run(traces=[t])
    assert spec.reader("device_idle_pct.get").read(run) == \
        pytest.approx(95.0)
    # no device work traced (a CPU rehearsal): no share at all, never 0
    run.traces = [traces.Trace("r2")]
    assert spec.reader("device_idle_pct.get").read(run) is None


def test_the_load_starts_no_get_after_the_window(tmp_path):
    """Offered far above what a slow server answers, the load sends no GET
    once the window has closed and records every GET it sent."""
    import http.server
    import subprocess
    import sys
    import threading
    import time

    class Slow(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            time.sleep(0.02)
            body = self.path.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Slow)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        n = 2000
        plan, out = tmp_path / "plan.npz", tmp_path / "gets.npz"
        np.savez(plan, urls=np.array([f"127.0.0.1:{srv.server_port}"]),
                 vid=np.ones(4, np.int64), key=np.arange(1, 5),
                 cookie=np.zeros(4, np.int64),
                 objects=np.arange(n).reshape(-1, 1) % 4,
                 server=np.zeros((n, 1), np.int64),
                 arrivals=np.linspace(0, 1, n, endpoint=False), workers=2)
        proc = subprocess.Popen([sys.executable, "-m", "weedbench.loadgen",
                                 str(plan), str(out)],
                                stdin=subprocess.PIPE)
        start = time.monotonic() + 0.5
        proc.communicate(f"{start!r} 0.5\n".encode(), timeout=60)
        assert proc.returncode == 0
        with np.load(out) as z:
            sent, t1, status = z["sent"], z["t1"], z["status"]
        assert 0 < len(sent) < 100 and (status == 200).all()
        assert (sent >= start).all() and (sent < start + 0.5).all()
        assert t1.max() < start + 0.5 + 1.0
    finally:
        srv.shutdown()
        srv.server_close()


def test_the_get_tail_is_timed_from_sending_and_counts_failures():
    n = 100
    gets = {"sent": np.zeros(n), "t1": np.linspace(0.001, 0.1, n)}
    run = _run(data={"gets": gets, "ok": np.ones(n, bool)})
    assert spec.reader("get_p95_ms").read(run) == pytest.approx(
        float(np.percentile(np.linspace(1, 100, n), 95)))
    bad = np.ones(n, bool)
    bad[:6] = False
    run = _run(data={"gets": gets, "ok": bad})
    assert spec.reader("get_p95_ms").read(run) == 1e9
    assert spec.reader("get_p95_ms").read(_run()) is None


def test_pinning_reaches_threads_made_before_it():
    import os
    import threading
    from weedbench import cluster as cl
    mine = sorted(os.sched_getaffinity(0))
    ready, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        ready.set()
        done.wait(10)
        seen["cpus"] = sorted(os.sched_getaffinity(0))

    t = threading.Thread(target=worker)
    t.start()
    ready.wait(10)
    try:
        cl.set_affinity(os.getpid(), mine[:1])
        done.set()
        t.join(10)
        assert seen["cpus"] == mine[:1]
    finally:
        cl.set_affinity(os.getpid(), mine)
