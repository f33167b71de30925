"""A remote shard fetch divided on the fetching side, the gRPC workers'
queue on the serving side, and the process's CPU by thread class.

RS(14,2) over two port volume servers joined by LocalPeers, with
device="cpu" coders, laid out as one rack of the benchmark's cell: A holds
shards 1 and 9, B holds the other twelve survivors, 0 and 8 are lost. A
rebuilt interval of shard 0 on A takes its two local survivors and fetches
twelve from B (role="survivor", each queued on A's ec_read pool, whose
wait is SeaweedFS_pool_queue_wait_seconds{pool="ec_read"}); an interval
of a shard on B is one direct fetch (role="direct"). Every fetch is one
SeaweedFS_ec_shard_fetch_seconds{role} observation, and its `first` and
`rest` phases add up to it exactly."""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import files
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.pb import master_pb2 as mpb
from seaweedfs_tpu_torch.profiling import threadcpu
from seaweedfs_tpu_torch.server.volume_server import LocalPeers, VolumeServer
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.tracing import stages
from seaweedfs_tpu_torch.utils import profiling, retry, rpc

from torch_cluster import free_port_pair

ROOT = Path(__file__).resolve().parents[1]
VID = 9
GEO = dict(large_block=8192, small_block=1024)
# shards 0 and 8 are held nowhere
HOLD = {"a": (1, 9), "b": (2, 3, 4, 5, 6, 7, 10, 11, 12, 13, 14, 15)}


def _store(path):
    return Store("127.0.0.1", 0, "", [DiskLocation(str(path))],
                 ec_geometry=EcGeometry(14, 2, **GEO), coder_name="torch",
                 device="cpu")


@pytest.fixture
def pair(tmp_path):
    """(A, B, needles): the RS(14,2) volume spread over the two servers."""
    retry.reset_breakers()
    src = tmp_path / "src"
    src.mkdir()
    store = _store(src)
    rng = np.random.default_rng(26)
    want = {k: rng.bytes(int(rng.integers(500, 6000))) for k in range(1, 41)}
    store.add_volume(VID)
    for k, data in want.items():
        store.write_needle(VID, Needle(id=k, cookie=0x5EED, data=data))
    base = os.path.basename(store.generate_ec_shards(VID))
    store.delete_volume(VID)
    store.close()
    servers = {}
    for name, keep in HOLD.items():
        shutil.copytree(src, tmp_path / name)
        for s in range(16):
            if s not in keep:
                os.unlink(str(tmp_path / name / base) + files.shard_ext(s))
        st = _store(tmp_path / name)
        st.mount_ec_shards(VID)
        servers[f"{name}:1"] = VolumeServer(st)
    LocalPeers(servers)
    a, b = servers["a:1"], servers["b:1"]
    try:
        yield a, b, want
    finally:
        for vs in (a, b):
            vs._ec_read_pool.shutdown(wait=True)
            vs.store.close()
        retry.reset_breakers()


class _Recorder:
    """Stands in for a histogram: keeps every observation with its thread,
    and passes it on to the real one."""

    def __init__(self, name, hist, seen, lock):
        self.name, self.hist, self.seen, self.lock = name, hist, seen, lock

    def observe(self, *labels, value):
        with self.lock:
            self.seen.append((threading.get_ident(), self.name, labels,
                              value))
        self.hist.observe(*labels, value=value)


@pytest.fixture
def observed(monkeypatch):
    """Every observation the shard fetch timer makes, in order."""
    seen, lock = [], threading.Lock()
    for attr, name in (("EC_SHARD_FETCH_SECONDS", "fetch"),
                       ("EC_SHARD_FETCH_PHASE_SECONDS", "phase"),
                       ("EC_SHARD_FETCH_CPU_SECONDS", "cpu")):
        monkeypatch.setattr(stages, attr,
                            _Recorder(name, getattr(stages, attr), seen,
                                      lock))
    return seen


def _fetches(seen):
    """[(role, whole, {phase: seconds}, cpu)] a fetch, from the
    observations: each fetch's are consecutive on its thread."""
    by_thread: dict = {}
    for tid, name, labels, value in seen:
        by_thread.setdefault(tid, []).append((name, labels, value))
    out = []
    for obs in by_thread.values():
        for name, labels, value in obs:
            if name == "fetch":
                out.append([labels[0], value, {}, None])
            elif name == "phase":
                assert labels[0] == out[-1][0]
                out[-1][2][labels[1]] = value
            else:
                out[-1][3] = value
    return out


def test_a_rebuilt_interval_is_twelve_divided_survivor_fetches(pair,
                                                               observed):
    a, _, _ = pair
    queued = stats.POOL_QUEUE_WAIT.count("ec_read")
    got = a._make_shard_reader(VID)(0, 0, 1024)
    assert len(got) == 1024
    fetches = _fetches(observed)
    assert len(fetches) == 12
    # each survivor fetch waited for an ec_read pool thread once, and so
    # did the task for lost shard 8, which finds no holder and is no fetch
    assert stats.POOL_QUEUE_WAIT.count("ec_read") - queued == 13
    for role, whole, phases, cpu in fetches:
        assert role == "survivor"
        assert set(phases) == {"first", "rest"}
        assert phases["first"] + phases["rest"] == pytest.approx(
            whole, rel=1e-9, abs=1e-12)
        assert phases["first"] >= 0 and phases["rest"] >= 0
        assert 0 <= cpu


def test_needle_reads_divide_every_survivor_and_direct_fetch(pair,
                                                             observed):
    """Needle reads on A: twelve survivor fetches a rebuilt run of lost
    shard 0 or 8, one direct fetch a run on B's shards; first + rest is
    each fetch's whole, and only the survivor fetches queue on the ec_read
    pool, once each, beside one task a rebuilt run for the other lost
    shard, which has no holder."""
    a, _, want = pair
    roles = ("survivor", "direct")
    before = {r: stats.EC_SHARD_FETCH_SECONDS.count(r) for r in roles}
    queued = stats.POOL_QUEUE_WAIT.count("ec_read")
    rebuilt = stats.DEGRADED_EC_READS.value()
    reader = a._make_shard_reader(VID)
    for k, data in want.items():
        assert a.store.read_needle(VID, k, cookie=0x5EED,
                                   shard_reader=reader).data == data
    rebuilt = stats.DEGRADED_EC_READS.value() - rebuilt
    fetches = _fetches(observed)
    n = {r: sum(f[0] == r for f in fetches) for r in roles}
    assert rebuilt > 0 and n["direct"] > 0
    assert n["survivor"] == 12 * rebuilt
    assert {r: stats.EC_SHARD_FETCH_SECONDS.count(r) - before[r]
            for r in roles} == n
    for role, whole, phases, _ in fetches:
        assert set(phases) == {"first", "rest"}
        assert phases["first"] + phases["rest"] == pytest.approx(
            whole, rel=1e-9, abs=1e-12)
    assert stats.POOL_QUEUE_WAIT.count("ec_read") - queued == \
        n["survivor"] + rebuilt


def test_fetch_phases_are_ranges_of_a_running_capture(pair, tmp_path):
    """Under a device capture each fetch's range `ec.fetch` holds
    `ec.fetch.first` and then `ec.fetch.rest`."""
    a, _, _ = pair
    reader = a._make_shard_reader(VID)
    path = profiling.start_device_trace(out_dir=str(tmp_path))
    try:
        reader(0, 1024, 1024)
    finally:
        profiling.stop_device_trace()
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    fetch = [e for e in events if e["name"] == "ec.fetch"]
    first = [e for e in events if e["name"] == "ec.fetch.first"]
    rest = [e for e in events if e["name"] == "ec.fetch.rest"]
    assert len(fetch) == len(first) == len(rest) == 12
    for f in fetch:
        inside = [e for e in first + rest if e["tid"] == f["tid"]
                  and f["ts"] <= e["ts"] <= f["ts"] + f["dur"]]
        assert sorted(e["name"] for e in inside) == ["ec.fetch.first",
                                                     "ec.fetch.rest"]


def test_a_fetch_that_never_gets_a_message_is_all_first():
    seen = []

    class Hist:
        def observe(self, *labels, value):
            seen.append((labels, value))

    with pytest.MonkeyPatch.context() as mp:
        for attr in ("EC_SHARD_FETCH_SECONDS", "EC_SHARD_FETCH_PHASE_SECONDS",
                     "EC_SHARD_FETCH_CPU_SECONDS"):
            mp.setattr(stages, attr, Hist())
        with pytest.raises(ConnectionError):
            with stages.shard_fetch("direct"):
                raise ConnectionError("peer down")
    whole, first, rest, cpu = seen
    assert whole[0] == ("direct",) and first[0] == ("direct", "first")
    assert first[1] == whole[1] and rest == (("direct", "rest"), 0.0)
    assert cpu[0] == ("direct",)


def test_grpc_workers_queue_is_recorded_by_the_server_pool():
    """One gRPC worker, two calls at once: the second waits for the worker
    while the first holds it, and that wait is
    SeaweedFS_pool_queue_wait_seconds{pool="grpc"}; handlers run on
    `grpc-worker` threads."""
    svc = rpc.RpcService("swtpu.test.Probe")
    release = threading.Event()
    names = []

    @svc.unary("Hold", mpb.LookupVolumeRequest, mpb.LookupVolumeResponse)
    def hold(req, context):
        names.append(threading.current_thread().name)
        if req.volume_or_file_ids == ["hold"]:
            release.wait(10)
        return mpb.LookupVolumeResponse()

    addr = f"127.0.0.1:{free_port_pair()}"
    server = rpc.serve(addr, [svc], max_workers=1)
    stub = rpc.Stub(addr, "swtpu.test.Probe")
    n0 = stats.POOL_QUEUE_WAIT.count("grpc")
    s0 = stats.POOL_QUEUE_WAIT.sum("grpc")
    try:
        first = threading.Thread(target=stub.call, args=(
            "Hold", mpb.LookupVolumeRequest(volume_or_file_ids=["hold"]),
            mpb.LookupVolumeResponse))
        first.start()
        second = threading.Thread(target=stub.call, args=(
            "Hold", mpb.LookupVolumeRequest(volume_or_file_ids=["go"]),
            mpb.LookupVolumeResponse))
        deadline = threading.Event()
        while not names and not deadline.wait(0.01):
            pass
        second.start()
        deadline.wait(0.3)
        release.set()
        first.join(10)
        second.join(10)
        assert not first.is_alive() and not second.is_alive()
    finally:
        release.set()
        server.stop(0)
    assert len(names) == 2 and all(n.startswith("grpc-worker")
                                   for n in names)
    assert stats.POOL_QUEUE_WAIT.count("grpc") - n0 == 2
    # the second call queued behind the held worker for ~0.3 s
    assert stats.POOL_QUEUE_WAIT.sum("grpc") - s0 >= 0.2


def _cpu(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("SeaweedFS_process_thread_cpu_seconds_total{"):
            cls = line.split('class="', 1)[1].split('"', 1)[0]
            out[cls] = float(line.rsplit(" ", 1)[1])
    return out


_CHILD = r"""
import concurrent.futures as cf, json, os, threading, time
from seaweedfs_tpu_torch.profiling import THREAD_CPU
from seaweedfs_tpu_torch.stats import scrape_payload

THREAD_CPU.install()  # as a server does where it serves /metrics

def burn(s):
    t = time.thread_time()
    while time.thread_time() - t < s:
        pass

def scrape():
    body = scrape_payload()[0]
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    proc = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    return body, proc

out = []
burn(0.2)
out.append(scrape())
# a long-lived worker, and short-lived threads that end before the next
# scrape: an EC read's fan-out pool and a thread of no known class
stop = threading.Event()
w = threading.Thread(target=lambda: (burn(0.3), stop.wait(30)),
                     name="grpc-worker_0")
w.start()
pool = cf.ThreadPoolExecutor(2, thread_name_prefix="ec-run-9")
list(pool.map(burn, (0.15, 0.15)))
pool.shutdown(wait=True)
r = threading.Thread(target=burn, args=(0.2,))
r.start()
r.join()
time.sleep(0.4)
out.append(scrape())
stop.set()
w.join()
burn(0.1)
out.append(scrape())
print(json.dumps(out))
"""


def test_thread_cpu_by_class_is_monotone_and_sums_to_the_process():
    """In a process of its own: the classes only grow, across threads
    that ended between two scrapes, which are counted whole (`native`,
    the process's CPU beyond its Python threads', stays under 5% where no
    native thread works); the fan-out pool's threads are `ec_run`; and the
    classes sum to the process's own /proc/self/stat CPU within 5%."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    got = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr[-3000:]
    scrapes = [(_cpu(body), proc)
               for body, proc in json.loads(got.stdout.splitlines()[-1])]
    for (c0, _), (c1, _) in zip(scrapes, scrapes[1:]):
        assert set(c0) <= set(c1)
        assert all(c1[k] >= c0[k] for k in c0)
    last, proc = scrapes[-1]
    assert last["ec_run"] >= 0.25 and last["grpc"] >= 0.25
    assert last["other"] >= 0.15
    assert sum(last.values()) == pytest.approx(proc, rel=0.05)
    # no native thread worked: the Python threads were counted whole,
    # those that ended between two scrapes too
    assert last.get("native", 0.0) <= 0.05 * proc


def test_thread_cpu_family_is_absent_where_proc_cannot_be_read(monkeypatch):
    monkeypatch.setattr(threadcpu, "_task_ids", lambda: None)
    monkeypatch.setattr(threadcpu, "_task_seconds", lambda tid: None)
    counter = stats.Counter("t_thread_cpu_seconds_total", "test", ("class",))
    cpu = threadcpu.ThreadCpu(counter)
    cpu.refresh()
    with cpu.counted_as(threadcpu.CAPTURE):
        time.sleep(0.01)
    cpu.note_self("ec_run")
    assert counter.expose() == []


def test_thread_cpu_counts_growth_once_and_the_rest_as_native(
        monkeypatch):
    """Two Python threads and the process around them: each thread's
    growth counted once under its class, a tid reused by a new thread
    counted from nothing; what the process used beyond them is `native`,
    which never shrinks."""
    counter = stats.Counter("t_thread_cpu_seconds_total", "test", ("class",))
    cpu = threadcpu.ThreadCpu(counter)
    secs, proc = {}, [0.0]
    worker = types.SimpleNamespace(name="grpc-worker_0")
    fan_out = types.SimpleNamespace(name="ec-run-9_0")
    threads = {101: worker, 102: fan_out}
    monkeypatch.setattr(threadcpu, "_task_seconds", lambda tid: secs.get(tid))
    monkeypatch.setattr(threadcpu, "_task_ids", lambda: list(secs))
    monkeypatch.setattr(threadcpu, "_process_seconds", lambda: proc[0])
    monkeypatch.setattr(threadcpu, "_python_threads", lambda: dict(threads))
    secs.update({101: 1.0, 102: 2.0})
    proc[0] = 3.5
    cpu.refresh()
    assert (counter.value("grpc"), counter.value("ec_run"),
            counter.value("native")) == (1.0, 2.0, 0.5)
    secs[101] = 1.5
    proc[0] = 4.5
    cpu.refresh()
    cpu.refresh()
    assert (counter.value("grpc"), counter.value("native")) == (1.5, 1.0)
    del secs[102], threads[102]   # ended, read last at 2.0 s
    threads[101] = types.SimpleNamespace(name="grpc-worker_1")
    secs[101] = 0.25              # the tid reused by a new thread
    proc[0] = 4.0                 # read before a thread's last tick
    cpu.refresh()
    assert (counter.value("grpc"), counter.value("ec_run"),
            counter.value("native")) == (1.75, 2.0, 1.0)


def test_a_finer_clock_then_whole_ticks_counts_once(monkeypatch):
    """A thread's own clock (at a capture's edge or its end) read after
    /proc's whole ticks, then ticks again: nothing counted twice."""
    counter = stats.Counter("t_thread_cpu_seconds_total", "test", ("class",))
    cpu = threadcpu.ThreadCpu(counter)
    me = threading.current_thread()
    monkeypatch.setattr(threadcpu, "_python_threads",
                        lambda: {threading.get_native_id(): me})
    cpu.refresh()
    cpu.note_self("other", me)
    cpu.refresh()
    cpu.refresh()
    total = sum(counter.value(c) for c in ("other", "native"))
    assert total == pytest.approx(threadcpu._process_seconds(), abs=0.05)
    assert counter.value("other") <= time.thread_time() + 0.01


def test_a_block_counted_as_another_class_leaves_the_threads():
    """CPU burned under counted_as("capture") on a `-http` loop thread is
    `capture`, what the thread burned before it stays `event_loop`: a
    traced run's capture start and stop (utils/profiling) do not read as
    the HTTP plane's CPU."""
    counter = stats.Counter("t_thread_cpu_seconds_total", "test", ("class",))
    cpu = threadcpu.ThreadCpu(counter)

    def burn(s):
        t0 = time.thread_time()
        while time.thread_time() - t0 < s:
            pass

    def loop():
        burn(0.1)
        with cpu.counted_as(threadcpu.CAPTURE):
            burn(0.3)

    t = threading.Thread(target=loop, name="vs-http-1")
    t.start()
    t.join(30)
    assert not t.is_alive()
    assert counter.value("capture") >= 0.25
    assert 0.05 <= counter.value("event_loop") <= 0.2


_UNSCRAPED = r"""
import json, threading
from seaweedfs_tpu_torch.profiling import THREAD_CPU
from seaweedfs_tpu_torch.stats import PROCESS_THREAD_CPU

THREAD_CPU.install()  # as a server does where it serves /metrics
held = []
for batch in range(100):
    ts = [threading.Thread(target=sum, args=((1, 2),),
                           name=f"ec-run-{batch}_{i}") for i in range(100)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    held.append(len(THREAD_CPU._counted) + len(THREAD_CPU._ended))
print(json.dumps([held, PROCESS_THREAD_CPU.value("ec_run") > 0]))
"""


def test_thread_cpu_keeps_nothing_of_ended_threads_when_never_scraped():
    """10,000 short threads in a server that nobody scrapes: each counts
    itself as it ends and is forgotten, so what the tracker holds stays
    as small as the threads alive at once, and never grows with the
    threads that ended."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    got = subprocess.run([sys.executable, "-c", _UNSCRAPED], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert got.returncode == 0, got.stderr[-3000:]
    held, counted = json.loads(got.stdout.splitlines()[-1])
    assert counted
    assert max(held) <= 100


def test_a_thread_that_ends_during_a_refresh_counts_once(monkeypatch):
    """A refresh lists a thread alive and reads its /proc time, the thread
    then counts itself at its end before that refresh counts: the refresh
    adds nothing more of it, and the tracker keeps nothing of it after."""
    counter = stats.Counter("t_thread_cpu_seconds_total", "test", ("class",))
    cpu = threadcpu.ThreadCpu(counter)
    burned, go, done = threading.Event(), threading.Event(), threading.Event()

    def work():
        t0 = time.thread_time()
        while time.thread_time() - t0 < 0.2:
            pass
        burned.set()
        go.wait(30)
        # as the end wrapper does, once threading has dropped the thread
        cpu.note_end(threading.current_thread())
        done.set()

    t = threading.Thread(target=work, name="ec-run-1_0")
    t.start()
    assert burned.wait(30)
    read = threadcpu._task_seconds

    def task_seconds(tid):
        # the thread read alive, then ending before the refresh counts
        seconds = read(tid)
        if tid == t.native_id:
            go.set()
            assert done.wait(30)
        return seconds

    monkeypatch.setattr(threadcpu, "_task_seconds", task_seconds)
    cpu.refresh()
    t.join(30)
    assert 0.2 <= counter.value("ec_run") <= 0.3
    assert not cpu._ended
    assert all(k[1] != id(t) for k in cpu._counted)
