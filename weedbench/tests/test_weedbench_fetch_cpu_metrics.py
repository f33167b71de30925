"""The readers of a survivor fetch divided on the fetching side, the gRPC
workers' queue on the serving side, and the volume servers' CPU by thread
class (the program's SeaweedFS_ec_shard_fetch_phase_seconds,
_ec_shard_fetch_cpu_seconds, _pool_queue_wait_seconds{pool="ec_read"} and
{pool="grpc"}, and _process_thread_cpu_seconds_total) on made-up /metrics
deltas."""

import types

import pytest

from weedbench import spec

PHASE = "SeaweedFS_ec_shard_fetch_phase_seconds"
CPU = "SeaweedFS_ec_shard_fetch_cpu_seconds"
POOL = "SeaweedFS_pool_queue_wait_seconds"
THREADS = "SeaweedFS_process_thread_cpu_seconds_total"
STAGE = "SeaweedFS_volumeServer_stage_seconds"

FETCH_READERS = ["ec_fetch_queue_ms.get", "ec_fetch_first_ms.get",
                 "ec_fetch_cpu_ms.get", "grpc_queue_ms.get"]
CPU_READERS = ["vs_cpu_gather_ms.get", "vs_cpu_grpc_ms.get",
               "vs_cpu_http_ms.get", "vs_cpu_native_ms.get"]


def _hist(name, labels, s, n):
    lab = tuple(sorted(labels.items()))
    return {(f"{name}_sum", lab): s, (f"{name}_count", lab): n,
            (f"{name}_bucket", lab + (("le", "+Inf"),)): n}


def _run(*servers):
    return types.SimpleNamespace(
        scrape_delta={f"r{i + 2}": s for i, s in enumerate(servers)})


def _fetches(queue, first, rest, cpu, n, direct=0.0):
    """One server's survivor fetches (n of them, seconds summed over them,
    each queued on the ec_read pool), as many direct fetches of `direct`
    seconds each phase, and as many tasks of another pool."""
    out = {}
    for phase, s in (("first", first), ("rest", rest)):
        out.update(_hist(PHASE, {"role": "survivor", "phase": phase}, s, n))
    out.update(_hist(POOL, {"pool": "ec_read"}, queue, n))
    out.update(_hist(POOL, {"pool": "read"}, 7.0 * n, n))
    for phase in ("first", "rest"):
        out.update(_hist(PHASE, {"role": "direct", "phase": phase},
                         direct * n, n))
    out.update(_hist(CPU, {"role": "survivor"}, cpu, n))
    out.update(_hist(CPU, {"role": "direct"}, direct * n, n))
    return out


@pytest.mark.parametrize("name, ms", [("ec_fetch_queue_ms.get", 30.0),
                                      ("ec_fetch_first_ms.get", 100.0),
                                      ("ec_fetch_cpu_ms.get", 2.0)])
def test_fetch_readers_average_survivors_over_every_server(name, ms):
    # r2: 120 survivor fetches, queue 3 s, first 11 s, rest 2 s, cpu 0.3 s;
    # r3: 360, queue 11.4 s, first 37 s, rest 5 s, cpu 0.66 s; the direct
    # fetches (1 s a phase each) and the read pool's tasks are left out
    run = _run(_fetches(3.0, 11.0, 2.0, 0.3, 120, direct=1.0),
               _fetches(11.4, 37.0, 5.0, 0.66, 360, direct=1.0))
    assert spec.reader(name).read(run) == pytest.approx(ms)


def test_grpc_queue_reads_the_grpc_pool_alone():
    r2 = {**_hist(POOL, {"pool": "grpc"}, 0.3, 100),
          **_hist(POOL, {"pool": "ec_read"}, 30.0, 100)}
    r3 = {**_hist(POOL, {"pool": "grpc"}, 0.5, 100)}
    assert spec.reader("grpc_queue_ms.get").read(_run(r2, r3)) == \
        pytest.approx(4.0)


def _threads(gets, **cpu):
    out = {(THREADS, (("class", c),)): v for c, v in cpu.items()}
    out.update(_hist(STAGE, {"type": "get", "stage": "store"}, gets * 0.5,
                     gets))
    out.update(_hist(STAGE, {"type": "get", "stage": "recv_parse"}, 1.0,
                     gets))
    return out


@pytest.mark.parametrize("name, ms", [("vs_cpu_gather_ms.get", 50.0),
                                      ("vs_cpu_grpc_ms.get", 30.0),
                                      ("vs_cpu_http_ms.get", 10.0),
                                      ("vs_cpu_native_ms.get", 25.0)])
def test_cpu_readers_divide_classes_by_the_gets_answered(name, ms):
    # 400 GETs answered in all; CPU-s summed over both servers: ec_read 8 +
    # ec_run 12, grpc 12, event_loop 1 + read_pool 3, native 10; other and
    # capture are no reader's
    r2 = _threads(100, ec_read=2.0, ec_run=3.0, grpc=3.0, event_loop=0.25,
                  read_pool=0.75, native=2.5, other=4.0, capture=9.0)
    r3 = _threads(300, ec_read=6.0, ec_run=9.0, grpc=9.0, event_loop=0.75,
                  read_pool=2.25, native=7.5, other=12.0)
    assert spec.reader(name).read(_run(r2, r3)) == pytest.approx(ms)


@pytest.mark.parametrize("name", FETCH_READERS + CPU_READERS)
def test_readers_read_nothing_where_their_family_did_not_move(name):
    # a program without the families (the parent of this change), and one
    # whose families did not move in the window
    assert spec.reader(name).read(_run({}, {})) is None
    still = {**_fetches(0.0, 0.0, 0.0, 0.0, 0),
             **_hist(POOL, {"pool": "grpc"}, 0.0, 0),
             **_threads(0, grpc=0.0, native=0.0)}
    assert spec.reader(name).read(_run(still)) is None


@pytest.mark.parametrize("name", CPU_READERS)
def test_cpu_readers_read_nothing_without_the_thread_family(name):
    # GETs answered by a program that has no thread CPU family
    assert spec.reader(name).read(_run(_threads(100))) is None
