"""Built-in cluster load benchmark (reference weed/command/benchmark.go:117).

Writes N files of a given size with C concurrent workers through the real
assign+PUT path, then random-reads them back, reporting req/s and latency
percentiles — the reference README's headline numbers (README.md:536-585).

The port's copy of seaweedfs_tpu/bench_tool.py (`python -m
seaweedfs_tpu_torch benchmark`), over the port's client/operation and
client/master_client. `run` returns the same dict. One difference: the
write and read lines print p50 beside avg and p99, and a last line prints
the error count, so a caller of the verb reads them without the dict.
"""

from __future__ import annotations

import argparse
import random
import threading
import time

import numpy as np

from .client import operation
from .client.master_client import MasterClient


class FakeReader:
    """Deterministic payloads (reference benchmark.go:546 FakeReader)."""

    def __init__(self, size: int, seed: int):
        rng = np.random.default_rng(seed)
        self.data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def _percentiles(lat: list[float]) -> dict:
    if not lat:
        return {"avg_ms": float("nan"), "p50_ms": float("nan"),
                "p95_ms": float("nan"), "p99_ms": float("nan"),
                "max_ms": float("nan")}
    arr = np.sort(np.array(lat))
    return {
        "avg_ms": float(arr.mean() * 1e3),
        "p50_ms": float(np.percentile(arr, 50) * 1e3),
        "p95_ms": float(np.percentile(arr, 95) * 1e3),
        "p99_ms": float(np.percentile(arr, 99) * 1e3),
        "max_ms": float(arr.max() * 1e3),
    }


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-masterHttp", default="",
                   help="master HTTP API address for fast-path assigns")
    p.add_argument("-n", type=int, default=10000, help="number of files")
    p.add_argument("-size", type=int, default=1024, help="file size bytes")
    p.add_argument("-c", type=int, default=16, help="concurrency")
    p.add_argument("-collection", default="benchmark")
    p.add_argument("-write", action="store_true", default=True)
    p.add_argument("-read", action="store_true", default=True)
    p.add_argument("-bulk", action="store_true", default=False,
                   help="batched ingest: fid-range leases + framed "
                        "/bulk PUTs instead of per-needle assign+PUT")
    p.add_argument("-batch", type=int, default=256,
                   help="needles per submit_batch call in -bulk mode")
    opt = p.parse_args(argv)

    mc = MasterClient(opt.master, http_address=opt.masterHttp).start()
    mc.wait_connected()
    payload = FakeReader(opt.size, 42).data

    fids: list[str] = []
    fid_lock = threading.Lock()
    write_lat: list[float] = []
    read_lat: list[float] = []
    errors = [0]

    # ONE allocator shared by every writer thread: that sharing is the
    # control-plane amortization under test (disjoint ranges per take)
    from .client.master_client import FidLeaseAllocator
    alloc = FidLeaseAllocator(mc, collection=opt.collection,
                              lease_count=max(4096, 4 * opt.batch))

    def writer(k: int):
        local_lat = []
        for i in range(k):
            t0 = time.perf_counter()
            try:
                res = operation.submit(mc, payload, collection=opt.collection,
                                       retries=2)
                with fid_lock:
                    fids.append(res.fid)
            except Exception:  # noqa: BLE001
                errors[0] += 1
            local_lat.append(time.perf_counter() - t0)
        with fid_lock:
            write_lat.extend(local_lat)

    def bulk_writer(k: int):
        # latencies are PER BATCH (one submit_batch = one+ framed PUTs);
        # rps stays per needle so bulk and per-op runs compare directly
        local_lat = []
        done = 0
        while done < k:
            n = min(opt.batch, k - done)
            t0 = time.perf_counter()
            try:
                res = operation.submit_batch(
                    mc, [payload] * n, collection=opt.collection,
                    allocator=alloc, retries=2)
                with fid_lock:
                    fids.extend(r.fid for r in res)
            except Exception:  # noqa: BLE001
                errors[0] += n
            local_lat.append(time.perf_counter() - t0)
            done += n
        with fid_lock:
            write_lat.extend(local_lat)

    def reader(k: int):
        local_lat = []
        with fid_lock:
            snapshot = list(fids)
        if not snapshot:
            return
        for _ in range(k):
            fid = random.choice(snapshot)
            t0 = time.perf_counter()
            try:
                operation.read(mc, fid)
            except Exception:  # noqa: BLE001
                errors[0] += 1
            local_lat.append(time.perf_counter() - t0)
        with fid_lock:
            read_lat.extend(local_lat)

    results = {}
    per_worker = opt.n // opt.c
    mode = f"bulk (batch {opt.batch})" if opt.bulk else "per-needle"
    print(f"writing {opt.n} x {opt.size}B files, concurrency {opt.c}, "
          f"{mode} ...")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=bulk_writer if opt.bulk else writer,
                                args=(per_worker,))
               for _ in range(opt.c)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wdt = time.perf_counter() - t0
    wrote = len(fids)
    results["write"] = {
        # requests = needles written; in bulk mode the latency
        # percentiles are per BATCH (what one client call experiences)
        "requests": wrote if opt.bulk else len(write_lat),
        "seconds": wdt,
        "rps": (wrote if opt.bulk else len(write_lat)) / wdt,
        "MBps": (wrote if opt.bulk else len(write_lat))
        * opt.size / wdt / 1e6,
        **_percentiles(write_lat),
    }
    if opt.bulk:
        results["write"]["batch"] = opt.batch
        results["write"]["leases"] = alloc.leases_taken
    print(f"  write: {results['write']['rps']:.1f} req/s "
          f"avg {results['write']['avg_ms']:.3f} ms "
          f"p50 {results['write']['p50_ms']:.3f} ms "
          f"p99 {results['write']['p99_ms']:.3f} ms")

    print(f"random-reading {opt.n} files, concurrency {opt.c} ...")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=reader, args=(per_worker,))
               for _ in range(opt.c)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rdt = time.perf_counter() - t0
    results["read"] = {
        "requests": len(read_lat), "seconds": rdt,
        "rps": len(read_lat) / rdt,
        "MBps": len(read_lat) * opt.size / rdt / 1e6,
        **_percentiles(read_lat),
    }
    print(f"  read: {results['read']['rps']:.1f} req/s "
          f"avg {results['read']['avg_ms']:.3f} ms "
          f"p50 {results['read']['p50_ms']:.3f} ms "
          f"p99 {results['read']['p99_ms']:.3f} ms")
    results["errors"] = errors[0]
    print(f"  errors {errors[0]}")
    mc.stop()
    return results
