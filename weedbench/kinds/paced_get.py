"""GETs of sealed EC volumes after racks are lost, offered above what
the servers sustain.

Set-up: the master and one volume server a rack start at once, each in
its own process, while the harness writes the seeded needles and encodes
them (K1); once the servers are up each rack's shards move into its
directory and each server mounts them; the servers of `lose_racks` are
stopped and the master forgets them; each live server is given CPUs of
its own (cluster.pin); a few GETs on every live server, healthy and
degraded, warm every path. The window: one load process
(weedbench/loadgen.py) with `workers` clients offers `objects_per_s`
objects a second at fixed arrival times, the same times for every seed,
each object a uniformly random one of the seed's picking: its chunk
needles in order, each from a live holder of the volume picked from the
seed, as a client that only looks the volume up does. The rate is
set above what the servers sustain, so the clients are never idle and
the GETs answered in the window are the system's capacity; a GET's
latency from its arrival then grows with the queue, so the tails are
`info` lines only, timed from when the GET was sent. The check: every
GET sent against the reference's bytes, and a seeded sample of every
shard file against the reference's striping and Reed-Solomon parity of
the .dat.

Mix keys: objects_per_s, workers (the clients: the load process's
threads, at most one GET in flight each), lose_racks, warm_gets (per
server and path), shard_windows (per volume), window_bytes.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time

import numpy as np

from .. import cluster as cl
from .. import traces, volumes
from ..reference import gf256, needles, stripes

def geometry(cfg: dict) -> stripes.Geometry:
    return stripes.Geometry(int(cfg["d"]), int(cfg["p"]),
                            int(cfg["large_block"]), int(cfg["small_block"]))


def prepare(run) -> None:
    cfg, tr = run.cfg, run.traffic
    c = run.cluster
    racks = volumes.rack_names(cfg)
    dirs = [os.path.join(run.workdir, r) for r in racks]
    staging = os.path.join(run.workdir, "staging")
    os.makedirs(staging)
    if run.device == "cuda":
        from seaweedfs_tpu_torch.ops import _build
        _build.build_all(["rs_gf"])
    run.mark("K1 built")
    vols = needles.generate(cfg, run.seed)
    run.data["vols"] = vols
    run.mark("needles generated")
    volumes.build_ec(cfg, vols, staging, run.device)
    run.mark("volumes written and encoded")
    if run.device == "cuda":
        import torch
        torch.cuda.empty_cache()
    n = int(cfg["d"]) + int(cfg["p"])
    holding = {i: [v.vid for v in vols] for i in range(len(racks))
               if any(volumes.shard_rack(cfg, s) == i for s in range(n))}
    for s in c.servers:
        c.wait(lambda s=s: cl.http_get(f"http://{s.http}/status",
                                       timeout=2)[0] == 200, 300,
               f"volume server {s.rack}")
    run.mark("servers up")
    volumes.place_ec(cfg, vols, staging, dirs)
    volumes.mount(c, cfg, holding)
    run.mark("shards mounted")
    peers = c.peers()
    want = {sid: c.servers[volumes.shard_rack(cfg, sid)].grpc
            for sid in range(n)}

    def placed(alive) -> bool:
        for v in vols:
            locs = peers.lookup_ec(v.vid)
            for sid, addr in want.items():
                if (addr in locs.get(sid, [])) != alive(addr):
                    return False
        return True

    c.wait(lambda: placed(lambda a: True), 120, "every shard at the master")
    run.mark("shards at the master")
    lost = [c.servers[racks.index(r)] for r in tr.get("lose_racks", [])]
    for s in lost:
        c.stop(s)
    gone = {s.grpc for s in lost}
    c.wait(lambda: placed(lambda a: a not in gone), 120,
           "the lost racks forgotten by the master")
    run.data["lost_shards"] = sorted(
        sid for sid in range(n)
        if c.servers[volumes.shard_rack(cfg, sid)].grpc in gone)
    run.mark("lost racks forgotten")
    cl.pin(c)
    _plan(run)
    run.mark("load started")
    _warm(run)
    run.mark("warmed up")


def _plan(run) -> None:
    """Each needle's server (its first run's shard's rack, -1 where that
    rack is lost), the arrivals, and the object and live holder each
    chunk GET of an arrival reads; the load process starts and waits for
    the window."""
    cfg, c, vols, tr = run.cfg, run.cluster, run.data["vols"], run.traffic
    geo = geometry(cfg)
    racks = int(cfg["racks"])
    alive = np.array([s.alive for s in c.servers])
    live = np.flatnonzero(alive)
    vid, key, cookie, primary, first = [], [], [], [], []
    for v in vols:
        srv = stripes.first_shard(geo, v.dat_size(), v.offsets()) % racks
        first.append(sum(len(x) for x in vid))
        vid.append(np.full(v.n, v.vid, np.int64))
        key.append(np.arange(1, v.n + 1, dtype=np.int64))
        cookie.append(v.cookies.astype(np.int64))
        primary.append(np.where(alive[srv], srv, -1))
    per = needles.chunks_per_object(cfg)
    objects = np.concatenate([
        first[vi] + np.arange(v.n).reshape(-1, per)
        for vi, v in enumerate(vols)])
    primary = np.concatenate(primary)
    run.data["first"] = np.array(first, np.int64)
    run.data["primary"] = primary
    # the same arrival times for every seed; the seed picks what they read
    n = int(round(float(tr["objects_per_s"]) * run.seconds))
    arrivals = np.sort(np.random.default_rng(0).uniform(0, run.seconds, n))
    rng = np.random.default_rng([run.seed & (2**63 - 1), 7])
    picked = objects[rng.integers(0, len(objects), n)]
    server = live[rng.integers(0, len(live), picked.shape)]
    plan = os.path.join(run.workdir, "plan.npz")
    np.savez(plan, urls=np.array([s.http for s in c.servers]),
             vid=np.concatenate(vid), key=np.concatenate(key),
             cookie=np.concatenate(cookie), objects=picked, server=server,
             arrivals=arrivals, workers=int(tr["workers"]))
    out = os.path.join(run.workdir, "gets.npz")
    proc = subprocess.Popen(
        [sys.executable, "-m", "weedbench.loadgen", plan, out],
        cwd=str(run.root), env=dict(run.env, OMP_NUM_THREADS="1"),
        stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    run.cluster.others.append(proc)
    run.data["load"] = (proc, out)


def _warm(run) -> None:
    """`warm_gets` GETs on every live server, all servers at once, of
    needles it holds and of needles whose shard is lost: every path and
    shape the window takes."""
    from concurrent.futures import ThreadPoolExecutor
    c, vols = run.cluster, run.data["vols"]
    primary, first = run.data["primary"], run.data["first"]
    rng = np.random.default_rng([run.seed & (2**63 - 1), 99])
    want = int(run.traffic.get("warm_gets", 8))
    jobs = []
    for i, s in enumerate(c.servers):
        if not s.alive:
            continue
        picks = []
        for pool in (np.flatnonzero(primary == i),
                     np.flatnonzero(primary < 0)):
            if len(pool):
                picks += rng.choice(pool, size=min(want, len(pool)),
                                    replace=False).tolist()
        jobs.append((s, picks))

    def warm(job) -> int:
        s, picks = job
        bad = 0
        for g in picks:
            vi = int(np.searchsorted(first, g, side="right") - 1)
            k = int(g - first[vi])
            v = vols[vi]
            code, body = cl.http_get(
                f"http://{s.http}/{v.vid},{k + 1:x}{int(v.cookies[k]):08x}",
                timeout=120)
            bad += code != 200 or body != v.needle(k)
        return bad

    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        run.data["warm_bad"] = sum(pool.map(warm, jobs))


def measure(run, t0: float) -> float:
    if run.trace:
        traces.capture_start(run)
    run.t_start = time.monotonic() + 0.05
    run.t_end = run.t_start + run.seconds
    setup_s = run.t_start - t0
    proc, out = run.data["load"]
    cpu0 = run.cluster.cpu_seconds()
    proc.stdin.write(f"{run.t_start!r} {run.seconds!r}\n".encode())
    proc.stdin.close()
    proc.stdin = None
    try:
        _, err = proc.communicate(timeout=run.seconds + 180)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"load generator failed: {err.decode()[-2000:]}")
    cpu1 = run.cluster.cpu_seconds()
    run.data["cpu_s"] = {r: round(cpu1[r] - cpu0.get(r, 0.0), 3)
                         for r in cpu1}
    with np.load(out) as z:
        run.data["gets"] = {k: z[k] for k in z.files}
    run.window_s = run.seconds
    if run.trace:
        traces.capture_end(run)
    return setup_s


def release(run) -> None:
    run.cluster.close()


def _expected(run, gs: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Digest and length of the reference's bytes of needles `gs`."""
    vols, first = run.data["vols"], run.data["first"]
    cache: dict = {}
    dig = np.empty(len(gs), "S16")
    size = np.empty(len(gs), np.int64)
    for j, g in enumerate(gs.tolist()):
        if g not in cache:
            vi = int(np.searchsorted(first, g, side="right") - 1)
            data = vols[vi].needle(g - int(first[vi]))
            cache[g] = (hashlib.blake2b(data, digest_size=16).digest(),
                        len(data))
        dig[j], size[j] = cache[g]
    return dig, size


def _shard_bytes_wrong(run) -> int:
    """Bytes that differ between a seeded sample of every shard file (its
    data shards against the reference's striping of the .dat, its parity
    shards against the reference's parity of those) and the files."""
    cfg, vols = run.cfg, run.data["vols"]
    geo = geometry(cfg)
    d, p = geo.d, geo.p
    width = int(run.traffic.get("window_bytes", 4096))
    rng = np.random.default_rng([run.seed & (2**63 - 1), 77])
    racks = volumes.rack_names(cfg)
    wrong = 0
    for v in vols:
        name = volumes.base_name(cfg["collection"], v.vid)
        dat = os.path.join(run.workdir, "staging", name + ".dat")
        size = v.dat_size()
        shard_size = geo.shard_size(size)
        with open(dat, "rb") as f:
            buf = f.read()
        files = [os.path.join(run.workdir,
                              racks[volumes.shard_rack(cfg, s)],
                              f"{name}.ec{s:02d}") for s in range(d + p)]
        for _ in range(int(run.traffic.get("shard_windows", 16))):
            off = int(rng.integers(0, max(1, shard_size - width)))
            w = min(width, shard_size - off)
            rows = np.zeros((d, w), np.uint8)
            for s in range(d):
                pos = 0
                while pos < w:  # block by block: a window may cross rows
                    lo = geo.logical(size, s, off + pos)
                    take = min(w - pos, geo.block_left(size, off + pos))
                    got = np.frombuffer(buf[lo:lo + take], np.uint8)
                    rows[s, pos:pos + len(got)] = got
                    pos += take
            want = np.concatenate([rows, gf256.parity(rows, p)])
            for s in range(d + p):
                with open(files[s], "rb") as f:
                    f.seek(off)
                    have = np.frombuffer(f.read(w), np.uint8)
                if len(have) != w:
                    wrong += w
                else:
                    wrong += int(np.count_nonzero(have != want[s]))
    return wrong


def check(run) -> dict:
    """Every GET sent against the reference's bytes."""
    g = run.data["gets"]
    dig, size = _expected(run, g["g"])
    ok = (g["status"] == 200) & (g["nbytes"] == size) & (g["digest"] == dig)
    run.data["ok"] = ok
    run.attempted = int(len(ok))
    run.failed = int(np.count_nonzero(~ok))
    return {"gets_wrong": {"value": run.failed, "limit": 0},
            "gets_compared_none": {"value": int(len(ok) == 0), "limit": 0},
            "warm_gets_wrong": {"value": int(run.data["warm_bad"]),
                                "limit": 0},
            "shard_bytes_wrong": {"value": _shard_bytes_wrong(run),
                                  "limit": 0}}


def end_to_end(run) -> dict:
    """GETs answered with the exact bytes inside the window, a second."""
    g, ok = run.data["gets"], run.data["ok"]
    answered = int(np.count_nonzero(ok & (g["t1"] <= run.t_end)))
    return {"get_rps": answered / run.seconds}


def info(run) -> dict:
    """Latency from when each GET was sent, of the needles whose first
    shard's server is live and of those whose server is lost;
    answered GETs by stretch of the window; the clients' busy share; the
    servers' degraded reads (trace runs)."""
    from .. import promstat
    g, ok = run.data["gets"], run.data["ok"]
    lat = g["t1"] - g["sent"]
    lost = run.data["primary"][g["g"]] < 0
    out = {}
    for name, sel in (("shard_live", ~lost & ok), ("shard_lost", lost & ok)):
        if sel.any():
            q = np.percentile(lat[sel], [50, 95]) * 1e3
            out[f"get_ms_{name}"] = (f"n {int(sel.sum())} p50 {q[0]:.3f} "
                                     f"p95 {q[1]:.3f}")
    done = g["t1"][ok & (g["t1"] <= run.t_end)] - run.t_start
    edges = np.arange(0, run.seconds + 1e-9, max(1.0, run.seconds / 10))
    out["get_rps_by_interval"] = [
        round(float(n / w), 1) for n, w in zip(
            np.histogram(done, edges)[0], np.diff(edges))]
    inside = np.clip(np.minimum(g["t1"], run.t_end)
                     - np.maximum(g["sent"], run.t_start), 0, None)
    out["clients_busy_pct"] = round(float(
        100 * inside.sum() / (int(run.traffic["workers"]) * run.seconds)), 3)
    out["daemon_cpu_s"] = run.data.get("cpu_s")
    if run.scrape_delta:
        out["degraded_reads"] = sum(
            promstat.total(s, "SeaweedFS_degraded_ec_reads_total")
            for s in run.scrape_delta.values())
    return out
