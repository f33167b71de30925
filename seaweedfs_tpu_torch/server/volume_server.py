"""Volume server core: the HTTP data plane, the EC read plane and the RPC
bodies of a volume server, over a Store of the port.

Port of seaweedfs_tpu/server/volume_server.py (reference
weed/server/volume_server*.go, volume_grpc_*.go, store_ec.go:357-400) in
two parts. This module is the core: it imports neither `grpc` nor
`google.protobuf`, so it runs wherever the port does. Each RPC is a method
named after it in snake case that takes plain arguments and returns plain
values; `server/grpc_service.py` binds them to the wire and feeds the
master's heartbeat. Another server is reached only through the peer plane
`VolumeServer.peers`: `LocalPeers` joins servers of one process, and
`grpc_service.GrpcPeers` reaches them over gRPC.

`make_shard_reader` is the degraded read as a function of a Store:
`fetch(sid, offset, length) -> bytes | None` serves a remote shard and
`fetch_fragment(sid, ranges) -> bytes | None` its ranged-compute fetch.
All three codecs are served: plain RS positionally, piggyback with its
strip of a load-bearing piggybacked parity, msr through the codec's
interval plans. `VolumeServer._make_shard_reader` wraps it with the
location cache, the breakers, the stale-location refresh and the last
probe of circuit-open holders.

The replicated data plane: a write or delete of a volume whose placement
needs copies fans out to the other holders (`peers.lookup_volume`, the
master's LookupVolume) over HTTP (`client/http_util.send`, run off the
loop); a GET of a volume this server lacks is proxied to a holder or
redirected there (`read_mode`); `/bulk` and `/bulk-read` take the framed
batches of storage/bulk.py; plain-volume GETs go through the hot-needle
read cache; a `security.Guard` checks every request.

The maintenance plane: a `qos.QosScheduler` admits every HTTP request per
tenant (the volume's collection), answering a shed with 503 and
Retry-After, and is read and retuned at `/debug/qos`; the repair RPCs run
maintenance-class, so their CopyFile pulls and shard reads admit against
the serving node's maintenance budget. VolumeCopy, the tail and
incremental sync, BatchDelete, VolumeConfigure, VolumeServerLeave,
VolumeNeedleStatus and Query are RPC bodies here like the others.

The profiling plane: the read pools are `profiling.MonitoredPool`s and a
`LoopLagMonitor` probes the HTTP loop; the process-wide sampler is held from
`start` to `stop`; every request's stages go to VOLUME_STAGE_SECONDS, the
slow and failed ones to the flight recorder with the loop lag and queue
depths at admit, and every request to the hot-key sketches
(`telemetry.hot`) behind the `SeaweedFS_hot_*` gauges. The debug routes
(`/debug/profile`, `/debug/flight`, `/debug/traces`, `/debug/events`,
`/debug/locks`, `/debug/failpoints`, `/debug/lifecycle`,
`/debug/jax-profiler`, which captures through torch.profiler) and the
status page `/ui` answer as the reference's do. A GET with `width` /
`height` of an image needle is resized on the host (`images/`).
"""

from __future__ import annotations

import concurrent.futures as cf
import contextvars
import functools
import gzip
import json
import os
import threading
import time
import urllib.parse
from typing import Callable, Optional

import numpy as np

from .. import qos, tracing
from ..ec import files as ec_files
from ..ec import repair as ec_repair
from ..ec.encoder import rebuild_shards
from ..ec.locate import EcGeometry
from ..ops import events
from ..ops.coder import host_result
from ..stats import DEGRADED_EC_READS
from ..telemetry.hot import record as hot_record
from ..storage.needle import Needle
from ..storage.store import TIER_TRASH
from ..storage.types import TTL, ReplicaPlacement, parse_file_id
from ..storage.vacuum import commit_compact, compact
from ..utils import failpoints, fsutil, retry
from ..utils.log import logger

log = logger("volume_server")

# fetch(shard_id, offset, length) -> the bytes, or None when no holder
# answered
Fetch = Callable[[int, int, int], Optional[bytes]]
# fetch_fragment(shard_id, [(offset, length), ...]) -> the ranges' bytes
# packed in order, or None when no holder answered
FetchFragment = Callable[[int, list], Optional[bytes]]


def _joined(fetch: Fetch) -> FetchFragment:
    """fetch_fragment over `fetch`: one ranged fetch per range."""
    def fetch_fragment(sid: int, ranges) -> "bytes | None":
        parts = []
        for off, ln in ranges:
            data = fetch(sid, off, ln)
            if data is None:
                return None
            parts.append(data)
        return b"".join(parts)
    return fetch_fragment


def make_shard_reader(store, vid: int, fetch: Fetch,
                      pool: cf.Executor, stats: "dict | None" = None,
                      fetch_fragment: "FetchFragment | None" = None,
                      direct: "Fetch | None" = None,
                      probe: "Fetch | None" = None,
                      lock: "threading.Lock | None" = None):
    """A `shard_reader(shard_id, offset, length) -> bytes` for EC volume
    `vid` of `store`: `direct` (by default `fetch`) serves the shard
    itself; when it gives None, the interval is reconstructed — from d
    other shards for plain RS and piggyback, local ones first, the rest
    fetched concurrently on `pool` through `fetch` until d have answered,
    then, as a last resort, one by one through `probe` when it is given;
    from the msr interval plan's layer slices (`fetch_fragment`, by default
    `fetch` joined over the ranges) for msr. Fewer survivors than the
    decode needs raises OSError (an availability failure, not a lookup
    miss). The GF steps run on `store.coder` (kernel K1 on the card).

    Every degraded interval counts one SeaweedFS_degraded_ec_reads_total.
    `stats`, when given, accumulates `reconstructs` (degraded intervals),
    `gather_s` (survivor reads and fetches), `decode_s` (the decode with
    its coder calls and, for the piggyback strip, its paired a-range
    fetches), `fetch_bytes` (survivor bytes gathered for the decodes),
    `strips` (piggyback intervals whose b-half span was decoded through a
    piggybacked parity, its piggyback stripped with the paired a-range)
    and `msr_mode` (msr intervals by plan mode: "repair", "general", or
    the modes of a ragged span's pieces joined by "+"); `lock` guards it
    when readers share it."""
    mu = lock or threading.Lock()
    fetch_fragment = fetch_fragment or _joined(fetch)
    direct = direct or fetch

    def reader(shard_id: int, offset: int, length: int) -> bytes:
        data = direct(shard_id, offset, length)
        if data is not None:
            return data
        return _reconstruct(shard_id, offset, length)

    def _count(t0: float, t1: float, fetched: int, **kinds) -> None:
        DEGRADED_EC_READS.inc()  # one logical degraded read
        if stats is None:
            return
        t2 = time.perf_counter()
        with mu:
            stats["reconstructs"] = stats.get("reconstructs", 0) + 1
            stats["gather_s"] = stats.get("gather_s", 0.0) + t1 - t0
            stats["decode_s"] = stats.get("decode_s", 0.0) + t2 - t1
            stats["fetch_bytes"] = stats.get("fetch_bytes", 0) + fetched
            if kinds.get("strip"):
                stats["strips"] = stats.get("strips", 0) + 1
            mode = kinds.get("msr_mode")
            if mode:
                modes = stats.setdefault("msr_mode", {})
                modes[mode] = modes.get(mode, 0) + 1

    def _checked(sid: int, data: bytes, offset: int, length: int) -> bytes:
        if len(data) != length:
            raise OSError(f"short read of shard {sid} at {offset}: "
                          f"{len(data)} of {length} B")
        return data

    def _reconstruct(shard_id: int, offset: int, length: int) -> bytes:
        t0 = time.perf_counter()
        ev = store.find_ec_volume(vid)
        if ev is None:
            raise KeyError(f"shard {shard_id} unreachable")
        if ev.codec == "msr":
            # the coupled code is not positional: degraded reads fetch the
            # interval plan's layer slices
            return _reconstruct_msr(ev, shard_id, offset, length, t0)
        geo = ev.geo
        piggybacked = ev.codec == "piggyback"
        gathered: dict[int, bytes] = {}
        remote_sids = []
        for sid in range(geo.n):
            if sid == shard_id:
                continue
            local = ev.shards.get(sid)
            if local is not None and len(gathered) < geo.d:
                gathered[sid] = _checked(sid, local.read_at(offset, length),
                                         offset, length)
            elif local is None:
                remote_sids.append(sid)
        # piggybacked volumes: shards 0..d (data + the unpiggybacked
        # parity) decode positionally anywhere, so fetch those first and
        # touch piggybacked parities only when the plain set cannot reach d
        if piggybacked:
            waves = [[s for s in remote_sids if s <= geo.d],
                     [s for s in remote_sids if s > geo.d]]
        else:
            waves = [remote_sids]
        for wave in waves:
            if len(gathered) >= geo.d or not wave:
                continue
            # fetched concurrently: sequential fetches would stack one
            # round trip per shard onto the degraded latency
            futs = {pool.submit(fetch, sid, offset, length): sid
                    for sid in wave}
            for fut in cf.as_completed(futs):
                data = fut.result()
                if data is not None:
                    sid = futs[fut]
                    gathered[sid] = _checked(sid, data, offset, length)
                if len(gathered) >= geo.d:
                    for f in futs:  # stop fetches nobody will use
                        f.cancel()
                    break
        if len(gathered) < geo.d and probe is not None:
            # the healthy holders alone cannot reach d: probe the rest (the
            # circuit-open holders) too — an open breaker should cost
            # latency, never turn a recoverable read into an error
            for sid in remote_sids:
                if sid in gathered or len(gathered) >= geo.d:
                    continue
                data = probe(sid, offset, length)
                if data is not None:
                    gathered[sid] = _checked(sid, data, offset, length)
        if len(gathered) < geo.d:
            raise OSError(f"cannot reconstruct shard {shard_id}: only "
                          f"{len(gathered)} shards reachable")
        t1 = time.perf_counter()
        present = tuple(sorted(gathered))[:geo.d]
        coder = store.coder(geo.d, geo.p, codec=ev.codec)
        fetched = geo.d * length
        if piggybacked and any(s > geo.d for s in present):
            # a piggybacked parity is load-bearing: strip its piggyback
            # with the paired a-range (ec/repair.reconstruct_interval)
            def fetch_pair(sid: int, off: int, ln: int) -> bytes:
                nonlocal fetched
                local = ev.shards.get(sid)
                data = (local.read_at(off, ln) if local is not None
                        else fetch(sid, off, ln))
                if data is None:
                    raise OSError(f"cannot reconstruct shard {shard_id}: "
                                  f"paired range of shard {sid} unreachable")
                with mu:  # runs on the pool's threads
                    fetched += len(data)
                return _checked(sid, data, off, ln)

            def fetch_map(fn, reqs):
                # fanned out like the gather: one serial round trip per
                # paired range would stack onto the degraded latency
                futs = [pool.submit(fn, *r) for r in reqs]
                return [f.result() for f in futs]
            out_b = ec_repair.reconstruct_interval(
                coder, {s: gathered[s] for s in present}, shard_id, offset,
                length, ev.shard_size, fetch_pair, fetch_map=fetch_map)
            _count(t0, t1, fetched,
                   strip=offset + length > ev.shard_size // 2)
            return out_b
        inner = coder.inner if piggybacked else coder
        survivors = np.stack([np.frombuffer(gathered[s], dtype=np.uint8)
                              for s in present])
        out = host_result(inner.reconstruct(survivors, present, (shard_id,)))
        _count(t0, t1, fetched)
        return out[0].tobytes()

    def _fetch_plan(ev, plan) -> "dict[int, bytes | None]":
        """One IntervalPlan's per-survivor fragments — local shards by
        pread, remote by `fetch_fragment` — fanned out on the pool. None
        marks a helper that did not answer."""
        def one(sid: int) -> "bytes | None":
            ranges = plan.byte_ranges(sid)
            local = ev.shards.get(sid)
            try:
                if local is not None:
                    return b"".join(local.read_at(o, ln) for o, ln in ranges)
                return fetch_fragment(sid, ranges)
            except OSError as e:
                log.warning("msr fragment %d.%d: %s", vid, sid, e)
                return None

        futs = {pool.submit(one, sid): sid for sid in plan.fetch}
        return {futs[f]: f.result() for f in cf.as_completed(futs)}

    def _reconstruct_msr(ev, shard_id: int, offset: int, length: int,
                         t0: float) -> bytes:
        geo = ev.geo
        coder = store.coder(geo.d, geo.p, codec="msr")
        sub = ev.shard_size // coder.alpha
        ragged = sub and (offset % sub or (offset + length) % sub)
        if ragged and offset // sub != (offset + length - 1) // sub:
            # a span crossing sub-symbol boundaries would widen the shared
            # inner window to the full sub-symbol width: split it into at
            # most three pieces — partial head, layer-aligned middle (one
            # plan: every interior byte is wanted), partial tail
            end = offset + length
            cuts = [offset]
            head_end = -(-offset // sub) * sub   # round up
            mid_end = (end // sub) * sub         # round down
            if offset < head_end:
                cuts.append(head_end)
            if head_end < mid_end:
                cuts.append(mid_end)
            if cuts[-1] != end:
                cuts.append(end)
            pieces = [_msr_piece(ev, coder, shard_id, a, b - a)
                      for a, b in zip(cuts, cuts[1:])]
        else:
            pieces = [_msr_piece(ev, coder, shard_id, offset, length)]
        t1 = t0 + sum(g for _, _, _, g in pieces)
        out = b"".join(buf for buf, _, _, _ in pieces)
        _count(t0, t1, sum(fb for _, _, fb, _ in pieces),
               msr_mode="+".join(m for _, m, _, _ in pieces))
        return out

    def _msr_piece(ev, coder, shard_id: int, offset: int,
                   length: int) -> "tuple[bytes, str, int, float]":
        """(bytes, plan mode, fetch bytes, gather seconds) for one
        boundary-aligned (or single-layer) span of the lost shard."""
        geo = ev.geo
        t0 = time.perf_counter()
        helpers = tuple(s for s in range(geo.n) if s != shard_id)
        plan = coder.interval_plan(helpers, shard_id, offset, length,
                                   ev.shard_size)
        got = _fetch_plan(ev, plan)
        if any(v is None for v in got.values()):
            # a helper is down: closure-restricted decode over d survivors
            # that DID answer (one retry; a second wave of failures means
            # the stripe is unreadable)
            present = tuple(s for s, v in got.items() if v is not None)
            if len(present) < geo.d:
                raise OSError(f"cannot reconstruct shard {shard_id}: only "
                              f"{len(present)} msr helpers reachable")
            plan = coder.interval_plan(present, shard_id, offset, length,
                                       ev.shard_size)
            got = _fetch_plan(ev, plan)
            if any(v is None for v in got.values()):
                raise OSError(f"cannot reconstruct shard {shard_id}: msr "
                              "survivors unreachable")
        gather_s = time.perf_counter() - t0
        return (coder.interval_decode(plan, got), plan.mode,
                plan.bytes_total(), gather_s)

    return reader


# -- the volume server core ---------------------------------------------------

# gRPC status codes the RPC bodies abort with (grpc.StatusCode values)
INVALID_ARGUMENT, NOT_FOUND, ALREADY_EXISTS = 3, 5, 6
FAILED_PRECONDITION, INTERNAL, UNAVAILABLE = 9, 13, 14

# "local": a volume this server lacks reads 404; "proxy": the GET is
# forwarded to a holder; "redirect": answered with a 301 to a holder
READ_MODES = ("local", "proxy", "redirect")

# VolumeTailSender polls the volume for new records this often; its idle
# timeout counts these ticks
TAIL_TICK_SECONDS = 1.0


class RpcAbort(Exception):
    """An RPC body's refusal with a gRPC status code (the reference's
    `context.abort(code, message)`); the binding aborts the call with it."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def _observe_stages(kind: str, t_recv: float, t_parsed: float, t0: float,
                    t_admit, t_done, t_end: float) -> dict:
    """Per-stage timing of one request into VOLUME_STAGE_SECONDS: recv/parse
    (first wire byte -> request parsed), queue_wait (parsed -> handler
    entry), auth/admit (QoS admission), store (the handler itself) and
    serialize/flush (response build and accounting). The five cover the
    whole wire-to-wire interval. t_admit/t_done may be None on shed and
    error paths (the stage collapses to zero and the tail lands in
    serialize_flush). Returns the stage dict for the flight recorder."""
    from ..stats import VOLUME_STAGE_SECONDS
    a = t_admit if t_admit is not None else t0
    d = t_done if t_done is not None else a
    r = t_recv or t_parsed or t0
    p = t_parsed or r
    stages = {
        "recv_parse": max(0.0, p - r),
        "queue_wait": max(0.0, t0 - p),
        "auth_admit": max(0.0, a - t0),
        "store": max(0.0, d - a),
        "serialize_flush": max(0.0, t_end - d),
    }
    for stage, v in stages.items():
        VOLUME_STAGE_SECONDS.observe(kind, stage, value=v)
    return stages


def _vid_of_path(path: str) -> "str | None":
    head = path.lstrip("/").split(",", 1)[0]
    return head if head.isdigit() else None


def _maintenance_tagged(fn):
    """Run an RPC body maintenance-class: these RPCs exist only as repair,
    replication and rebalance machinery, so their nested reads (survivor
    fetches, CopyFile pulls from peers) carry the tag and yield to
    foreground work wherever they land, even when an operator drives them
    by hand."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with qos.tagged(qos.CLASS_MAINTENANCE):
            return fn(*args, **kw)
    return wrapped


def _ec_stage_fields(stats: dict) -> dict:
    """ec.encode.finish event fields from an encode pipeline stats dict:
    the stage split and the overlap fraction, so /debug/events shows where
    an encode spent its wall time without pulling the trace."""
    fields = {}
    for key in ("fill_s", "dispatch_s", "coder_s", "drain_block_s",
                "write_s", "write_block_s", "wall_s"):
        if key in stats:
            fields[key] = round(stats[key], 3)
    for key in ("write_overlap", "writers", "batches", "mode"):
        if key in stats:
            fields[key] = stats[key]
    return fields


def _parse_range(value: "str | None"):
    """One single-range `bytes=` spec, or None for absent / invalid /
    multi-range (those serve the full body, per RFC 7233's allowance to
    ignore unsupported Range headers). Returns ("suffix", n) |
    ("from", start) | ("range", start, last)."""
    if not value or not value.startswith("bytes="):
        return None
    spec = value[len("bytes="):].strip()
    if "," in spec:
        return None
    first, sep, last = spec.partition("-")
    if not sep:
        return None
    first, last = first.strip(), last.strip()
    try:
        if not first:
            n = int(last)
            return ("suffix", n) if n > 0 else None
        start = int(first)
        if start < 0:
            return None
        if not last:
            return ("from", start)
        stop = int(last)
        return ("range", start, stop) if stop >= start else None
    except ValueError:
        return None


def _resolve_range(spec, size: int) -> "tuple[int, int] | None":
    """[start, stop) byte window of `spec` over a `size`-byte body, or None
    when unsatisfiable (RFC 7233: start past the end)."""
    if spec[0] == "suffix":
        if size == 0:
            return None
        return max(0, size - spec[1]), size
    start = spec[1]
    if start >= size:
        return None
    if spec[0] == "from":
        return start, size
    return start, min(spec[2] + 1, size)


class VolumeServer:
    """One volume server over `store`: its device is the Store's ("cuda"
    unless the Store was built with device="cpu"). `start()` and `stop()`
    run the HTTP data plane only; the gRPC binding and the master's
    heartbeat stream live in server/grpc_service.py, which sets the gRPC
    port (by default port + 10000). `peers` is the peer plane (LocalPeers
    or grpc_service.GrpcPeers); `peer_address` is the address peers know
    this server by (ip:grpc_port, the master's convention). `guard` (a
    security.Guard) checks writes, reads and bulk frames; `read_mode` is
    one of READ_MODES. `qos_policy` (a policy document, or the path of a
    JSON file that is reloaded when it changes) turns on QoS admission;
    without one admission is off and costs nothing."""

    # shard-location cache staleness tiers (store_ec.go:256-267): complete
    # location sets refresh every 37 min, incomplete every 7 min, and a
    # failed read may force a refresh after 11 s — the master is off the
    # EC read hot path
    _EC_LOC_TTL_COMPLETE = 37 * 60
    _EC_LOC_TTL_INCOMPLETE = 7 * 60
    _EC_LOC_TTL_FAILED = 11

    def __init__(self, store, ip: str = "127.0.0.1", port: int = 8080,
                 data_center: str = "", rack: str = "", peers=None,
                 pulse_seconds: float = 2.0, read_mode: str = "proxy",
                 guard=None, qos_policy: "dict | str | None" = None):
        if read_mode not in READ_MODES:
            raise ValueError(f"read mode {read_mode!r}: one of "
                             f"{', '.join(READ_MODES)}")
        from ..profiling import LoopLagMonitor, MonitoredPool
        from ..storage import read_cache
        from ..utils.env import env_int
        self.store = store
        self.device = store.device
        self.ip = ip
        self.port = port
        self.grpc_port = port + 10000
        self.peer_address = f"{ip}:{self.grpc_port}"
        self.data_center = data_center
        self.rack = rack
        self.peers = peers
        self.pulse_seconds = pulse_seconds
        self.read_mode = read_mode
        self.guard = guard
        # the master quorum, set by the gRPC binding (shown by /ui)
        self.masters: "list[str]" = []
        # the hot-needle cache under plain-volume GETs and bulk reads
        # (SWTPU_READ_CACHE_MB=0 disables it)
        self.read_cache = read_cache.default_cache()
        # replica sets for the write fan-out (see _lookup_replicas_cached)
        self._replica_cache: dict[int, tuple[float, list[str]]] = {}
        # set by the heartbeat binding: blocks until the master ingested a
        # heartbeat covering every change before the call
        self.heartbeat_flush: "Callable[[], bool] | None" = None
        # read-plane counters the degraded read moves (the reference's
        # trace events, kept countable): stale_locations_refreshed,
        # last_probes, and make_shard_reader's reconstructs/gather_s/...
        self.read_stats: dict = {}
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._http_thread: "threading.Thread | None" = None
        # EC shard-location cache (store_ec.go:256-267) and the degraded
        # read's fan-out pool (store_ec.go:367)
        self._ec_loc_cache: dict[int, tuple[dict, float, bool]] = {}
        self._ec_loc_lock = threading.Lock()
        # (queue-accounted: depth and wait per {pool} label, the depths at
        # admit in flight entries)
        self._ec_read_pool = MonitoredPool(
            "ec_read", max_workers=16, thread_name_prefix=f"ec-read-{port}")
        self._read_pool = MonitoredPool(
            "read", max_workers=max(1, env_int("SWTPU_READ_THREADS", 8)),
            thread_name_prefix=f"vs-read-{port}")
        # blocking HTTP hops to peers (replica fan-out, proxy reads): a
        # pool of their own, so a hop never waits on a worker that the
        # peer's handler needs in the same process
        self._hop_pool = cf.ThreadPoolExecutor(
            max_workers=16, thread_name_prefix=f"vs-hop-{port}")
        # the profiling plane: the loop-lag probe (installed on the HTTP
        # loop by serve_fast_app's on_loop hook) and the process-shared
        # sampler (held from start() to stop())
        self._loop_lag = LoopLagMonitor("volume")
        self._sampler = None
        # the lifecycle heat epoch: read counters live in memory, so this
        # server can attest "quiet for <= uptime" only
        self._started_mono = time.monotonic()
        self._scrub_cursor = 0
        self._gauge_keys: dict[str, set] = {}
        # multi-tenant QoS (qos/): tenant = the volume's collection;
        # None or an empty policy = admission off
        self.qos = qos.QosScheduler(name=f"volume-{port}")
        if isinstance(qos_policy, str) and qos_policy:
            self.qos.attach_file(qos_policy)
        elif qos_policy:
            self.qos.load(qos_policy)
        # set by VolumeServerLeave: the heartbeat stops, so the master and
        # LocalPeers forget this server; the HTTP plane keeps serving
        self.left = threading.Event()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.read_stats[key] = self.read_stats.get(key, 0) + n

    # -- lifecycle ------------------------------------------------------------
    def start(self, timeout: float = 10.0) -> None:
        """Serve the HTTP plane on a thread; returns once it accepts."""
        import socket

        from ..profiling import acquire_sampler
        self._http_thread = threading.Thread(
            target=self._run_http, daemon=True, name=f"vs-http-{self.port}")
        self._http_thread.start()
        deadline = time.monotonic() + timeout
        while True:
            try:
                socket.create_connection((self.ip, self.port),
                                         timeout=0.5).close()
                break
            except OSError:
                if not self._http_thread.is_alive():
                    raise RuntimeError(f"volume server {self.url}: the HTTP "
                                       "plane failed to start")
                if time.monotonic() > deadline:
                    self.stop()
                    raise TimeoutError(f"volume server {self.url}: HTTP plane "
                                       f"not up within {timeout} s")
                time.sleep(0.02)
        self._sampler = acquire_sampler()
        log.info("volume server %s up on %s", self.url, self.device)

    def stop(self) -> None:
        """Join the HTTP thread, shut the pools down, release the sampler,
        close the Store."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
        for pool in (self._ec_read_pool, self._read_pool, self._hop_pool):
            pool.shutdown(wait=True, cancel_futures=True)
        self._loop_lag.close()
        if self._sampler is not None:
            from ..profiling import release_sampler
            release_sampler()
            self._sampler = None
        self.qos.close()
        self.store.close()

    def flush_heartbeat(self) -> bool:
        """Make a mutation visible to the master before the RPC returns
        (the binding's flush); False when no heartbeat stream is bound."""
        fn = self.heartbeat_flush
        if fn is None or self.left.is_set():
            return False  # no heartbeat stream to ack (or it has left)
        return fn()

    # -- heartbeat ------------------------------------------------------------
    def heartbeat(self) -> dict:
        """One pulse of the reference's _heartbeat_messages as a plain dict
        with the fields of master.proto's Heartbeat. Runs the per-pulse
        housekeeping first: the reap of EC volumes past their DestroyTime
        (journaled and metered like every tier move), then the idle close
        of EC shard handles."""
        try:
            reaped = self.store.delete_expired_ec_volumes()
            if reaped:
                from ..stats import (LIFECYCLE_BYTES_MOVED,
                                     LIFECYCLE_TRANSITIONS)
                for rec in reaped:
                    events.emit("lifecycle.transition", kind="reap",
                                vid=rec["vid"], node=self.url,
                                collection=rec["collection"],
                                **{"from": rec["from"], "to": TIER_TRASH},
                                bytes_moved=rec["bytes"])
                    LIFECYCLE_TRANSITIONS.inc(rec["from"], TIER_TRASH)
                    LIFECYCLE_BYTES_MOVED.inc(rec["from"], TIER_TRASH,
                                              amount=rec["bytes"])
                log.info("reaped expired ec volumes %s",
                         [r["vid"] for r in reaped])
            self.store.close_idle_ec_handles()
        except Exception as e:  # noqa: BLE001 — housekeeping never stops a pulse
            log.warning("ec housekeeping: %s", e)
        hb = self.store.collect_heartbeat()
        self._update_gauges(hb)
        return {
            "ip": self.ip, "port": self.port, "grpc_port": self.grpc_port,
            "public_url": self.store.public_url,
            "max_file_key": hb["max_file_key"],
            "data_center": self.data_center, "rack": self.rack,
            "max_volume_counts": hb["max_volume_counts"],
            "has_no_volumes": not hb["volumes"],
            "has_no_ec_shards": not hb["ec_shards"],
            "volumes": hb["volumes"], "ec_shards": hb["ec_shards"],
        }

    def _update_gauges(self, hb: dict) -> None:
        """Volume/EC/disk gauges from heartbeat state (store_ec.go:41);
        label sets seen before but absent now are zeroed."""
        from ..stats import (VOLUME_SERVER_DISK_SIZE_GAUGE,
                             VOLUME_SERVER_EC_SHARD_GAUGE,
                             VOLUME_SERVER_VOLUME_GAUGE)
        per: dict = {}
        size: dict = {}
        for v in hb["volumes"]:
            key = (v["collection"], v["disk_type"])
            per[key] = per.get(key, 0) + 1
            size[key] = size.get(key, 0) + v["size"]
        ec_per: dict = {}
        for s in hb["ec_shards"]:
            key = (s["collection"],)
            ec_per[key] = ec_per.get(key, 0) + bin(s["ec_index_bits"]).count("1")
        for gauge, cur, name in (
                (VOLUME_SERVER_VOLUME_GAUGE, per, "vol"),
                (VOLUME_SERVER_DISK_SIZE_GAUGE, size, "size"),
                (VOLUME_SERVER_EC_SHARD_GAUGE, ec_per, "ec")):
            for key in self._gauge_keys.get(name, set()) - set(cur):
                gauge.set(*key, value=0)
            for key, n in cur.items():
                gauge.set(*key, value=n)
            self._gauge_keys[name] = set(cur)

    # -- HTTP data plane (utils/fastweb) ---------------------------------------
    def _run_http(self) -> None:
        from ..stats import VOLUME_REQUEST_COUNTER, VOLUME_REQUEST_SECONDS
        from ..utils import fastweb
        from ..utils.fastweb import Redirect, json_response

        kinds = {"POST": "post", "PUT": "put", "GET": "get",
                 "HEAD": "head", "DELETE": "delete"}

        async def handle(request: fastweb.Request):
            kind = kinds.get(request.method, "other")
            t0 = time.perf_counter()
            t_admit = t_done = None
            resp = None
            status = 500
            # the server span continues the caller's trace; a GET's span
            # parents the EC shard fetches
            with tracing.start_span(
                    f"volume.{kind}", component="volume",
                    child_of=tracing.extract(request.headers),
                    attrs={"fid": request.path.lstrip("/"),
                           "server": self.url}) as sp:
                grant = qos_token = None
                try:
                    # admission: tenant = the fid's collection, class from
                    # the verb unless the hop is tagged lower; reads
                    # post-charge their response bytes, replica hops
                    # charge but never shed
                    is_read = request.method in ("GET", "HEAD")
                    try:
                        grant, qos_token = await self._qos_admit(
                            request, sp,
                            qos.CLASS_INTERACTIVE if is_read
                            else qos.CLASS_INGEST,
                            cost=len(request.body or b""))
                    except qos.QosShed as e:
                        status = 503
                        sp.set_attr("qos", "shed")
                        return self._qos_shed_response(e)
                    t_admit = time.perf_counter()
                    try:
                        if request.method in ("POST", "PUT"):
                            resp = await self._handle_write(request)
                        elif request.method in ("GET", "HEAD"):
                            resp = await self._handle_read(request)
                        elif request.method == "DELETE":
                            resp = await self._handle_delete(request)
                        else:
                            resp = json_response(
                                {"error": "method not allowed"}, status=405)
                    except KeyError as e:
                        resp = json_response({"error": str(e)}, status=404)
                    except PermissionError as e:
                        resp = json_response({"error": str(e)}, status=403)
                    except Redirect as e:
                        status = e.status
                        sp.status = "redirect"  # control flow, not a fault
                        raise
                    except Exception as e:  # noqa: BLE001 — answer, keep serving
                        log.error("http error: %s", e)
                        resp = json_response({"error": str(e)}, status=500)
                    t_done = time.perf_counter()
                    status = resp.status
                    if grant is not None and is_read and resp.body:
                        grant.charge(len(resp.body))
                    return resp
                finally:
                    self._qos_done(grant, qos_token)
                    sp.set_attr("status", status)
                    if status >= 500:
                        sp.set_error(f"HTTP {status}")
                    t_end = time.perf_counter()
                    VOLUME_REQUEST_COUNTER.inc(kind, str(status))
                    VOLUME_REQUEST_SECONDS.observe(kind, value=t_end - t0)
                    # heavy hitters: bytes moved = payload in + body out
                    self._account(
                        kind, request, status, sp,
                        (t0, t_admit, t_done, t_end),
                        volume=_vid_of_path(request.path),
                        tenant=self._qos_tenant_of_path(request.path),
                        nbytes=len(request.body or b"") + (
                            len(resp.body) if resp is not None and resp.body
                            else 0))

        def status(request):
            return json_response({"version": "swtpu",
                                  "device": self.device,
                                  **self.store.status()})

        def metrics(request):
            from ..stats import scrape_payload
            body, ctype = scrape_payload(request.headers.get("Accept", ""))
            return fastweb.Response(body.encode(), content_type=ctype)

        def framed(kind: str, span: str, handler, klass: str):
            """The envelope of a bulk route: the default handler's, with
            its own request kind and span, admitted as `klass`: /bulk is
            charged its frame's bytes up front, /bulk-read the response
            frame's once it is known."""
            is_read = klass == qos.CLASS_INTERACTIVE

            async def handle_frame(request: fastweb.Request):
                t0 = time.perf_counter()
                t_admit = t_done = None
                resp = None
                status = 500
                with tracing.start_span(
                        span, component="volume",
                        child_of=tracing.extract(request.headers),
                        attrs={"server": self.url,
                               "bytes": len(request.body or b"")}) as sp:
                    grant = qos_token = None
                    try:
                        try:
                            grant, qos_token = await self._qos_admit(
                                request, sp, klass,
                                cost=0 if is_read
                                else len(request.body or b""),
                                by_query=True)
                        except qos.QosShed as e:
                            status = 503
                            sp.set_attr("qos", "shed")
                            return self._qos_shed_response(e)
                        t_admit = time.perf_counter()
                        try:
                            resp = await handler(request, sp)
                        except KeyError as e:
                            resp = json_response({"error": str(e)},
                                                 status=404)
                        except PermissionError as e:
                            resp = json_response({"error": str(e)},
                                                 status=403)
                        except Exception as e:  # noqa: BLE001 — answer, keep serving
                            log.error("%s http error: %s", kind, e)
                            resp = json_response({"error": str(e)},
                                                 status=500)
                        t_done = time.perf_counter()
                        status = resp.status
                        if grant is not None and is_read and resp.body:
                            grant.charge(len(resp.body))
                        return resp
                    finally:
                        self._qos_done(grant, qos_token)
                        sp.set_attr("status", status)
                        if status >= 500:
                            sp.set_error(f"HTTP {status}")
                        t_end = time.perf_counter()
                        VOLUME_REQUEST_COUNTER.inc(kind, str(status))
                        VOLUME_REQUEST_SECONDS.observe(kind,
                                                       value=t_end - t0)
                        # a /bulk frame moves its body in, /bulk-read its
                        # response frame out
                        if is_read:
                            nbytes = len(resp.body or b"") if resp else 0
                        else:
                            nbytes = len(request.body or b"")
                        self._account(
                            kind, request, status, sp,
                            (t0, t_admit, t_done, t_end),
                            volume=request.query.get("vid") or None,
                            tenant=self._qos_tenant_of_query(request.query),
                            nbytes=nbytes)
            return handle_frame

        def guarded_write(request):
            """401 response when the guard refuses write admission (the
            mutating debug forms), else None."""
            if self.guard is None:
                return None
            ok, why = self.guard.check_write(request.remote or "",
                                             request.query, request.headers)
            return None if ok else json_response({"error": why}, status=401)

        def debug_qos(request):
            """GET dumps the scheduler's live state; POST with a JSON
            policy document retunes it, and GET ?reload=1 re-reads the
            attached policy file. On a guarded server the mutating forms
            need write admission: a throttled tenant must not be able to
            switch its own throttle off."""
            if request.method == "POST" or request.query.get("reload"):
                refused = guarded_write(request)
                if refused is not None:
                    return refused
            if request.method == "POST":
                try:
                    self.qos.load(json.loads(request.body or b"{}"))
                except (ValueError, TypeError) as e:
                    return json_response({"error": str(e)}, status=400)
                return json_response({"ok": True,
                                      "enabled": self.qos.enabled})
            if request.query.get("reload"):
                self.qos._reload_file(initial=True)
            return json_response(self.qos.debug_payload())

        def debug_lifecycle(request):
            """GET: this server's per-volume heat and tier state (the
            lifecycle planner's input). POST {"volume": N, "destroy_time":
            T} stamps a DestroyTime onto a local EC volume's .vif; guarded
            like /debug/qos: a tenant must not schedule its own data's
            reaping."""
            if request.method != "POST":
                return json_response(self._lifecycle_payload())
            refused = guarded_write(request)
            if refused is not None:
                return refused
            try:
                doc = json.loads(request.body or b"{}")
                vid = int(doc["volume"])
                at = float(doc["destroy_time"])
            except (KeyError, TypeError, ValueError) as e:
                return json_response({"error": str(e)}, status=400)
            if not self._set_destroy_time(vid, at):
                return json_response({"error": f"no ec volume {vid}"},
                                     status=404)
            return json_response({"ok": True, "volume": vid,
                                  "destroy_time": at})

        def operator_gate(request):
            """The gate of the operator routes: GET only, and the guard's
            IP white list (stacks and flight entries leak fids, paths and
            peer addresses). An error response, or None."""
            if request.method != "GET":
                return json_response({"error": "method not allowed"},
                                     status=405)
            if self.guard is not None:
                ok, why = self.guard.check_ip(request.remote or "")
                if not ok:
                    return json_response({"error": why}, status=401)
            return None

        async def debug_profile(request):
            from .. import profiling
            denied = operator_gate(request)
            if denied is not None:
                return denied
            # the shared contract (profiling.handle_profile_query), off the
            # loop: a capture blocks for `seconds`
            code, ctype, body = await self._off_loop(
                None, profiling.handle_profile_query, request.query)
            return fastweb.Response(body.encode(), status=code,
                                    content_type=ctype)

        def debug_flight(request):
            from .. import profiling
            denied = operator_gate(request)
            if denied is not None:
                return denied
            code, payload = profiling.debug_flight_payload(request.query)
            return json_response(payload, status=code)

        def debug_jax_profiler(request):
            """The reference's device-profiler trigger, kept at its path
            for operators' scripts: starts one torch.profiler capture
            (utils/profiling.start_device_trace) and answers where its
            Chrome trace will be written; `stop=1` ends the capture and
            answers where it was written. On a server whose coder runs on
            the card the capture must hold the card's activity: without
            it the route answers 500 rather than a trace that lacks the
            kernels. Starting while a capture runs answers its path."""
            from ..utils import profiling
            try:
                if request.query.get("stop"):
                    return fastweb.text_response(
                        f"device trace written to "
                        f"{profiling.stop_device_trace()}\n")
                running = profiling.device_trace_path()
                if running is not None:
                    return fastweb.text_response(
                        f"device trace already capturing to {running}\n")
                path = profiling.start_device_trace(
                    cuda=self.device == "cuda")
            except RuntimeError as e:
                code = 400 if request.query.get("stop") else 500
                return fastweb.text_response(f"{e}\n", status=code)
            return fastweb.text_response(
                f"device trace capturing to {path} (stop with ?stop=1)\n")

        def debug_failpoints(request):
            """GET: the armed failpoints; ?name=X&spec=Y arms or updates one
            at runtime (spec "off" disarms). A bare ?name=X is a read."""
            name = request.query.get("name")
            spec = request.query.get("spec")
            if name and spec is not None:
                try:
                    failpoints.configure(name, spec)
                except ValueError as e:
                    return fastweb.text_response(f"bad spec: {e}",
                                                 status=400)
            return json_response({"armed": failpoints.active(),
                                  "fired": failpoints.fired_counts()})

        def debug_traces(request):
            return json_response(tracing.debug_traces_payload(request.query))

        def debug_events(request):
            return json_response(events.debug_events_payload(request.query))

        def debug_locks(request):
            from ..utils import locktrack
            return json_response(locktrack.debug_locks_payload(request.query))

        def status_ui(request):
            """The human status page (reference weed/server/volume_server_ui)."""
            from ..utils.ui import render_page
            st = self.store.status()
            rows, ec_rows = [], []
            for loc in self.store.locations:
                with loc.lock:  # allocate and mount mutate these dicts
                    vols = sorted(loc.volumes.items())
                    ecs = sorted(loc.ec_volumes.items())
                for vid, v in vols:
                    rows.append([vid, v.collection or "-", loc.disk_type,
                                 f"{v.content_size >> 20} MB",
                                 v.file_count, v.deleted_count,
                                 "ro" if v.read_only else "rw"])
                for vid, ev in ecs:
                    ec_rows.append([vid, ev.collection or "-",
                                    sorted(ev.shards)])
            page = render_page(
                f"swtpu volume server {self.url}",
                {"Master": ", ".join(self.masters),
                 "Volumes": st["volumes"], "EC volumes": len(ec_rows),
                 "Rack": self.rack or "-",
                 "Data center": self.data_center or "-"},
                [("Volumes", ["id", "collection", "disk", "size", "files",
                              "deleted", "mode"], rows),
                 ("EC volumes", ["id", "collection", "shards"], ec_rows)])
            return fastweb.html_response(page)

        app = fastweb.FastApp()
        app.route("/status", status)
        app.route("/ui", status_ui)
        app.route("/bulk", framed("bulk", "bulk.put", self._handle_bulk,
                                  qos.CLASS_INGEST))
        app.route("/bulk-read", framed("bulk-read", "bulk.read",
                                       self._handle_bulk_read,
                                       qos.CLASS_INTERACTIVE))
        app.route("/metrics", metrics)
        # pprof-style triggers (reference -debug.port net/http/pprof)
        app.route("/debug/profile", debug_profile)
        app.route("/debug/flight", debug_flight)
        app.route("/debug/jax-profiler", debug_jax_profiler)
        app.route("/debug/failpoints", debug_failpoints)
        app.route("/debug/traces", debug_traces)
        app.route("/debug/events", debug_events)
        app.route("/debug/locks", debug_locks)
        app.route("/debug/qos", debug_qos)
        app.route("/debug/lifecycle", debug_lifecycle)
        app.default(handle)
        fastweb.serve_fast_app(app, self.ip, self.port, self._stop,
                               client_max_size=256 << 20, logger=log,
                               on_loop=self._loop_lag.attach)

    # -- per-request accounting and the lifecycle report ------------------------
    def _account(self, kind: str, request, status: int, sp, times,
                 volume, tenant: str, nbytes: int) -> None:
        """After a response: its stages into VOLUME_STAGE_SECONDS, the
        flight recorder's offer with the at-admit context a postmortem
        needs to tell "this request was slow" from "the node was
        drowning" (loop lag, pool queue depths; below the threshold two
        float compares), and the hot-key sketches. `times` is (t0,
        t_admit, t_done, t_end) of the handler."""
        from ..profiling import record_flight
        t0, t_admit, t_done, t_end = times
        stages = _observe_stages(kind, request.t_recv, request.t_parsed, t0,
                                 t_admit, t_done, t_end)
        record_flight(
            f"volume.{kind}", t_end - (request.t_recv or t0), status=status,
            path=request.path, stages=stages,
            qos_class=str(sp.attrs.get("qos_class", "")),
            cache=sp.attrs.get("cache"),
            loop_lag_s=self._loop_lag.last_lag_s,
            queue_depths={"read": self._read_pool.queued(),
                          "ec_read": self._ec_read_pool.queued()},
            node=self.url)
        hot_record(volume=volume, tenant=tenant, method=kind, nbytes=nbytes)

    def _lifecycle_payload(self) -> dict:
        """The lifecycle planner's per-server input (/debug/lifecycle):
        heat as ages, never absolute clocks, so the planner compares
        across processes."""
        access = self.store.access_snapshot()
        now_wall = time.time()  # swtpu-lint: disable=wallclock-duration (needle timestamps are persisted wall-clock)
        vols: dict = {}
        ecs: dict = {}
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                a = access.get(vid, {})
                if v.last_append_at_ns:
                    write_age = max(0.0,
                                    now_wall - v.last_append_at_ns / 1e9)
                else:  # loaded sealed: the .dat's mtime is the last write
                    try:
                        write_age = max(0.0, now_wall - os.path.getmtime(
                            v.dat_path))
                    except OSError:
                        write_age = None
                vols[str(vid)] = {
                    "collection": v.collection,
                    "size": v.content_size,
                    "read_only": v.read_only,
                    "tiered": v.remote_spec is not None,
                    "last_write_age_s": (round(write_age, 3)
                                         if write_age is not None else None),
                    "reads": a.get("reads", 0),
                    "last_read_age_s": a.get("last_read_age_s"),
                }
            for vid, ev in list(loc.ec_volumes.items()):
                a = access.get(vid, {})
                # the .vif's last-read stamp carries the quiet period across
                # restarts; the store's counter can only shorten it
                ages = [ev.read_age_s()]
                if a.get("last_read_age_s") is not None:
                    ages.append(a["last_read_age_s"])
                remote = ev.remote_shard_ids()
                ecs[str(vid)] = {
                    "collection": ev.collection,
                    "local_shards": sorted(set(ev.shards) - set(remote)),
                    "remote_shards": remote,
                    "remote_spec": (ev.remote_spec or {}).get("spec", ""),
                    "remote_reads": ev.remote_reads(),
                    "reads": ev.reads,
                    "last_read_age_s": round(min(ages), 3),
                    "destroy_time": ev.destroy_time,
                    "shard_size": ev.shard_size,
                    "dat_size": ev.dat_size,
                }
        return {"server": self.url,
                "uptime_s": round(time.monotonic() - self._started_mono, 3),
                "volumes": vols, "ec_volumes": ecs}

    # -- QoS admission (qos/) ---------------------------------------------------
    async def _qos_admit(self, request, sp, klass: str, cost: int = 0,
                         by_query: bool = False):
        """(grant, class token) of one admitted request, or (None, None)
        when admission is off; raises qos.QosShed. The tenant is the
        collection of the path's fid, or of the query's vid for the bulk
        routes (`by_query`). The class is `klass` unless the request's
        x-swtpu-qos header tags it lower; the handler runs under it, so its
        hops carry it on."""
        if not self.qos.enabled:
            return None, None
        tenant = (self._qos_tenant_of_query(request.query) if by_query
                  else self._qos_tenant_of_path(request.path))
        klass = qos.class_from_headers(request.headers, klass)
        grant = await self.qos.admit(
            tenant, klass, cost=cost,
            no_shed=request.query.get("type") == "replicate")
        sp.set_attr("qos_class", klass)
        return grant, qos.set_class(klass)

    @staticmethod
    def _qos_done(grant, token) -> None:
        if token is not None:
            qos.reset_class(token)
        if grant is not None:
            grant.release()

    def _qos_tenant(self, vid: int) -> str:
        """Tenant identity at the volume tier: the vid's collection
        ('default' for the unnamed collection and unknown vids)."""
        v = self.store.find_volume(vid)
        if v is None:
            ev = self.store.find_ec_volume(vid)
            return (ev.collection or "default") if ev is not None \
                else "default"
        return v.collection or "default"

    def _qos_tenant_of_path(self, path: str) -> str:
        try:
            vid = int(path.lstrip("/").split(",", 1)[0])
        except ValueError:
            return "default"
        return self._qos_tenant(vid)

    def _qos_tenant_of_query(self, query: dict) -> str:
        try:
            vid = int(query.get("vid", ""))
        except ValueError:
            return "default"
        return self._qos_tenant(vid)

    @staticmethod
    def _qos_shed_response(e):
        """503 with Retry-After, the volume tier's mirror of S3's
        SlowDown: the client backs off for the bucket's ETA."""
        from ..utils.fastweb import Response
        return Response(
            json.dumps({"error": str(e), "qos": "shed",
                        "retryAfterSeconds": e.retry_after_header}).encode(),
            status=503, content_type="application/json",
            headers={"Retry-After": e.retry_after_header})

    def _maintenance_grant(self, collection: str, cost: int = 0):
        """A maintenance-class grant of this server's scheduler when the
        calling flow is maintenance-tagged and admission is on, else
        None (untagged reads are the data path and stay admission-free)."""
        if self.qos.enabled and \
                qos.current_class() == qos.CLASS_MAINTENANCE:
            return self.qos.admit_sync(collection or "default",
                                       qos.CLASS_MAINTENANCE, cost=cost)
        return None

    def _admitted(self, collection: str, chunks, cost: int = 0):
        """`chunks` (an iterator) under _maintenance_grant: a repair's
        pull admits before its first byte leaves this server's disks and
        releases when the stream ends or fails."""
        grant = self._maintenance_grant(collection, cost)
        try:
            yield from chunks
        finally:
            if grant is not None:
                grant.release()

    async def _off_loop(self, pool, fn, *args):
        """Run blocking storage work on `pool`, keeping the trace context."""
        import asyncio
        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(pool, ctx.run, fn, *args)

    @staticmethod
    def _read_body(request):
        """(data, name, mime, gzipped) of an upload: a multipart part or the
        raw body."""
        from ..utils.fastweb import parse_multipart_single
        ct = request.headers.get("Content-Type") or ""
        if ct.startswith("multipart/"):
            data, filename, ptype, part_headers = parse_multipart_single(
                request.body, ct)
            mime = (ptype.encode() if ptype and not ptype.startswith(
                "multipart/") else b"")
            return (data, filename.encode(), mime,
                    part_headers.get("Content-Encoding") == "gzip")
        mime = ct.encode() if ct and ct != "application/octet-stream" else b""
        return (request.body, (request.query.get("name") or "").encode(),
                mime, request.headers.get("Content-Encoding") == "gzip")

    def _check(self, verdict) -> "object | None":
        """A 401 response for a guard's refusal, else None."""
        from ..utils.fastweb import json_response
        ok, why = verdict
        return None if ok else json_response({"error": why}, status=401)

    def _guard_write(self, request, fid: str):
        if self.guard is None:
            return None
        return self._check(self.guard.check_write(
            request.remote or "", request.query, request.headers, fid))

    def _guard_read(self, request, fid: str):
        if self.guard is None:
            return None
        return self._check(self.guard.check_read(
            request.remote or "", request.query, request.headers, fid))

    async def _handle_write(self, request):
        from ..utils.fastweb import json_response
        fid = request.path.lstrip("/")
        refused = self._guard_write(request, fid)
        if refused is not None:
            return refused
        vid, key, cookie = parse_file_id(fid)
        is_replicate = request.query.get("type") == "replicate"
        ttl = TTL.parse(request.query.get("ttl"))
        # ?fsync=true: this ack stands on a real fsync
        fsync = request.query.get("fsync") in ("true", "1")

        # body parse, needle serialization and the store write run off
        # the loop in one executor hop
        def parse_and_write():
            data, name, mime, gzipped = self._read_body(request)
            n = Needle(id=key, cookie=cookie, data=data, name=name,
                       mime=mime, is_gzipped=gzipped, ttl=ttl)
            self.store.write_needle(vid, n, sync=fsync)
            return data, name, mime, gzipped, n

        data, name, mime, gzipped, n = await self._off_loop(None,
                                                            parse_and_write)
        if not is_replicate:
            # a replica hop lands here only: the sender fans out
            await self._off_loop(self._hop_pool, self._replicate, fid, data,
                                 name, mime, gzipped, fsync)
        return json_response({"name": name.decode(errors="replace"),
                              "size": len(data),
                              "eTag": f"{n.checksum:x}"}, status=201)

    def _single_copy(self, vid: int) -> bool:
        """True when the volume is local with placement 000: the write is
        final here and needs no replica lookup."""
        v = self.store.find_volume(vid)
        return v is not None and \
            v.super_block.replica_placement.copy_count == 1

    def _other_holders(self, vid: int, cached: bool = False) -> "list[str]":
        urls = (self._lookup_replicas_cached(vid) if cached
                else self._lookup_replicas(vid))
        return [u for u in urls if u != self.url]

    def _replicate(self, fid: str, data: bytes, name: bytes, mime: bytes,
                   gzipped: bool, fsync: bool = False) -> None:
        """Synchronous fan-out of one write to the replica peers (runs on
        the hop pool), carrying the needle's name, mime and gzip flag and
        the durability mode: a ?fsync=true write is fsynced on every
        replica, or the ack overstates what a crash can keep."""
        from ..client import http_util
        vid = int(fid.split(",")[0])
        if self._single_copy(vid):
            return
        peers = self._other_holders(vid, cached=True)
        if not peers:
            return
        headers = {"Content-Type": mime.decode() or "application/octet-stream"}
        if gzipped:
            headers["Content-Encoding"] = "gzip"
        tail = "&fsync=true" if fsync else ""
        if name:
            tail += "&" + urllib.parse.urlencode(
                {"name": name.decode(errors="replace")})
        tail += self._peer_jwt_param(fid)

        def send_one(peer: str) -> int:
            return http_util.send(
                "POST", f"http://{peer}/{fid}?type=replicate{tail}",
                body=data, headers=headers,
                timeout=retry.WRITE_POLICY.attempt_timeout).status

        self._fan_out_to_peers(
            peers, lambda peer: {"peer": peer, "fid": fid, "bytes": len(data)},
            "replicate", send_one)

    def _fan_out_to_peers(self, peers, span_attrs, desc, send_one) -> None:
        """The synchronous replica fan-out envelope (blocking, on the hop
        pool): every peer must land or the write fails, so a flaky peer
        gets retry.WRITE_POLICY (jittered backoff, one deadline over the
        whole fan-out, the retry budget) before the write gives up.
        Breakers record outcomes but never skip a peer: durability beats
        latency on the replica hop. A 3xx or 4xx is a deterministic
        rejection (auth or configuration): the peer is alive and the same
        retry cannot succeed, so no breaker charge, no backoff, the write
        fails now. `send_one(peer) -> status` is one attempt;
        `span_attrs(peer)` labels the per-peer span."""
        pol = retry.WRITE_POLICY
        deadline = time.monotonic() + pol.deadline
        for peer in peers:
            br = retry.breaker(peer)
            last_err: "Exception | None" = None
            # one child span per replica hop: a slow or retried write shows
            # which peer cost it
            with tracing.start_span("volume.replicate", component="volume",
                                    attrs=span_attrs(peer)) as sp:
                for attempt in range(1, pol.max_attempts + 1):
                    try:
                        # a dead replica peer without killing a process
                        failpoints.check("replicate.peer")
                        status = send_one(peer)
                        if 300 <= status < 500:
                            last_err = OSError(f"{desc} to {peer}: "
                                               f"HTTP {status}")
                            break
                        if status >= 500:
                            raise OSError(f"{desc} to {peer}: HTTP {status}")
                        br.record_success()
                        retry.BUDGET.deposit()
                        last_err = None
                        break
                    except Exception as e:  # noqa: BLE001 — retried below
                        br.record_failure()
                        last_err = e
                        delay = pol.backoff(attempt)
                        if (attempt >= pol.max_attempts
                                or time.monotonic() + delay > deadline
                                or not retry.BUDGET.withdraw()):
                            break
                        from ..stats import RETRY_ATTEMPTS
                        RETRY_ATTEMPTS.inc("replicate.peer")
                        sp.add_event("retry", op="replicate.peer",
                                     attempt=attempt, breaker=br.state,
                                     delay_ms=round(delay * 1e3, 2),
                                     error=str(e)[:200])
                        time.sleep(delay)
                if last_err is not None:
                    sp.set_error(last_err)
            if last_err is not None:
                raise OSError(f"{desc} to {peer} failed after retries: "
                              f"{last_err}")

    def _peer_jwt_param(self, fid: str) -> str:
        """The replica hop's write token, re-minted with the shared signing
        key (peers share the key, so minting here is equivalent to
        forwarding the request's token and survives its expiry)."""
        if self.guard is None or not self.guard.signing_key:
            return ""
        from ..security import gen_jwt_for_volume_server
        tok = gen_jwt_for_volume_server(self.guard.signing_key,
                                        self.guard.expires_after_sec, fid)
        return "&jwt=" + urllib.parse.quote(tok)

    # -- bulk ingest and bulk read (storage/bulk.py frames) ---------------------
    async def _handle_bulk(self, request, sp):
        """One framed bulk PUT: N needles land under one volume-lock
        acquisition with one batched needle-map update and one fsync
        (Volume.write_needles), the range JWT is checked once for the whole
        frame, and replicas take the frame in one hop each."""
        from ..storage import bulk as bulk_frame
        from ..utils.fastweb import json_response
        if request.method not in ("POST", "PUT"):
            return json_response({"error": "method not allowed"}, status=405)
        # the server dying mid-frame: nothing written, no ack
        failpoints.check("volume.bulk.put")
        # the frame parse and its per-needle CRC32C run off the loop
        try:
            vid, entries = await self._off_loop(
                None, bulk_frame.unpack_frame, request.body or b"")
        except bulk_frame.FrameError as e:
            return json_response({"error": str(e)}, status=400)
        refused = self._frame_vid_mismatch(request, vid)
        if refused is not None:
            return refused
        cookies = {e.cookie for e in entries}
        if len(cookies) != 1:
            # a lease shares one cookie across its range: mixed cookies
            # mean a stitched frame, refused before the auth check
            return json_response({"error": "mixed cookies in frame"},
                                 status=400)
        keys = [e.key for e in entries]
        cookie = entries[0].cookie
        sp.set_attr("vid", vid)
        sp.set_attr("needles", len(entries))
        if self.guard is not None:
            # one token check covers the whole frame (range JWT)
            refused = self._check(self.guard.check_bulk(
                request.remote or "", request.query, request.headers, vid,
                keys, cookie))
            if refused is not None:
                return refused
        ttl_str = request.query.get("ttl") or ""
        ttl = TTL.parse(ttl_str)
        is_replicate = request.query.get("type") == "replicate"

        def build_and_write():
            needles = [Needle(id=e.key, cookie=e.cookie, data=bytes(e.data),
                              is_gzipped=bool(e.flags & 0x01), ttl=ttl)
                       for e in entries]
            return self.store.write_needles_bulk(vid, needles)

        await self._off_loop(None, build_and_write)
        if not is_replicate:
            await self._off_loop(self._hop_pool, self._replicate_bulk, vid,
                                 request.body, keys, cookie, ttl_str)
        # the ack lost after the frame is durable everywhere
        failpoints.check("volume.bulk.ack")
        from ..stats import BULK_PUT_NEEDLES
        BULK_PUT_NEEDLES.observe(value=len(entries))
        events.emit("bulk.put", vid=vid, needles=len(entries),
                    bytes=len(request.body), node=self.url,
                    replicate=is_replicate)
        return json_response({"count": len(entries),
                              "eTags": [f"{e.crc:x}" for e in entries]},
                             status=201)

    @staticmethod
    def _frame_vid_mismatch(request, vid: int):
        """A 400 when the query's vid names another volume than the
        frame's, else None."""
        from ..utils.fastweb import json_response
        q_vid = request.query.get("vid", "")
        try:
            if q_vid and int(q_vid) != vid:
                return json_response(
                    {"error": f"query vid {q_vid} != frame vid {vid}"},
                    status=400)
        except ValueError:
            return json_response({"error": f"bad vid {q_vid!r}"}, status=400)
        return None

    def _replicate_bulk(self, vid: int, body: bytes, keys: "list[int]",
                        cookie: int, ttl_str: str = "") -> None:
        """The fan-out of a whole bulk frame (on the hop pool): one hop
        per peer, under _fan_out_to_peers' envelope."""
        from ..client import http_util
        if self._single_copy(vid):
            return
        peers = self._other_holders(vid, cached=True)
        if not peers:
            return
        tail = "&type=replicate" + self._peer_range_jwt_param(vid, keys,
                                                              cookie)
        if ttl_str:
            # replicas store the same ttl, or the copies' expiry diverges
            tail += "&ttl=" + urllib.parse.quote(ttl_str)

        def send_one(peer: str) -> int:
            return http_util.send(
                "PUT", f"http://{peer}/bulk?vid={vid}{tail}", body=body,
                timeout=retry.WRITE_POLICY.attempt_timeout).status

        self._fan_out_to_peers(
            peers, lambda peer: {"peer": peer, "vid": vid,
                                 "bulk_needles": len(keys),
                                 "bytes": len(body)},
            "bulk replicate", send_one)

    def _peer_range_jwt_param(self, vid: int, keys: "list[int]",
                              cookie: int) -> str:
        """The bulk hop's range token over the frame's [min, max] keys,
        minted with the shared signing key."""
        if self.guard is None or not self.guard.signing_key:
            return ""
        from ..security import gen_jwt_for_fid_range
        lo = min(keys)
        tok = gen_jwt_for_fid_range(
            self.guard.signing_key, max(30, self.guard.expires_after_sec),
            vid, lo, max(keys) - lo + 1, cookie)
        return "&jwt=" + urllib.parse.quote(tok)

    async def _handle_bulk_read(self, request, sp):
        """One framed bulk GET: a vid and (key, cookie) pairs in ("SWBR"),
        the whole batch resolved in one pass and sent back in one frame
        ("SWBG") with a status per needle; hot needles come from the read
        cache."""
        from ..storage import bulk as bulk_frame
        from ..storage.types import file_id
        from ..utils.fastweb import Response, json_response
        if request.method not in ("POST", "PUT"):
            return json_response({"error": "method not allowed"}, status=405)
        # the server dying mid-read: the client fails over to a replica
        failpoints.check("volume.bulk.read")
        try:
            vid, pairs = bulk_frame.unpack_read_request(request.body or b"")
        except bulk_frame.FrameError as e:
            return json_response({"error": str(e)}, status=400)
        refused = self._frame_vid_mismatch(request, vid)
        if refused is not None:
            return refused
        sp.set_attr("vid", vid)
        sp.set_attr("needles", len(pairs))
        if self.guard is not None:
            # read tokens are per fid: the frame passes only if the caller
            # is white-listed or its token covers every fid, as the
            # per-needle GET demands
            for key, cookie in pairs:
                refused = self._guard_read(request, file_id(vid, key, cookie))
                if refused is not None:
                    return refused
        if (self.store.find_volume(vid) is None
                and self.store.find_ec_volume(vid) is None):
            # no proxy hop for frames: the client fails over by itself
            return json_response({"error": f"volume {vid} not local"},
                                 status=404)
        body, hits = await self._off_loop(self._read_pool,
                                          self._bulk_read_frame, vid, pairs)
        sp.set_attr("cache_hits", hits)
        from ..stats import BULK_READ_NEEDLES
        BULK_READ_NEEDLES.observe(value=len(pairs))
        return Response(body, content_type="application/octet-stream")

    def _bulk_read_frame(self, vid: int, pairs: "list[tuple[int, int]]"
                         ) -> "tuple[bytes, int]":
        """(response frame, cache hits) of one bulk-read frame (runs on the
        read pool): cache hits first, then one batched storage pass for the
        misses, with epoch-gated cache fills. A byte budget per frame
        (SWTPU_BULK_READ_FRAME_BYTES, 32 MB) bounds what one frame
        materializes: found needles past it come back READ_OVERFLOW unread,
        and the client fetches them one by one."""
        from ..storage import bulk as bulk_frame
        from ..storage.needle import FLAG_GZIP
        from ..utils.env import env_int
        budget = env_int("SWTPU_BULK_READ_FRAME_BYTES", 32 << 20)
        cache = (self.read_cache
                 if self.store.find_volume(vid) is not None else None)
        results: "list[tuple | None]" = [None] * len(pairs)
        misses: "list[int]" = []
        hits = used = 0
        epoch = cache.epoch(vid) if cache is not None else None
        for i, (key, cookie) in enumerate(pairs):
            n = cache.get(vid, key, cookie) if cache is not None else None
            if n is None:
                misses.append(i)
            elif used >= budget:
                # hits spend the budget too: the response join is what it
                # bounds
                results[i] = (key, cookie, bulk_frame.READ_OVERFLOW, 0, b"")
            else:
                hits += 1
                used += len(n.data)
                results[i] = (key, cookie, bulk_frame.READ_OK,
                              FLAG_GZIP if n.is_gzipped else 0, n.data)
        if hits:
            # hits never reach the store: feed the heat counters here
            self.store.note_read(vid, n=hits)
        if misses:
            got = self.store.read_needles_bulk(
                vid, [pairs[i] for i in misses],
                shard_reader=self._make_shard_reader(vid),
                byte_budget=max(0, budget - used))
            for i, (st, n) in zip(misses, got):
                key, cookie = pairs[i]
                if st == bulk_frame.READ_OK:
                    results[i] = (key, cookie, st,
                                  FLAG_GZIP if n.is_gzipped else 0, n.data)
                    if cache is not None:
                        cache.put(vid, key, n, epoch=epoch)
                else:
                    results[i] = (key, cookie, st, 0, b"")
        return bulk_frame.pack_read_response(vid, results), hits

    # -- replica lookup ---------------------------------------------------------
    def _lookup_replicas_cached(self, vid: int) -> "list[str]":
        """Replica sets move only on evacuate or rebalance: a 5 s cache
        keeps the lookup off each write."""
        now = time.monotonic()
        hit = self._replica_cache.get(vid)
        if hit is not None and now - hit[0] < 5.0:
            return hit[1]
        urls = self._lookup_replicas(vid)
        self._replica_cache[vid] = (now, urls)
        return urls

    def _lookup_replicas(self, vid: int) -> "list[str]":
        """HTTP urls of the volume's holders, as the master's LookupVolume
        answers; [] when there is no peer plane or the lookup fails (the
        write then lands on this copy alone, as the JAX package's does
        when its master lookup fails)."""
        if self.peers is None:
            return []
        try:
            return list(self.peers.lookup_volume(vid))
        except Exception as e:  # noqa: BLE001 — a failed lookup finds none
            log.warning("replica lookup vid=%d failed: %s", vid, e)
            return []

    # -- reads ------------------------------------------------------------------
    async def _handle_read(self, request):
        from ..utils.fastweb import Response, json_response
        fid = request.path.lstrip("/")
        refused = self._guard_read(request, fid)
        if refused is not None:
            return refused
        vid, key, cookie = parse_file_id(fid)
        # the hot-needle cache sits in front of local plain volumes only:
        # EC and proxied reads stay uncached (their bytes take the same
        # serve and Range steps below)
        cache = self.read_cache
        cacheable = (cache is not None
                     and self.store.find_volume(vid) is not None)
        n = None
        if cacheable:
            n = cache.get(vid, key, cookie)
            if n is not None:
                # hits never reach the store: feed the heat counters here
                self.store.note_read(vid)
            sp = tracing.current_span()
            if sp is not None:
                sp.set_attr("cache", "hit" if n is not None else "miss")
        try:
            if n is None:
                # the epoch before the storage read: a mutation landing in
                # between drops this fill (ReadCache.put)
                epoch = cache.epoch(vid) if cacheable else None
                # the storage read off the loop, on the read pool
                n = await self._off_loop(self._read_pool, self._store_read,
                                         vid, key, cookie)
                if epoch is not None:
                    cache.put(vid, key, n, epoch=epoch)
        except KeyError:
            if (self.store.find_volume(vid) is not None
                    or self.store.find_ec_volume(vid) is not None):
                # the volume is local, so this copy is authoritative: a
                # missing needle is a definitive 404 (proxying would
                # ping-pong between replicas after a delete)
                raise
            if request.query.get("proxied"):
                raise  # one forwarding hop at most
            return await self._read_remote(request, fid, vid)
        except OSError as e:
            # a degraded EC read that could not gather d shards from here:
            # another holder may reach another subset, so fail over unless
            # this is a forwarded hop; with no failover answer 503, not a
            # 404 that reads as "deleted"
            if (self.store.find_ec_volume(vid) is not None
                    and not request.query.get("proxied")
                    and self.read_mode != "local"
                    and await self._off_loop(self._hop_pool,
                                             self._other_holders, vid)):
                return await self._read_remote(request, fid, vid)
            return json_response({"error": str(e)}, status=503)
        body = n.data
        headers = {}
        name = n.name.decode(errors="replace") if n.name else ""
        if name:
            headers["Content-Disposition"] = f'inline; filename="{name}"'
        # an image needle asked for with width/height is resized on the
        # host (reference conditionallyResizeImages,
        # volume_server_handlers_read.go:321): the resize needs the
        # identity bytes and turns Range off
        ext = os.path.splitext(name)[1].lower()
        w = h = 0
        mode, do_resize = "", False
        if ext:
            from ..images import should_resize
            w, h, mode, do_resize = should_resize(ext, request.query)
        # Range works on the identity bytes: a ranged read of a gzip
        # needle, or one whose client does not take gzip, is decompressed
        rng_spec = None if do_resize else _parse_range(
            request.headers.get("Range"))
        gzip_ok = "gzip" in (request.headers.get("Accept-Encoding") or "")
        if n.is_gzipped and (do_resize or rng_spec is not None
                             or not gzip_ok):
            body = gzip.decompress(body)
        elif n.is_gzipped:
            headers["Content-Encoding"] = "gzip"
        if do_resize:
            from ..images import fix_jpeg_orientation, resized
            if ext in (".jpg", ".jpeg"):
                # the EXIF rotation is baked in only when re-encoding
                # anyway: a plain read serves the stored bytes untouched
                body = fix_jpeg_orientation(body)
            body = resized(ext, body, w, h, mode)
        status = 200
        if rng_spec is not None:
            window = _resolve_range(rng_spec, len(body))
            if window is None:
                return Response(
                    b"", status=416,
                    headers={"Content-Range": f"bytes */{len(body)}"},
                    content_type="application/octet-stream")
            start, stop = window
            headers["Content-Range"] = f"bytes {start}-{stop - 1}/{len(body)}"
            body = body[start:stop]
            status = 206
        return Response(body, status=status, headers=headers or None,
                        content_type=(n.mime.decode() if n.mime else
                                      "application/octet-stream"))

    def _store_read(self, vid: int, key: int, cookie: "int | None"):
        """Blocking storage read (runs on the read pool)."""
        return self.store.read_needle(
            vid, key, cookie=cookie,
            shard_reader=self._make_shard_reader(vid))

    async def _read_remote(self, request, fid: str, vid: int):
        """A GET of a volume this server lacks: 404 in read mode "local",
        else proxied to a holder or redirected there, the hop marked
        `proxied=1` so that it is never forwarded again."""
        from ..utils.fastweb import Redirect, json_response
        if self.read_mode == "local":
            return json_response({"error": f"volume {vid} not local"},
                                 status=404)
        # known-dead holders go last
        peers = retry.order_by_breaker(await self._off_loop(
            self._hop_pool, self._other_holders, vid))
        if not peers:
            return json_response({"error": f"volume {vid} not found"},
                                 status=404)
        # the caller's query (jwt, ...) goes along
        qs = request.query_string
        suffix = "?" + (f"{qs}&" if qs else "") + "proxied=1"
        if self.read_mode == "redirect":
            raise Redirect(f"http://{peers[0]}/{fid}{suffix}", status=301)
        # Range must survive the hop, and Content-Range and -Encoding the
        # way back, or ranged reads would widen to whole bodies; only the
        # client's own Accept-Encoding goes forward
        fwd = {h: request.headers.get(h) for h in ("Range", "Accept-Encoding")
               if request.headers.get(h)}
        return await self._off_loop(self._hop_pool, self._proxy, vid,
                                    f"/{fid}{suffix}", peers, fwd)

    def _proxy(self, vid: int, path: str, peers: "list[str]", fwd: dict):
        """The proxy hop (blocking, on the hop pool): the first holder
        that answers, its status, body and content headers passed back."""
        from ..client import http_util
        from ..utils.fastweb import Response, json_response
        last_err: "Exception | None" = None
        for peer in peers:
            br = retry.breaker(peer)
            try:
                r = http_util.send("GET", f"http://{peer}{path}", headers=fwd,
                                   timeout=retry.READ_POLICY.attempt_timeout)
            except Exception as e:  # noqa: BLE001 — try the next holder
                br.record_failure()
                last_err = e
                continue
            br.record_success()
            back = {h: r.headers[h] for h in ("Content-Range",
                                              "Content-Encoding",
                                              "Content-Disposition")
                    if h in r.headers}
            ctype = r.headers.get("Content-Type", "").split(";")[0].strip()
            return Response(r.content, status=r.status, headers=back or None,
                            content_type=ctype or "application/octet-stream")
        return json_response(
            {"error": f"proxy read vid {vid} failed: {last_err}"}, status=502)

    async def _handle_delete(self, request):
        from ..utils.fastweb import json_response
        fid = request.path.lstrip("/")
        refused = self._guard_write(request, fid)
        if refused is not None:
            return refused
        vid, key, _ = parse_file_id(fid)
        is_replicate = request.query.get("type") == "replicate"
        if self.store.find_volume(vid) is not None:
            ok = self.store.delete_needle(vid, key)
        else:
            ev = self.store.find_ec_volume(vid)
            if ev is None:
                raise KeyError(f"volume {vid} not local")
            ok = ev.delete_needle(key)
        if not is_replicate:
            # fanned out even when the needle was not here: a replica that
            # missed an earlier delete's fan-out still holds it
            await self._off_loop(self._hop_pool, self._replicate_delete, fid,
                                 vid)
        return json_response({"size": 1 if ok else 0}, status=202)

    def _replicate_delete(self, fid: str, vid: int) -> None:
        """The best-effort delete fan-out (on the hop pool): the local
        delete already succeeded, so a peer that misses it is logged."""
        from ..client import http_util
        for peer in self._other_holders(vid):
            try:
                # a replica missing the delete fan-out
                failpoints.check("replicate.delete.peer")
                http_util.send(
                    "DELETE", f"http://{peer}/{fid}?type=replicate"
                    + self._peer_jwt_param(fid),
                    timeout=retry.WRITE_POLICY.attempt_timeout)
            except Exception as e:  # noqa: BLE001 — best effort per peer
                log.warning("delete fan-out to %s: %s", peer, e)

    # -- EC read plane ----------------------------------------------------------
    def _lookup_ec_shards(self, vid: int, failed: bool = False
                          ) -> "dict[int, list[str]]":
        """shard id -> peer addresses of its holders, via the tiered cache."""
        now = time.monotonic()
        with self._ec_loc_lock:
            ent = self._ec_loc_cache.get(vid)
            if ent is not None:
                locs, fetched, complete = ent
                ttl = (self._EC_LOC_TTL_FAILED if failed else
                       self._EC_LOC_TTL_COMPLETE if complete else
                       self._EC_LOC_TTL_INCOMPLETE)
                if now - fetched < ttl:
                    return locs
        locs = self._lookup_ec_shards_peers(vid)
        if locs is not None:
            ev = self.store.find_ec_volume(vid)
            n = ev.geo.n if ev is not None else 0
            complete = n > 0 and all(locs.get(s) for s in range(n))
            with self._ec_loc_lock:
                self._ec_loc_cache[vid] = (locs, now, complete)
            return locs
        # the lookup failed: serve stale rather than fail the read, and
        # re-stamp the entry so the next probe waits a full failed tier
        # instead of paying the lookup's timeout on every read
        with self._ec_loc_lock:
            ent = self._ec_loc_cache.get(vid)
            if ent is not None:
                self._ec_loc_cache[vid] = (ent[0], now, False)
        return ent[0] if ent is not None else {}

    def _lookup_ec_shards_peers(self, vid: int) -> "dict | None":
        if self.peers is None:
            return None
        try:
            return self.peers.lookup_ec(vid)
        except Exception as e:  # noqa: BLE001 — a failed lookup serves stale
            log.warning("ec lookup vid=%d: %s", vid, e)
            return None

    def _fetch_remote_shard(self, vid: int, sid: int, offset: int,
                            length: int, holders: "list[str]",
                            include_open: bool = False) -> "bytes | None":
        # one span per shard fetch: a degraded read's trace shows every
        # attempted shard, the failed ones included
        with tracing.start_span(
                "ec.shard.fetch", component="volume",
                attrs={"vid": vid, "shard": sid, "offset": offset,
                       "length": length, "holders": len(holders)}) as sp:
            data = self._fetch_remote_shard_inner(vid, sid, offset, length,
                                                  holders, include_open, sp)
            if data is None:
                sp.set_error("no holder served shard"
                             if holders else "shard has no holders")
            return data

    def _fetch_remote_shard_inner(self, vid: int, sid: int, offset: int,
                                  length: int, holders: "list[str]",
                                  include_open: bool, sp) -> "bytes | None":
        try:
            # a shard fetch failure -> the caller's degraded reconstruct
            failpoints.check("ec.shard.read")
        except failpoints.FailpointError as e:
            log.warning("ec shard %d.%d read failpoint: %s", vid, sid, e)
            sp.add_event("failpoint", error=str(e)[:200])
            return None
        # circuit-open holders are skipped (None sends the caller down the
        # reconstruct path); include_open is the reconstruct's last resort
        ordered = retry.order_by_breaker(holders)
        if not include_open:
            allowed = []
            for addr in ordered:
                br = retry.breaker(addr)
                if br.would_allow():
                    allowed.append(addr)
                else:
                    sp.add_event("breaker_open", peer=addr, state=br.state)
            ordered = allowed
        for addr in ordered:
            br = retry.breaker(addr)
            try:
                data = self.peers.read_shard(addr, vid, sid, offset, length)
                br.record_success()
                sp.set_attr("holder", addr)
                # corrupt site: bit flips on the shard wire, which the
                # needle CRC downstream must catch
                return failpoints.corrupt("ec.shard.read.data", data)
            except Exception as e:  # noqa: BLE001 — try the next holder
                br.record_failure()
                sp.add_event("holder_failed", peer=addr, error=str(e)[:200])
                log.warning("remote shard %d.%d read from %s: %s",
                            vid, sid, addr, e)
        return None

    def _make_shard_reader(self, vid: int):
        """The shard reader of a needle read on EC volume `vid`:
        make_shard_reader over this server's peers, with the stale-location
        refresh on the shard's own fetch and the last probe of circuit-open
        holders in the reconstruct."""

        def direct(sid: int, offset: int, length: int) -> "bytes | None":
            locs = self._lookup_ec_shards(vid)
            data = self._fetch_remote_shard(vid, sid, offset, length,
                                            locs.get(sid, []))
            if data is None and locs.get(sid):
                # holders listed but unreachable: the locations may be
                # stale (the 11 s tier) — refresh once and retry
                fresh = self._lookup_ec_shards(vid, failed=True)
                if fresh.get(sid, []) != locs.get(sid, []):
                    tracing.add_event("stale_locations_refreshed", vid=vid,
                                      shard=sid)
                    self._count("stale_locations_refreshed")
                    data = self._fetch_remote_shard(vid, sid, offset, length,
                                                    fresh.get(sid, []))
            return data

        def fetch(sid: int, offset: int, length: int) -> "bytes | None":
            return self._fetch_remote_shard(
                vid, sid, offset, length,
                self._lookup_ec_shards(vid).get(sid, []))

        def probe(sid: int, offset: int, length: int) -> "bytes | None":
            data = self._fetch_remote_shard(
                vid, sid, offset, length,
                self._lookup_ec_shards(vid).get(sid, []), include_open=True)
            if data is not None:
                self._count("last_probes")
            return data

        def fetch_fragment(sid: int, ranges) -> bytes:
            return self._fetch_fragment_or_raise(
                vid, sid, ranges, self._lookup_ec_shards(vid).get(sid, []))

        return make_shard_reader(self.store, vid, fetch, self._ec_read_pool,
                                 stats=self.read_stats,
                                 fetch_fragment=fetch_fragment,
                                 direct=direct, probe=probe,
                                 lock=self._stats_lock)

    def _fetch_range_or_raise(self, vid: int, sid: int, offset: int,
                              length: int, holders: "list[str]") -> bytes:
        """One ranged fetch: healthy holders first, then circuit-open ones
        as a last resort, else OSError."""
        data = self._fetch_remote_shard(vid, sid, offset, length, holders)
        if data is None:
            data = self._fetch_remote_shard(vid, sid, offset, length,
                                            holders, include_open=True)
        if data is None:
            raise OSError(f"shard {vid}.{sid} range [{offset}, +{length}) "
                          "unreachable")
        return data

    def _fetch_fragment_or_raise(self, vid: int, sid: int, ranges,
                                 holders: "list[str]") -> bytes:
        """One computed fragment (scattered ranges packed holder-side); a
        holder that answers a legacy empty stream degrades to per-range
        fetches."""
        want = sum(ln for _, ln in ranges)
        if want == 0:
            return b""
        ordered = retry.order_by_breaker(
            [a for a in holders if retry.breaker(a).would_allow()]) \
            or list(holders)
        for addr in ordered:
            try:
                # a firing failpoint degrades to per-range fetches (no
                # breaker penalty: the peer did nothing wrong)
                failpoints.check("ec.shard.read")
            except failpoints.FailpointError as e:
                log.warning("ec fragment read failpoint: %s", e)
                break
            br = retry.breaker(addr)
            try:
                buf = self.peers.read_fragment(addr, vid, sid, list(ranges))
                if len(buf) == want:
                    br.record_success()
                    return failpoints.corrupt("ec.shard.read.data", buf)
                if not buf:
                    tracing.add_event("fragment_unsupported", peer=addr,
                                      vid=vid, shard=sid)
                    break  # legacy holder: per-range fallback below
                raise OSError(f"fragment length {len(buf)} != {want}")
            except Exception as e:  # noqa: BLE001 — try the next holder
                br.record_failure()
                log.warning("fragment read %d.%d from %s: %s",
                            vid, sid, addr, e)
        out = bytearray()
        for off, ln in ranges:
            out += self._fetch_range_or_raise(vid, sid, off, ln, holders)
        return bytes(out)

    def _make_repair_reader(self, vid: int, codec: "str | None" = None):
        """(shard_reader, fragment_reader, remote_sids, fold_planner) for a
        rebuild on this server. Survivors elsewhere are fetched by range,
        or as packed fragments for the repair-efficient codecs; the fold
        planner groups far-DC msr helpers behind a same-DC relay. The
        location cache is bypassed (a rebuild planned against a
        pre-failure holder set would count the lost shard among its
        survivors), and the holder lists drop this server itself."""
        locs = self._lookup_ec_shards_peers(vid)
        if locs is None:
            # the lookup failed: use the cached entry as it stands
            with self._ec_loc_lock:
                ent = self._ec_loc_cache.get(vid)
            locs = ent[0] if ent is not None else {}
        else:
            with self._ec_loc_lock:
                self._ec_loc_cache[vid] = (locs, time.monotonic(), False)
        me = self.peer_address
        peers = {sid: [a for a in addrs if a != me]
                 for sid, addrs in locs.items()}
        remote = sorted(sid for sid, addrs in peers.items() if addrs)
        if codec is None:
            ev = self.store.find_ec_volume(vid)
            codec = ev.codec if ev is not None else "rs"

        def dc_of(addr: str) -> str:
            return self.peers.data_center(addr) if self.peers else ""

        def book(link: str, n: int) -> None:
            from ..stats import REPAIR_BYTES_BY_LINK
            REPAIR_BYTES_BY_LINK.inc(codec, link, amount=n)

        def link_of(sid: int) -> "str | None":
            # attributed to the first holder, the one almost always used
            holders = peers.get(sid)
            if not holders or not self.data_center:
                return None
            dc = dc_of(holders[0])
            if not dc:
                return None
            return "cross_rack" if dc == self.data_center else "cross_dc"

        def reader(sid: int, offset: int, length: int) -> bytes:
            data = self._fetch_range_or_raise(vid, sid, offset, length,
                                              peers.get(sid, []))
            link = link_of(sid)
            if link:
                book(link, len(data))
            return data

        def fragment_reader(sid: int, ranges) -> bytes:
            buf = self._fetch_fragment_or_raise(vid, sid, ranges,
                                                peers.get(sid, []))
            link = link_of(sid)
            if link:
                book(link, len(buf))
            return buf

        def fold_fetch(f, sids, srcs, mat, alpha):
            """One relay group's fetch(ranges) -> folded partial of alpha
            rows: the relay (sids[0] on srcs[0]) gathers the group's rows
            DC-locally and applies the stacked combine matrix."""
            relay_sid, relay = sids[0], srcs[0]

            def fetch(ranges) -> np.ndarray:
                want = alpha * ranges[0][1]
                try:
                    buf = self.peers.read_fragment(
                        relay, vid, relay_sid, list(ranges),
                        combine_rows=alpha, combine_matrix=mat.tobytes(),
                        gather_shard_ids=list(sids[1:]),
                        gather_sources=list(srcs[1:]))
                    if len(buf) != want:
                        raise OSError(f"folded partial {len(buf)} bytes "
                                      f"!= {want}")
                    book("cross_dc", want)
                    return np.frombuffer(buf, dtype=np.uint8)
                except Exception as e:  # noqa: BLE001 — fold locally instead
                    log.warning("folded fetch vid=%d f=%d relay=%s: %s; "
                                "shipping raw fragments", vid, f, relay, e)
                from ..ops import gf8
                w = ranges[0][1]
                rows = []
                for s in sids:
                    arr = np.frombuffer(fragment_reader(s, list(ranges)),
                                        dtype=np.uint8)
                    rows.extend(arr.reshape(len(ranges), w))
                return gf8.np_gf_apply(mat, np.stack(rows))
            return fetch

        def fold_planner(coder, f: int):
            """[(sids, fetch)] relay groups: one per far DC holding more
            than q helpers (geo/repair_fold.py); empty when folding is off
            (SWTPU_GEO_FOLD=0), the topology is unknown or no far group
            pays for a relay hop."""
            if os.environ.get("SWTPU_GEO_FOLD", "1") == "0" or \
                    not self.data_center or coder.codec != "msr":
                return []
            g = coder.grid
            if g.q < 2:
                return []
            from ..geo import repair_fold
            helper_dcs = {}
            for sid, addrs in peers.items():
                if sid != f and addrs:
                    dc = dc_of(addrs[0])
                    if dc:
                        helper_dcs[sid] = dc
            folds = []
            for dc, sids in repair_fold.fold_groups(
                    helper_dcs, self.data_center, g.q):
                srcs = []
                for s in sids:
                    cands = [a for a in peers.get(s, ()) if dc_of(a) == dc]
                    if not cands:
                        break
                    srcs.append(cands[0])
                if len(srcs) != len(sids):
                    continue  # a member lost its in-DC holder
                mat = repair_fold.stacked_matrix(g.d, g.p, f, sids)
                folds.append((sids, fold_fetch(f, sids, srcs, mat, g.alpha)))
            return folds
        return reader, fragment_reader, remote, fold_planner

    # -- RPC bodies: volume admin -----------------------------------------------
    def _volume(self, vid: int, where: str = "found"):
        v = self.store.find_volume(vid)
        if v is None:
            raise RpcAbort(NOT_FOUND, f"volume {vid} not {where}")
        return v

    def allocate_volume(self, volume_id: int, collection: str = "",
                        replication: str = "", ttl: str = "",
                        disk_type: str = "") -> None:
        self.store.add_volume(volume_id, collection, replication, ttl,
                              disk_type or None)
        self.flush_heartbeat()

    def volume_delete(self, volume_id: int, only_empty: bool = False) -> None:
        self.store.delete_volume(volume_id, only_empty)
        self.flush_heartbeat()

    def volume_mark_readonly(self, volume_id: int) -> None:
        self.store.mark_readonly(volume_id, True)
        self.flush_heartbeat()

    def volume_mark_writable(self, volume_id: int) -> None:
        self.store.mark_readonly(volume_id, False)
        self.flush_heartbeat()

    def volume_mount(self, volume_id: int, collection: str = "") -> None:
        self.store.mount_volume(volume_id, collection)
        self.flush_heartbeat()

    def volume_unmount(self, volume_id: int) -> None:
        if not self.store.unmount_volume(volume_id):
            raise RpcAbort(NOT_FOUND, f"volume {volume_id} not found")
        self.flush_heartbeat()

    def volume_status(self, volume_id: int) -> dict:
        v = self._volume(volume_id)
        return {"is_read_only": v.read_only, "volume_size": v.content_size,
                "file_count": v.file_count,
                "file_deleted_count": v.deleted_count}

    def ping(self) -> dict:
        now = time.time_ns()
        return {"start_time_ns": now, "remote_time_ns": now,
                "stop_time_ns": time.time_ns()}

    def read_volume_file_status(self, volume_id: int) -> dict:
        v = self._volume(volume_id)
        dat_size = (os.path.getsize(v.dat_path) if os.path.exists(v.dat_path)
                    else v.remote_spec.get("size", 0) if v.remote_spec else 0)
        return {"volume_id": volume_id, "dat_file_size": dat_size,
                "idx_file_size": os.path.getsize(v.idx_path),
                "file_count": v.file_count,
                "compaction_revision": v.super_block.compaction_revision,
                "collection": v.collection}

    def copy_file(self, volume_id: int, collection: str = "", ext: str = "",
                  is_ec_volume: bool = False):
        """The file's bytes in chunks of up to 1 MiB (an iterator). A live
        volume's buffered appends are flushed first: the stream reads
        through a fresh handle. A maintenance-tagged pull (VolumeCopy, a
        shard copy for a repair) admits against this server's maintenance
        budget before it streams: repair storms must not out-read the
        tenants this server serves."""
        v = self.store.find_volume(volume_id)
        if v is not None and ext in (".dat", ".idx"):
            v.sync()
        for loc in self.store.locations:
            path = loc.base_name(collection, volume_id) + ext
            if os.path.exists(path):
                break
        else:
            raise RpcAbort(NOT_FOUND, f"file vol={volume_id}{ext} not found")
        return self._admitted(collection, self._stream_file(path))

    @staticmethod
    def _stream_file(path: str):
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    return
                yield chunk

    def volume_scrub(self, volume_id: int = 0, device: str = "",
                     time_budget_s: float = 0.0) -> "list[dict]":
        """Check every live needle's CRC (storage/scrub.py), kernel K3 on
        the card. `device` "", "auto" and "on" scrub on this server's own
        device; "off" (the host loop), "cpu" and "cuda" are taken as
        named; anything else is refused. No card is probed for: "cuda" on a
        host without one gives an error result. One failing volume never
        loses the others' results; with no volume named, a time budget and
        a rotating cursor cover a large server across sweeps."""
        from ..storage.scrub import scrub_volume
        if device in ("", "auto", "on"):
            device = self.device
        elif device not in ("off", "cpu", "cuda"):
            raise RpcAbort(INVALID_ARGUMENT, f"scrub device {device!r}: one "
                           "of '', 'auto', 'on', 'off', 'cpu', 'cuda'")
        if volume_id:
            vols = [self._volume(volume_id)]
        else:
            vols = []
            for loc in self.store.locations:
                with loc.lock:
                    vols.extend(loc.volumes.values())
            vols.sort(key=lambda v: v.id)
            # start after the last volume a budgeted sweep finished with
            cursor = self._scrub_cursor
            vols = ([v for v in vols if v.id > cursor]
                    + [v for v in vols if v.id <= cursor])
        results = []
        deadline = (time.monotonic() + time_budget_s if time_budget_s
                    else None)
        for v in vols:
            try:
                r = scrub_volume(v, device=device)
                results.append({"volume_id": r.volume_id,
                                "scanned": r.scanned,
                                "corrupt_needle_ids": list(r.corrupt),
                                "bytes_checked": r.bytes_checked,
                                "elapsed_s": r.elapsed_s, "mode": r.mode,
                                "error": r.error})
            except Exception as e:  # noqa: BLE001 — isolate per volume
                results.append({"volume_id": v.id, "scanned": 0,
                                "corrupt_needle_ids": [], "bytes_checked": 0,
                                "elapsed_s": 0.0, "mode": "error",
                                "error": str(e)})
            if not volume_id:
                self._scrub_cursor = v.id
            if deadline is not None and time.monotonic() > deadline:
                break
        return results

    # -- vacuum (reference volume_grpc_vacuum.go) -------------------------------
    def vacuum_volume_check(self, volume_id: int) -> float:
        v = self._volume(volume_id)
        # a tiered volume never reports garbage: compacting it would
        # un-tier it and orphan the remote copy
        return 0.0 if v.remote_spec is not None else v.garbage_ratio()

    def vacuum_volume_compact(self, volume_id: int) -> int:
        v = self._volume(volume_id)
        if v.remote_spec is not None:
            raise RpcAbort(FAILED_PRECONDITION, f"volume {volume_id} is "
                           "tiered; download it before compacting")
        _, reclaimed = compact(v)
        return reclaimed

    def vacuum_volume_commit(self, volume_id: int) -> int:
        v = self._volume(volume_id)
        newv = commit_compact(v)
        for loc in self.store.locations:
            if loc.volumes.get(volume_id) is v:
                loc.volumes[volume_id] = newv
        self.flush_heartbeat()
        return newv.content_size

    def vacuum_volume_cleanup(self, volume_id: int) -> None:
        v = self.store.find_volume(volume_id)
        if v is not None:
            base = v.file_name()
            for ext in (".cpd", ".cpx"):
                if os.path.exists(base + ext):
                    os.remove(base + ext)

    # -- EC RPC set (reference volume_grpc_erasure_coding.go) ---------------------
    def _ec_base(self, vid: int, collection: str) -> "str | None":
        """Base path of this server's EC files of `vid`: the mounted
        volume's, else a location holding its .ecx."""
        ev = self.store.find_ec_volume(vid)
        if ev is not None:
            return ev.base
        for loc in self.store.locations:
            cand = loc.base_name(collection, vid)
            if os.path.exists(cand + ".ecx"):
                return cand
        return None

    def _ec_location(self, vid: int, collection: str):
        """The location for a volume's EC files: the one already holding
        its .ecx, else the emptiest."""
        return next((l for l in self.store.locations
                     if os.path.exists(l.base_name(collection, vid) + ".ecx")),
                    None) or self.store._location_for(None)

    def _ensure_vif(self, vid: int, collection: str,
                    base: "str | None" = None) -> "str | None":
        """A rebuild decodes with the codec and geometry sealed in the .vif:
        make sure one exists at `base`, pulling it from a peer holder when
        this server's copy is gone."""
        if base is None:
            base = self._ec_base(vid, collection)
        if base is None or os.path.exists(base + ".vif"):
            return base
        locs = self._lookup_ec_shards(vid, failed=True)
        for addr in sorted({a for addrs in locs.values() for a in addrs
                            if a != self.peer_address}):
            try:
                raw = b"".join(self.peers.copy_file(addr, vid, collection,
                                                    ".vif", True))
                info = json.loads(raw)
            except Exception:  # noqa: BLE001 — the peer may lack it too
                continue
            # installed through the one sanctioned .vif writer, parsed first:
            # a torn peer copy never lands as a valid-looking sidecar
            ec_files.write_vif(base + ".vif", **info)
            return base
        return base

    def volume_ec_shards_generate(self, volume_id: int, collection: str = "",
                                  data_shards: int = 0, parity_shards: int = 0,
                                  codec: str = "") -> None:
        events.emit("ec.encode.start", vid=volume_id, collection=collection,
                    node=self.url)
        t0 = time.perf_counter()
        stats: dict = {}
        try:
            self.store.generate_ec_shards(volume_id, collection,
                                          data_shards or None,
                                          parity_shards or None, stats=stats,
                                          codec=codec or None)
        except Exception as e:
            events.emit("ec.encode.finish", severity=events.ERROR,
                        vid=volume_id, node=self.url, ok=False,
                        error=str(e)[:200])
            raise
        events.emit("ec.encode.finish", vid=volume_id, node=self.url, ok=True,
                    duration_ms=round((time.perf_counter() - t0) * 1e3, 1),
                    **_ec_stage_fields(stats))

    def volume_ec_shards_generate_batch(self, volume_ids, collection: str = "",
                                        data_shards: int = 0,
                                        parity_shards: int = 0,
                                        codec: str = "") -> dict:
        t0 = time.perf_counter()
        stats: dict = {}
        try:
            done = self.store.generate_ec_shards_batch(
                list(volume_ids), collection, data_shards or None,
                parity_shards or None, stats=stats, codec=codec or None)
        except Exception as e:
            events.emit("ec.encode.finish", severity=events.ERROR,
                        node=self.url, ok=False, vids=list(volume_ids),
                        error=str(e))
            raise
        events.emit("ec.encode.finish", node=self.url, ok=True,
                    vids=list(done),
                    duration_ms=round((time.perf_counter() - t0) * 1e3, 1),
                    **_ec_stage_fields(stats))
        return {"encoded_volume_ids": done,
                "data_shards": data_shards or self.store.ec_geometry.d,
                "parity_shards": parity_shards or self.store.ec_geometry.p,
                "codec": codec or self.store.ec_codec}

    def volume_ec_shards_info(self, volume_id: int,
                              collection: str = "") -> dict:
        """Geometry probe from the .vif. local_shard_ids lists every shard
        file on disk, mounted or not (the repair planner's remount probe)."""
        def on_disk(base):
            return sorted(sid for sid in range(32)
                          if os.path.exists(base + ec_files.shard_ext(sid)))
        ev = self.store.find_ec_volume(volume_id)
        if ev is not None:
            return {"data_shards": ev.geo.d, "parity_shards": ev.geo.p,
                    "dat_size": ev.dat_size or 0, "codec": ev.codec,
                    "shard_size": ev.shard_size,
                    "local_shard_ids": sorted(set(ev.shards)
                                              | set(on_disk(ev.base))),
                    "remote_shard_ids": ev.remote_shard_ids()}
        for loc in self.store.locations:
            base = loc.base_name(collection, volume_id)
            if os.path.exists(base + ".vif"):
                info = ec_files.read_vif(base + ".vif")
                geo = EcGeometry.from_vif(info, self.store.ec_geometry)
                rem = info.get("remote_shards") or {}
                return {"data_shards": info.get("d", 0),
                        "parity_shards": info.get("p", 0),
                        "dat_size": info.get("dat_size", 0),
                        "codec": info.get("codec", "rs"),
                        "shard_size": geo.shard_file_size(
                            info.get("dat_size", 0)),
                        "local_shard_ids": on_disk(base),
                        "remote_shard_ids": sorted(
                            int(k) for k in rem.get("keys", {}))}
        raise KeyError(f"ec volume {volume_id} not found")

    @_maintenance_tagged
    def volume_ec_shards_rebuild(self, volume_id: int,
                                 collection: str = "") -> dict:
        """Rebuild every shard no server holds, here, with the survivors on
        other servers read by range through the peer plane
        (maintenance-class)."""
        failpoints.check("ec.rebuild")
        events.emit("ec.rebuild.start", vid=volume_id, collection=collection,
                    node=self.url)
        t0 = time.perf_counter()
        stats: dict = {}
        try:
            reader, frag, remote, fold = self._make_repair_reader(volume_id)
            self._ensure_vif(volume_id, collection)
            rebuilt = self.store.rebuild_ec_shards(
                volume_id, collection, shard_reader=reader,
                remote_shards=remote, stats=stats, fragment_reader=frag,
                fold_planner=fold)
        except Exception as e:
            events.emit("ec.rebuild.finish", severity=events.ERROR,
                        vid=volume_id, node=self.url, ok=False,
                        error=str(e)[:200])
            raise
        events.emit("ec.rebuild.finish", vid=volume_id, node=self.url,
                    ok=True, rebuilt_shard_ids=list(rebuilt),
                    codec=stats.get("codec", "rs"),
                    repair_path=stats.get("path"),
                    bytes_read=stats.get("bytes_read", 0),
                    bytes_written=stats.get("bytes_written", 0),
                    duration_ms=round((time.perf_counter() - t0) * 1e3, 1))
        self.flush_heartbeat()
        return {"rebuilt_shard_ids": list(rebuilt),
                "bytes_read": stats.get("bytes_read", 0),
                "bytes_written": stats.get("bytes_written", 0),
                "stats": stats}

    @_maintenance_tagged
    def volume_ec_shards_copy(self, volume_id: int, collection: str = "",
                              shard_ids=(), copy_ecx_file: bool = False,
                              copy_ecj_file: bool = False,
                              copy_vif_file: bool = False,
                              source_data_node: str = "") -> None:
        """Pull shard files from `source_data_node` to this server, into
        the location already holding the volume's .ecx if any."""
        failpoints.check("ec.shard.copy")
        base = self._ec_location(volume_id, collection).base_name(
            collection, volume_id)
        exts = [ec_files.shard_ext(s) for s in shard_ids]
        if copy_ecx_file:
            exts.append(".ecx")
        if copy_ecj_file:
            exts.append(".ecj")
        if copy_vif_file:
            exts.append(".vif")
        for ext in exts:
            try:
                parts = list(self.peers.copy_file(source_data_node, volume_id,
                                                  collection, ext, True))
            except Exception:
                if ext in (".ecj", ".ecx", ".vif"):
                    continue  # optional sidecars may not exist at the source
                raise
            with open(base + ext, "wb") as f:
                for pc in parts:
                    f.write(pc)

    @_maintenance_tagged
    def volume_ec_shards_copy_by_rebuild(self, volume_id: int,
                                         collection: str = "",
                                         shard_ids=()) -> dict:
        """Rebuild `shard_ids` directly onto this server from the
        survivors on its peers (the .vif, with the codec and geometry, is
        the only file copied whole)."""
        base = self.store._location_for(None).base_name(collection, volume_id)
        self._ensure_vif(volume_id, collection, base)
        info = ec_files.read_vif(base + ".vif")
        geo = EcGeometry.from_vif(info, self.store.ec_geometry)
        codec = info.get("codec", "rs")
        reader, frag, remote, fold = self._make_repair_reader(volume_id,
                                                              codec=codec)
        stats: dict = {}
        rebuilt = rebuild_shards(
            base, geo, self.store.coder(geo.d, geo.p, codec=codec),
            wanted=list(shard_ids), shard_reader=reader,
            remote_shards=remote, stats=stats, fragment_reader=frag,
            fold_planner=fold)
        return {"rebuilt_shard_ids": list(rebuilt),
                "bytes_read": stats.get("bytes_read", 0),
                "bytes_written": stats.get("bytes_written", 0),
                "stats": stats}

    def volume_ec_shards_mount(self, volume_id: int,
                               collection: str = "") -> None:
        self.store.mount_ec_shards(volume_id, collection)
        self.flush_heartbeat()

    def volume_ec_shards_unmount(self, volume_id: int, shard_ids=()) -> None:
        self.store.unmount_ec_shards(volume_id, list(shard_ids) or None)
        self.flush_heartbeat()

    def volume_ec_shards_delete(self, volume_id: int, collection: str = "",
                                shard_ids=()) -> None:
        ev = self.store.find_ec_volume(volume_id)
        base = None
        if ev is not None:
            base = ev.base
            for s in shard_ids:
                sh = ev.shards.get(s)
                if sh is not None and hasattr(sh, "pin"):
                    # reads in flight on this shard finish on its open fd
                    sh.pin()
            self.store.unmount_ec_shards(volume_id, list(shard_ids))
        else:
            for loc in self.store.locations:
                cand = loc.base_name(collection, volume_id)
                if any(os.path.exists(cand + ec_files.shard_ext(s))
                       for s in shard_ids):
                    base = cand
                    break
        if base:
            for s in shard_ids:
                p = base + ec_files.shard_ext(s)
                if os.path.exists(p):
                    os.remove(p)
            # a remote-backed shard has no payload file here: release its
            # .vif claim; the remote object is left to its new holder or to
            # the lifecycle reaper
            if os.path.exists(base + ".vif"):
                ec_files.drop_remote_claims(base + ".vif", list(shard_ids))
        self.flush_heartbeat()

    def volume_ec_shards_move(self, volume_id: int, collection: str = "",
                              shard_ids=(), source_data_node: str = "") -> None:
        """Move = copy from the source + delete there, driven from here. A
        shard whose payload lives on the remote tier moves its .vif claim,
        not bytes."""
        need_sidecars = not any(
            os.path.exists(loc.base_name(collection, volume_id) + ".ecx")
            for loc in self.store.locations)
        src = source_data_node
        try:
            sinfo = self.peers.ec_shards_info(src, volume_id, collection)
            claim_sids = [s for s in shard_ids
                          if s in set(sinfo["remote_shard_ids"])]
        except Exception:  # noqa: BLE001 — a peer without it: payload only
            claim_sids = []
        payload_sids = [s for s in shard_ids if s not in set(claim_sids)]
        self.volume_ec_shards_copy(
            volume_id, collection, payload_sids,
            copy_ecx_file=need_sidecars, copy_ecj_file=need_sidecars,
            copy_vif_file=need_sidecars, source_data_node=src)
        base = self._ec_location(volume_id, collection).base_name(
            collection, volume_id)
        claims = None
        if claim_sids:
            raw = b"".join(self.peers.copy_file(src, volume_id, collection,
                                                ".vif", True))
            claims = ec_files.remote_claims(json.loads(raw), claim_sids)
            if claims is None:
                raise RpcAbort(FAILED_PRECONDITION, "source holds no remote "
                               f"claim for shards {list(claim_sids)}")
        if need_sidecars and os.path.exists(base + ".vif"):
            # the whole-sidecar copy brought claims for shards not moving
            # here; exactly one server may hold each claim
            here = ec_files.read_vif(base + ".vif")
            stray = [int(k) for k in (here.get("remote_shards") or {})
                     .get("keys", {}) if int(k) not in set(shard_ids)]
            ec_files.drop_remote_claims(base + ".vif", stray)
        if claims is not None:
            ec_files.merge_remote_claims(base + ".vif", claims)
        self.peers.ec_shards_delete(src, volume_id, collection,
                                    list(shard_ids))
        self.store.mount_ec_shards(volume_id, collection)
        self.flush_heartbeat()

    def volume_ec_shard_read(self, volume_id: int, shard_id: int,
                             offset: int = 0, size: int = 0,
                             fragment_offsets=(), fragment_lengths=(),
                             combine_rows: int = 0, combine_matrix: bytes = b"",
                             gather_shard_ids=(), gather_sources=()):
        """The bytes of one mounted shard (an iterator of chunks of up to
        1 MiB): `size` bytes at `offset`, or the ranged-compute fragment
        of the ranges (fragment_offsets, fragment_lengths) packed in order,
        GF-combined by `combine_matrix` when `combine_rows` is set."""
        ev = self.store.find_ec_volume(volume_id)
        if ev is None:
            raise RpcAbort(NOT_FOUND, f"ec volume {volume_id} not found")
        sh = ev.shards.get(shard_id)
        if sh is None:
            raise RpcAbort(NOT_FOUND, f"shard {shard_id} not on this server")
        if len(fragment_offsets) != len(fragment_lengths):
            raise RpcAbort(INVALID_ARGUMENT,
                           "fragment_offsets/lengths length mismatch")
        frag_ranges = list(zip(fragment_offsets, fragment_lengths))
        # a maintenance-tagged survivor read (a rebuild's ranged fetches)
        # admits and yields to queued foreground work; untagged shard
        # reads are the degraded-read data path and stay admission-free
        cost = sum(ln for _, ln in frag_ranges) if frag_ranges else size
        if frag_ranges:
            return self._admitted(ev.collection, self._serve_fragment(
                volume_id, sh, frag_ranges, combine_rows, combine_matrix,
                list(gather_shard_ids), list(gather_sources)), cost)
        return self._admitted(ev.collection,
                              self._serve_range(sh, offset, size), cost)

    @staticmethod
    def _serve_range(sh, offset: int, size: int):
        remaining = size
        while remaining > 0:
            data = sh.read_at(offset, min(remaining, 1 << 20))
            if not data:
                return
            yield data
            offset += len(data)
            remaining -= len(data)

    def _serve_fragment(self, vid: int, sh, frag_ranges, combine_rows: int,
                        combine_matrix: bytes, gather_ids, gather_sources):
        if not combine_rows:
            if gather_ids:
                # a relay gather without a combine matrix would ship more
                # bytes than the callers fetching directly
                raise RpcAbort(INVALID_ARGUMENT, "gather requires combine_rows")
            return self._serve_packed(sh, frag_ranges)
        # helper-side GF fold: rows_out = M (x) range_rows; it holds every
        # row at once, so its request-controlled size is capped
        from ..ops import gf8
        if len(gather_ids) != len(gather_sources):
            raise RpcAbort(INVALID_ARGUMENT,
                           "gather ids/sources length mismatch")
        gather = list(zip(gather_ids, gather_sources))
        if sum(ln for _, ln in frag_ranges) * (1 + len(gather)) > (64 << 20):
            raise RpcAbort(INVALID_ARGUMENT,
                           "combine fragment exceeds 64 MB; window the request")
        if len({ln for _, ln in frag_ranges}) != 1:
            raise RpcAbort(INVALID_ARGUMENT,
                           "combine needs equal-length ranges")
        total_rows = len(frag_ranges) * (1 + len(gather))
        if len(combine_matrix) != combine_rows * total_rows:
            raise RpcAbort(INVALID_ARGUMENT, "combine_matrix shape mismatch")
        rows = []
        for off, ln in frag_ranges:
            buf = sh.read_at(off, ln)
            if len(buf) != ln:
                raise RpcAbort(INVALID_ARGUMENT,
                               f"fragment range [{off}, +{ln}) beyond shard")
            rows.append(np.frombuffer(buf, dtype=np.uint8))
        # geo relay: the same ranges from DC-local peers; matrix columns run
        # sid-major (own rows first), as geo/repair_fold.stacked_matrix
        for gsid, gsrc in gather:
            try:
                buf = self._fetch_fragment_or_raise(vid, gsid, frag_ranges,
                                                    [gsrc])
            except OSError as e:
                raise RpcAbort(UNAVAILABLE,
                               f"gather shard {gsid} from {gsrc}: {e}") from e
            arr = np.frombuffer(buf, dtype=np.uint8)
            rows.extend(arr.reshape(len(frag_ranges), frag_ranges[0][1]))
        mat = np.frombuffer(combine_matrix, dtype=np.uint8).reshape(
            combine_rows, total_rows)
        data = gf8.np_gf_apply(mat, np.stack(rows)).tobytes()
        return (data[i:i + (1 << 20)] for i in range(0, len(data), 1 << 20))

    @staticmethod
    def _serve_packed(sh, frag_ranges):
        # streamed straight from disk in 1 MiB chunks: a request-controlled
        # fragment never materializes whole
        for off, ln in frag_ranges:
            rem, pos = ln, off
            while rem > 0:
                buf = sh.read_at(pos, min(rem, 1 << 20))
                if not buf:
                    raise RpcAbort(INVALID_ARGUMENT, f"fragment range [{off}, "
                                   f"+{ln}) beyond shard")
                yield buf
                pos += len(buf)
                rem -= len(buf)

    def volume_ec_blob_delete(self, volume_id: int, file_key: int,
                              collection: str = "") -> None:
        ev = self.store.find_ec_volume(volume_id)
        if ev is None:
            raise RpcAbort(NOT_FOUND, f"ec volume {volume_id} not found")
        ev.delete_needle(file_key)

    def volume_ec_shards_to_volume(self, volume_id: int,
                                   collection: str = "") -> None:
        self.store.ec_shards_to_volume(volume_id, collection)
        self.flush_heartbeat()

    def _set_destroy_time(self, vid: int, at: float) -> bool:
        """Stamp DestroyTime into a local EC volume's .vif and live object;
        False when there is no such EC volume here."""
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            return False
        ec_files.update_vif(ev.base + ".vif", {"destroy_time": at})
        ev.destroy_time = at
        return True

    def volume_ec_shards_set_destroy_time(self, volume_id: int,
                                          destroy_time_s: float) -> None:
        if not self._set_destroy_time(volume_id, destroy_time_s):
            raise RpcAbort(NOT_FOUND, f"no ec volume {volume_id}")

    # -- tier moves (reference volume_grpc_tier_*.go) ------------------------------
    def volume_tier_move_dat_to_remote(self, volume_id: int,
                                       destination_backend_name: str,
                                       keep_local_dat_file: bool = False
                                       ) -> dict:
        """Seal and upload the .dat to a remote backend; the volume stays
        readable through ranged reads."""
        from ..storage.backend import open_remote
        v = self._volume(volume_id, "local")
        if v.remote_spec is not None:
            raise RpcAbort(FAILED_PRECONDITION,
                           f"volume {volume_id} already tiered")
        try:
            client = open_remote(destination_backend_name)
        except ValueError as e:
            raise RpcAbort(INVALID_ARGUMENT, str(e)) from e
        was_read_only = v.read_only
        v.read_only = True
        try:
            v.sync()
            key = os.path.basename(v.dat_path)
            size = client.write_object(key, v.dat_path)
        except Exception as e:
            v.read_only = was_read_only  # roll back: no remote copy
            raise RpcAbort(INTERNAL, f"tier upload: {e}") from e
        remote = {"spec": destination_backend_name, "key": key, "size": size}
        ec_files.update_vif(v.vif_path, {"remote": remote})
        if keep_local_dat_file:
            # the local .dat keeps serving; the volume stays read-only and
            # marked tiered so the guards above hold
            v.remote_spec = remote
        else:
            v.close()
            os.unlink(v.dat_path)
            self.store.reload_volume(volume_id)
        return {"processed": size, "processedPercentage": 100.0}

    def volume_tier_move_dat_from_remote(self, volume_id: int,
                                         keep_remote_dat_file: bool = False
                                         ) -> dict:
        """Pull a tiered .dat back to local disk: download to a temporary
        file and check its size before touching the .vif or the remote
        copy; make it durable before the remote copy may go."""
        from ..storage.backend import open_remote
        v = self._volume(volume_id, "local")
        if v.remote_spec is None:
            raise RpcAbort(FAILED_PRECONDITION,
                           f"volume {volume_id} not tiered")
        remote = v.remote_spec
        client = open_remote(remote["spec"])
        tmp = v.dat_path + ".tiertmp"
        try:
            client.read_object_to(remote["key"], tmp)
            got = os.path.getsize(tmp)
            want = remote.get("size") or client.object_size(remote["key"])
            if got != want:
                raise OSError(f"short download: {got} != {want}")
        except Exception as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise RpcAbort(INTERNAL, f"tier download: {e}") from e
        v.close()
        fsutil.fsync_path(tmp)
        os.replace(tmp, v.dat_path)
        fsutil.fsync_dir(v.dat_path)
        ec_files.update_vif(v.vif_path, remove=("remote",))
        nv = self.store.reload_volume(volume_id)
        if not keep_remote_dat_file and nv is not None:
            client.delete_object(remote["key"])
        return {"processed": remote.get("size", 0),
                "processedPercentage": 100.0}

    @_maintenance_tagged
    def volume_ec_shards_tier_move_to_remote(self, volume_id: int,
                                             collection: str = "",
                                             destination_backend_name: str = ""
                                             ) -> dict:
        """Offload this holder's local shard payloads of an EC volume to
        the remote tier; the volume keeps serving through ranged reads.
        The bytes admit maintenance-class, so a lifecycle sweep cannot
        out-read the tenants this server serves."""
        grant = self._maintenance_grant(collection)
        moved = 0
        try:
            moved = self.store.offload_ec_shards(
                volume_id, destination_backend_name, collection=collection)
        except KeyError as e:
            raise RpcAbort(NOT_FOUND, str(e)) from e
        except ValueError as e:
            raise RpcAbort(INVALID_ARGUMENT, str(e)) from e
        except Exception as e:
            raise RpcAbort(INTERNAL, f"ec tier offload: {e}") from e
        finally:
            if grant is not None:
                grant.charge(moved)
                grant.release()
        if moved:
            events.emit("lifecycle.transition", kind="offload",
                        vid=volume_id, node=self.url, collection=collection,
                        **{"from": "ec", "to": "remote"}, bytes_moved=moved)
        return {"processed": moved, "processedPercentage": 100.0}

    @_maintenance_tagged
    def volume_ec_shards_tier_move_from_remote(self, volume_id: int,
                                               collection: str = "",
                                               keep_remote_dat_file: bool = False
                                               ) -> dict:
        """Pull this holder's offloaded shard payloads back to local disk
        (maintenance-class, admitted like the offload)."""
        grant = self._maintenance_grant(collection)
        moved = 0
        try:
            moved = self.store.promote_ec_shards(
                volume_id, collection=collection,
                keep_remote=keep_remote_dat_file)
        except KeyError as e:
            raise RpcAbort(NOT_FOUND, str(e)) from e
        except Exception as e:
            raise RpcAbort(INTERNAL, f"ec tier promote: {e}") from e
        finally:
            if grant is not None:
                grant.charge(moved)
                grant.release()
        if moved:
            events.emit("lifecycle.transition", kind="promote",
                        vid=volume_id, node=self.url, collection=collection,
                        **{"from": "remote", "to": "ec"}, bytes_moved=moved)
        return {"processed": moved, "processedPercentage": 100.0}

    # -- the maintenance plane: copy, sync, tail, deletes, configure, leave ------
    @_maintenance_tagged
    def volume_copy(self, volume_id: int, collection: str = "",
                    source_data_node: str = "", disk_type: str = "") -> int:
        """Pull a whole volume (.dat, then .idx) from `source_data_node`
        through CopyFile on the peer plane (maintenance-class, so the
        source admits the pulls); returns the copy's last append time in
        ns. A partial clone is removed on failure: left on disk it would
        mount as a truncated live volume and refuse every retry. A volume
        already here with a different `disk_type` asked for is a tier move
        on this server (Store.move_volume_local); without one the request
        is refused with ALREADY_EXISTS."""
        from ..storage.volume import Volume
        v_here = self.store.find_volume(volume_id)
        if v_here is not None:
            if disk_type and not any(
                    loc.volumes.get(volume_id) is v_here
                    and loc.disk_type == disk_type
                    for loc in self.store.locations):
                try:
                    self.store.move_volume_local(volume_id, disk_type)
                except (KeyError, OSError) as e:
                    raise RpcAbort(FAILED_PRECONDITION,
                                   f"local tier move: {e}") from e
                self.flush_heartbeat()
                return self.store.find_volume(volume_id).last_append_at_ns
            raise RpcAbort(ALREADY_EXISTS,
                           f"volume {volume_id} already here")
        loc = self.store._location_for(disk_type or None)
        base = loc.base_name(collection, volume_id)
        try:
            for ext in (".dat", ".idx"):
                with open(base + ext, "wb") as f:
                    for chunk in self.peers.copy_file(
                            source_data_node, volume_id, collection, ext):
                        f.write(chunk)
        except Exception:
            for ext in (".dat", ".idx"):
                try:
                    os.remove(base + ext)
                except OSError:
                    pass
            raise
        v = Volume(loc.directory, collection, volume_id,
                   create_if_missing=False)
        with loc.lock:
            loc.volumes[volume_id] = v
        self.flush_heartbeat()
        return v.last_append_at_ns

    def volume_sync_status(self, volume_id: int) -> dict:
        """Where the volume's tail stands: the fields of
        VolumeSyncStatusResponse a follower needs to catch up."""
        v = self._volume(volume_id)
        v.sync()
        return {"volume_id": v.id, "collection": v.collection,
                "tail_offset": v._append_offset,
                "compact_revision": v.super_block.compaction_revision,
                "last_append_at_ns": v.last_append_at_ns}

    def volume_incremental_copy(self, volume_id: int, since_ns: int = 0):
        """The raw .dat bytes of every record appended after `since_ns`,
        in chunks of up to 2 MiB (an iterator)."""
        v = self._volume(volume_id)
        start = v.offset_by_append_ns(since_ns)
        with v._lock:
            end = v._append_offset
        return self._raw_chunks(v, start, end)

    @staticmethod
    def _raw_chunks(v, start: int, end: int, chunk: int = 2 << 20):
        for off in range(start, end, chunk):
            yield v.read_raw(off, min(chunk, end - off))

    def volume_tail_sender(self, volume_id: int, since_ns: int = 0,
                           idle_timeout_seconds: int = 0,
                           alive: "Callable[[], bool] | None" = None):
        """(record bytes, append_at_ns) of every record newer than
        `since_ns`, then of new ones as they land (an iterator). Idle for
        `idle_timeout_seconds` ticks of TAIL_TICK_SECONDS it ends; with 0
        it follows for as long as `alive()` holds (the caller's stream is
        open) and this server runs."""
        v = self._volume(volume_id)
        return self._tail(v, since_ns, idle_timeout_seconds,
                          alive or (lambda: True), TAIL_TICK_SECONDS)

    def _tail(self, v, since_ns: int, idle_timeout: int, alive, tick: float):
        last_ns = since_ns
        draining = idle_timeout
        while alive() and not self._stop.is_set():
            progressed = False
            for rec, ts, _nsize in v.read_records_since(last_ns):
                yield rec, ts
                last_ns = max(last_ns, ts)
                progressed = True
            if idle_timeout:
                if progressed:
                    draining = idle_timeout
                else:
                    draining -= 1
                    if draining <= 0:
                        return
            self._stop.wait(tick)

    def volume_tail_receiver(self, volume_id: int, since_ns: int = 0,
                             idle_timeout_seconds: int = 0,
                             source_volume_server: str = "") -> int:
        """Pull the records of `source_volume_server`'s tail newer than
        `since_ns` into this server's copy of the volume (through the peer
        plane's tail_sender) until the source is idle for
        `idle_timeout_seconds` (2 when 0); returns the records received."""
        v = self._volume(volume_id)
        received = 0
        for rec, _ts in self.peers.tail_sender(
                source_volume_server, volume_id, since_ns,
                idle_timeout_seconds or 2):
            v.append_records(rec)
            received += 1
        return received

    def batch_delete(self, file_ids) -> "list[dict]":
        """Delete each fid here: per fid a DeleteResult's fields with
        status 202 (deleted), 404 (no such needle) or 500 (the fid does
        not parse, or the volume is not here)."""
        out = []
        for fid in file_ids:
            r = {"file_id": fid}
            try:
                vid, key, _cookie = parse_file_id(fid)
                if self.store.delete_needle(vid, key):
                    r["status"] = 202
                else:
                    r.update(status=404, error="not found")
            except Exception as e:  # noqa: BLE001 — a status per fid
                r.update(status=500, error=str(e))
            out.append(r)
        return out

    def volume_configure(self, volume_id: int, replication: str) -> str:
        """Rewrite the super block's replica placement; the error text, ""
        on success (VolumeConfigureResponse reports, never aborts)."""
        v = self.store.find_volume(volume_id)
        if v is None:
            return f"volume {volume_id} not found"
        try:
            rp = ReplicaPlacement.parse(replication)
        except Exception as e:  # noqa: BLE001 — reported, as the reference
            return str(e)
        with v._lock:
            v.super_block.replica_placement = rp
            if v.remote_spec is None:
                v._dat.seek(0)
                v._dat.write(v.super_block.to_bytes())
                v._dat.flush()
        self._replica_cache.pop(volume_id, None)
        self.flush_heartbeat()
        return ""

    def volume_server_leave(self) -> None:
        """Stop heartbeating so the master (and LocalPeers) forget this
        server; its HTTP and gRPC planes keep serving direct reads."""
        self.left.set()

    def volume_needle_status(self, volume_id: int, needle_id: int) -> dict:
        try:
            n = self.store.read_needle(volume_id, needle_id)
        except KeyError as e:
            raise RpcAbort(NOT_FOUND, str(e)) from e
        return {"needle_id": n.id, "cookie": n.cookie, "size": len(n.data),
                "last_modified": n.last_modified, "crc": n.checksum,
                "ttl": str(n.ttl)}

    def query(self, from_file_ids, field: str = "", op: str = "",
              value: str = "", projections=(), input_format: str = "",
              csv_delimiter: str = "", csv_has_header: bool = False,
              output_format: str = "", output_delimiter: str = ""):
        """S3-Select-lite over needles (query/): one QueriedStripe's
        records (bytes) per fid with matches, an iterator. A needle of an
        EC volume is read through this server's shard reader, so one on
        lost shards is reconstructed (K1 at one stripe on the card). A fid
        that does not parse or is not found aborts with NOT_FOUND."""
        import csv
        import io

        from ..query import Query, query_csv_lines, query_json_lines
        q = Query(field=field, op=op, value=value)
        projections = list(projections)
        in_fmt, out_fmt = input_format or "json", output_format or "json"
        for fid in from_file_ids:
            try:
                vid, key, cookie = parse_file_id(fid)
                n = self._store_read(vid, key, cookie)
            except (KeyError, ValueError) as e:
                raise RpcAbort(NOT_FOUND, f"query {fid}: {e}") from e
            data = gzip.decompress(n.data) if n.is_gzipped else n.data
            if in_fmt == "csv":
                rows = query_csv_lines(data, projections, q,
                                       delimiter=csv_delimiter or ",",
                                       has_header=csv_has_header)
            else:
                rows = query_json_lines(data, projections, q)
            if not rows:
                continue
            if out_fmt == "csv":
                sio = io.StringIO()
                wr = csv.writer(sio, delimiter=output_delimiter or ",",
                                lineterminator="\n")
                for row in rows:
                    wr.writerow(["" if v is None else v for v in row])
                yield sio.getvalue().encode()
                continue
            # a whole document when nothing is projected from JSON input
            whole = in_fmt != "csv" and not projections
            yield ("\n".join(json.dumps(row[0] if whole and len(row) == 1
                                         else row) for row in rows)
                   + "\n").encode()


class LocalPeers:
    """The in-process peer plane: servers of one process reach each other
    through their methods (the way storage/backend.LocalDirRemote stands in
    for a cloud tier). `lookup_volume` and `lookup_ec` assemble a volume's
    holders from the servers' heartbeat()s, which is what the master
    answers; a server that has left (VolumeServerLeave) is no longer
    listed, though its methods still answer. A server marked down raises
    ConnectionError, like a dead peer.

    Joining sets each server's `peers` and `peer_address`."""

    def __init__(self, servers: "dict[str, VolumeServer]"):
        self.servers = dict(servers)
        self.down: set = set()
        for addr, vs in self.servers.items():
            vs.peers = self
            vs.peer_address = addr

    def _server(self, addr: str) -> VolumeServer:
        if addr in self.down or addr not in self.servers:
            raise ConnectionError(f"peer {addr} unreachable")
        return self.servers[addr]

    def data_center(self, addr: str) -> str:
        vs = self.servers.get(addr)
        return vs.data_center if vs is not None else ""

    def lookup_volume(self, vid: int) -> "list[str]":
        """HTTP urls (ip:port) of the servers whose heartbeat holds volume
        `vid`: the master's LookupVolume answer."""
        return [vs.url for addr, vs in self.servers.items()
                if addr not in self.down and not vs.left.is_set()
                and any(v["id"] == vid for v in vs.heartbeat()["volumes"])]

    def lookup_ec(self, vid: int) -> "dict[int, list[str]]":
        locs: dict[int, list[str]] = {}
        for addr, vs in self.servers.items():
            if addr in self.down or vs.left.is_set():
                continue
            for s in vs.heartbeat()["ec_shards"]:
                if s["id"] != vid:
                    continue
                for sid in range(32):
                    if s["ec_index_bits"] >> sid & 1:
                        locs.setdefault(sid, []).append(addr)
        return locs

    def read_shard(self, addr: str, vid: int, sid: int, offset: int,
                   size: int) -> bytes:
        return b"".join(self._server(addr).volume_ec_shard_read(
            vid, sid, offset=offset, size=size))

    def read_fragment(self, addr: str, vid: int, sid: int, ranges,
                      combine_rows: int = 0, combine_matrix: bytes = b"",
                      gather_shard_ids=(), gather_sources=()) -> bytes:
        return b"".join(self._server(addr).volume_ec_shard_read(
            vid, sid, fragment_offsets=[o for o, _ in ranges],
            fragment_lengths=[ln for _, ln in ranges],
            combine_rows=combine_rows, combine_matrix=combine_matrix,
            gather_shard_ids=gather_shard_ids,
            gather_sources=gather_sources))

    def copy_file(self, addr: str, vid: int, collection: str, ext: str,
                  is_ec_volume: bool = False):
        return self._server(addr).copy_file(vid, collection, ext,
                                            is_ec_volume)

    def tail_sender(self, addr: str, vid: int, since_ns: int,
                    idle_timeout_seconds: int):
        return self._server(addr).volume_tail_sender(
            vid, since_ns, idle_timeout_seconds)

    def ec_shards_info(self, addr: str, vid: int, collection: str) -> dict:
        return self._server(addr).volume_ec_shards_info(vid, collection)

    def ec_shards_delete(self, addr: str, vid: int, collection: str,
                         shard_ids) -> None:
        self._server(addr).volume_ec_shards_delete(vid, collection,
                                                   list(shard_ids))
