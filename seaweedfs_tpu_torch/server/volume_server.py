"""The volume server's EC read path: the shard reader behind needle reads
of an EC volume whose shards are spread over servers.

Port of the degraded read of seaweedfs_tpu/server/volume_server.py
(`VolumeServer._make_shard_reader`, :1827-2070; reference store_ec.go:357-400)
as a function of a Store, so that the server class, when it is ported, wraps
it. `fetch(sid, offset, length) -> bytes | None` stands in for the remote
shard fetch over the holder lists that come with the server, and
`fetch_fragment(sid, ranges) -> bytes | None` for its ranged-compute fetch
(`_fetch_fragment_or_raise`). All three codecs are served: plain RS
positionally, piggyback with its strip of a load-bearing piggybacked parity,
msr through the codec's interval plans. Not ported: the stale-location
refresh and the last probe of circuit-open holders.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..ec import repair as ec_repair
from ..ops.coder import host_result
from ..stats import DEGRADED_EC_READS
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
                      fetch_fragment: "FetchFragment | None" = None):
    """A `shard_reader(shard_id, offset, length) -> bytes` for EC volume
    `vid` of `store`: `fetch` serves the shard itself; when it gives None,
    the interval is reconstructed — from d other shards for plain RS and
    piggyback, local ones first, the rest fetched concurrently on `pool`
    until d have answered; from the msr interval plan's layer slices
    (`fetch_fragment`, by default `fetch` joined over the ranges) for msr.
    Fewer survivors than the decode needs raises OSError (an availability
    failure, not a lookup miss). The GF steps run on `store.coder`
    (kernel K1 on the card).

    Every degraded interval counts one SeaweedFS_degraded_ec_reads_total.
    `stats`, when given, accumulates `reconstructs` (degraded intervals),
    `gather_s` (survivor reads and fetches), `decode_s` (the decode with
    its coder calls and, for the piggyback strip, its paired a-range
    fetches), `fetch_bytes` (survivor bytes gathered for the decodes),
    `strips` (piggyback intervals whose b-half span was decoded through a
    piggybacked parity, its piggyback stripped with the paired a-range)
    and `msr_mode` (msr intervals by plan mode: "repair", "general", or
    the modes of a ragged span's pieces joined by "+")."""
    mu = threading.Lock()
    fetch_fragment = fetch_fragment or _joined(fetch)

    def reader(shard_id: int, offset: int, length: int) -> bytes:
        data = fetch(shard_id, offset, length)
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
