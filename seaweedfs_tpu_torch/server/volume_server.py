"""The volume server's EC read path: the shard reader behind needle reads
of an EC volume whose shards are spread over servers.

Port of the plain-RS degraded read of seaweedfs_tpu/server/volume_server.py
(`VolumeServer._make_shard_reader`, :1827-1973; reference store_ec.go:357-400)
as a function of a Store, so that the server class, when it is ported, wraps
it. `fetch(sid, offset, length) -> bytes | None` stands in for the remote
shard fetch over the holder lists that come with the server. Not ported:
the msr and piggyback branches, the stale-location refresh and the last
probe of circuit-open holders.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..ops.coder import host_result

# fetch(shard_id, offset, length) -> the bytes, or None when no holder
# answered
Fetch = Callable[[int, int, int], Optional[bytes]]


def make_shard_reader(store, vid: int, fetch: Fetch,
                      pool: cf.Executor, stats: "dict | None" = None):
    """A `shard_reader(shard_id, offset, length) -> bytes` for EC volume
    `vid` of `store`: `fetch` serves the shard itself; when it gives None,
    the interval is reconstructed from d other shards, local ones first,
    the rest fetched concurrently on `pool` until d have answered. Fewer
    than d reachable raises OSError (an availability failure, not a lookup
    miss). The GF step runs on `store.coder` (kernel K1 on the card).

    `stats`, when given, accumulates `reconstructs` (degraded intervals),
    `gather_s` (survivor reads and fetches) and `decode_s` (stacking the
    survivors, the coder call and its host_result)."""
    mu = threading.Lock()

    def reader(shard_id: int, offset: int, length: int) -> bytes:
        data = fetch(shard_id, offset, length)
        if data is not None:
            return data
        return _reconstruct(shard_id, offset, length)

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
        if ev.codec != "rs":
            raise NotImplementedError(
                f"degraded reads of codec {ev.codec!r} are not yet ported "
                f"to seaweedfs_tpu_torch")
        geo = ev.geo
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
        if len(gathered) < geo.d and remote_sids:
            # fetched concurrently: sequential fetches would stack one round
            # trip per shard onto the degraded latency
            futs = {pool.submit(fetch, sid, offset, length): sid
                    for sid in remote_sids}
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
        survivors = np.stack([np.frombuffer(gathered[s], dtype=np.uint8)
                              for s in present])
        out = host_result(coder.reconstruct(survivors, present, (shard_id,)))
        if stats is not None:
            t2 = time.perf_counter()
            with mu:
                stats["reconstructs"] = stats.get("reconstructs", 0) + 1
                stats["gather_s"] = stats.get("gather_s", 0.0) + t1 - t0
                stats["decode_s"] = stats.get("decode_s", 0.0) + t2 - t1
        return out[0].tobytes()

    return reader
