"""EC encode / rebuild / decode pipelines over volume files.

Port of seaweedfs_tpu/ec/encoder.py. Reference:
weed/storage/erasure_coding/ec_encoder.go:57 (`WriteEcFiles`), :61
(`RebuildEcFiles`), ec_decoder.go:154 (`WriteDatFile`). Slabs from many rows
(and many volumes) are batched into a single [B, d, C] uint8 tensor per device
call. Data shards are pure strided copies (no compute); only parity rides the
coder.

The whole .dat byte stream is striped, super block included, exactly like the
reference — decode reproduces the original file bit-for-bit.

Rebuild reads survivors from local shard files and, through a caller's
`shard_reader` (ranges) or `fragment_reader` (packed ranged-compute
fragments), from another server (ec/repair.make_readers), and takes the
cheapest path its codec offers (ec/repair.REBUILDERS).
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np

from .. import tracing
from ..ops.coder import ErasureCoder
from ..stats import EC_REBUILD_BYTES
from . import files, repair
from .locate import EcGeometry
from .stream import AsyncPipe

DEFAULT_CHUNK = 1 << 20   # device slab length per stripe row
DEFAULT_BATCH = 32        # slabs per device call


def encode_volume(dat_path: str, out_base: str, geo: EcGeometry,
                  coder: ErasureCoder, idx_path: str | None = None,
                  chunk: int = DEFAULT_CHUNK, batch: int = DEFAULT_BATCH,
                  stats: "dict | None" = None,
                  writers: "int | None" = None,
                  ) -> list[str]:
    """Produce .ec00..ec{n-1} (+ .ecx if idx_path given). Returns shard paths.

    Single-volume wrapper over the streaming multi-volume pipeline
    (ec/stream.py); `stats` receives the stage breakdown and `writers`
    sizes the writeback plane.
    """
    from . import stream
    res = stream.encode_volumes([(dat_path, out_base, idx_path)], geo, coder,
                                chunk=chunk, batch=batch, stats=stats,
                                writers=writers)
    return res[dat_path]


def find_shards(base: str, n: int) -> dict[int, str]:
    return {i: base + files.shard_ext(i)
            for i in range(n) if os.path.exists(base + files.shard_ext(i))}


def rebuild_shards(base: str, geo: EcGeometry, coder: ErasureCoder,
                   wanted: Sequence[int] | None = None,
                   chunk: int = DEFAULT_CHUNK, batch: int = DEFAULT_BATCH,
                   shard_reader=None,
                   remote_shards: Sequence[int] | None = None,
                   stats: "dict | None" = None,
                   fragment_reader=None,
                   fold_planner=None,
                   ) -> list[int]:
    """Recreate missing shard files from >= d survivors.

    Reference: RebuildEcFiles ec_encoder.go:61 / rebuildEcFiles :237-291.
    Survivors may live elsewhere: `shard_reader(sid, offset, length)`
    serves the ids listed in `remote_shards` by range, so a
    repair-efficient codec's plan fetches byte ranges instead of d full
    shards; `fragment_reader(sid, ranges)` lets a holder gather scattered
    ranges and ship ONE fragment (the msr codec's beta-fragments ride it).
    `fold_planner(coder, f) -> [(sids, fetch)]` lets the caller group
    far survivors behind relay holders that fold their plane rows into one
    partial; it is consulted only on the single-loss msr path. Every
    survivor byte consumed lands in SeaweedFS_repair_bytes_read_total{codec}
    and the call is one ec.rebuild span. `stats` receives bytes_read /
    bytes_written / codec / path / shard_size, the stage times read_s /
    write_s / flush_s / wall_s, `remote` (how many
    survivors a reader could serve remotely), and remote_bytes_read /
    remote_read_s / local_read_s (the survivor reads by kind). Returns the
    shard ids rebuilt (always written under `base`).
    """
    present_local = find_shards(base, geo.n)
    # a shard the caller explicitly wants rebuilt is never a survivor,
    # even if a stale holder list still claims a remote copy
    remote = [s for s in (remote_shards or ())
              if s not in present_local and shard_reader is not None
              and (wanted is None or s not in set(wanted))]
    present = set(present_local) | set(remote)
    missing = sorted(set(wanted) if wanted is not None
                     else set(range(geo.n)) - present)
    missing = [m for m in missing if m not in present_local]
    if not missing:
        return []
    if len(present) < geo.d:
        raise RuntimeError(
            f"cannot rebuild: only {len(present)} shards present, need {geo.d}")
    shard_size = _shard_size(base, geo, present_local)
    counter = repair.RepairCounter(coder.codec)
    t_wall0 = time.perf_counter()
    with tracing.start_span(
            "ec.rebuild", component="ec",
            attrs={"base": os.path.basename(base), "missing": missing,
                   "present": len(present), "remote": len(remote),
                   "coder": type(coder).__name__,
                   "codec": coder.codec}) as sp:
        readers, frag_readers, close = repair.make_readers(
            base, present_local, shard_reader, remote, counter,
            fragment_reader=fragment_reader)
        try:
            path = _dispatch_rebuild(base, geo, coder, tuple(sorted(present)),
                                     missing, readers, frag_readers,
                                     shard_size, chunk, batch, counter,
                                     fold_planner=fold_planner,
                                     local_sids=frozenset(present_local))
        finally:
            close()
        sp.set_attr("bytes_read", counter.bytes_read)
        sp.set_attr("bytes_written", counter.bytes_written)
        sp.set_attr("path", path)
    if stats is not None:
        stats.update(bytes_read=counter.bytes_read,
                     bytes_written=counter.bytes_written,
                     codec=coder.codec, path=path, shard_size=shard_size,
                     remote=len(remote), read_s=counter.read_s,
                     write_s=counter.write_s, flush_s=counter.flush_s,
                     remote_bytes_read=counter.remote_bytes_read,
                     remote_read_s=counter.remote_read_s,
                     local_read_s=counter.local_read_s,
                     wall_s=time.perf_counter() - t_wall0)
    return missing


def _shard_size(base: str, geo: EcGeometry,
                present_local: dict[int, str]) -> int:
    if present_local:
        return os.path.getsize(next(iter(present_local.values())))
    info = files.read_vif(base + ".vif")
    dat_size = info.get("dat_size")
    if dat_size is None:
        raise RuntimeError(f"cannot size shards of {base}: no local "
                           "survivor and no .vif")
    return geo.shard_file_size(dat_size)


def _dispatch_rebuild(base: str, geo: EcGeometry, coder: ErasureCoder,
                      present: tuple, missing: list[int], readers: dict,
                      frag_readers: dict, shard_size: int, chunk: int,
                      batch: int, counter, fold_planner=None,
                      local_sids: frozenset = frozenset()) -> str:
    """Pick the cheapest reconstruction the codec supports, resolved
    through repair.REBUILDERS, so a codec plugs in its executors without
    touching this dispatch. Returns the path taken ("ranged" |
    "ranged-folded" | "general" | "full")."""
    ranged, general = repair.REBUILDERS.get(coder.codec, (None, None))
    plan = coder.repair_plan(present, tuple(missing), shard_size)
    if plan is not None and ranged is not None:
        folds = ()
        if fold_planner is not None and coder.codec == "msr":
            # a survivor on THIS disk never folds: local preads beat any
            # relay hop, and a stale holder list must not reroute them
            folds = tuple(x for x in (fold_planner(coder, missing[0]) or ())
                          if not set(x[0]) & local_sids)
        if folds:
            ranged(base, coder, missing[0], readers, frag_readers,
                   shard_size, counter, folds=folds)
            return "ranged-folded"
        ranged(base, coder, missing[0], readers, frag_readers, shard_size,
               counter)
        return "ranged"
    if general is not None:
        general(base, coder, present, missing, readers, frag_readers,
                shard_size, counter)
        return "general"
    _rebuild_positional(base, geo, coder, present, missing, readers,
                        shard_size, chunk, batch, counter)
    return "full"


def _rebuild_positional(base: str, geo: EcGeometry, coder: ErasureCoder,
                        present: tuple, missing: list[int], readers: dict,
                        shard_size: int, chunk: int, batch: int,
                        counter) -> None:
    """Plain-RS path: positional reconstruct over [batch, d, chunk] slabs
    of the first d survivors (device-batched like encode)."""
    use = sorted(present)[:geo.d]
    # shards shorter than one batch need no full-size staging buffers
    chunk = max(1, min(chunk, shard_size))
    batch = max(1, min(batch, -(-shard_size // chunk)))
    outs = {}
    for m in missing:
        p = base + files.shard_ext(m)
        with open(p, "wb") as f:
            f.truncate(shard_size)
        outs[m] = np.memmap(p, dtype=np.uint8, mode="r+", shape=(shard_size,))

    present_t = tuple(use)
    wanted_t = tuple(missing)
    pipe = AsyncPipe((batch, geo.d, chunk), alloc=coder.host_buffer)

    def drain(rebuilt: np.ndarray, ctx) -> None:
        off, span, nb = ctx
        t0 = time.perf_counter()
        for k, m in enumerate(missing):
            outs[m][off:off + span] = rebuilt[:nb, k].reshape(-1)[:span]
        counter.write_s += time.perf_counter() - t0
        counter.wrote(span * len(missing))

    for off in range(0, shard_size, chunk * batch):
        span = min(chunk * batch, shard_size - off)
        nb = (span + chunk - 1) // chunk
        arr = pipe.next_buffer()
        t0 = time.perf_counter()
        # vectorized survivor load: one strided copy per survivor shard
        for r, sid in enumerate(use):
            row = readers[sid](off, span)
            if span < nb * chunk:
                padded = np.zeros(nb * chunk, dtype=np.uint8)
                padded[:span] = row
                arr[:nb, r] = padded.reshape(nb, chunk)
            else:
                arr[:nb, r] = row.reshape(nb, chunk)
        if nb < batch:
            arr[nb:] = 0
        counter.read_s += time.perf_counter() - t0
        EC_REBUILD_BYTES.inc(type(coder).__name__, amount=arr.nbytes)
        pipe.submit(coder.reconstruct(arr, present_t, wanted_t),
                    (off, span, nb), drain)
    pipe.flush()
    t0 = time.perf_counter()
    for o in outs.values():
        o.flush()
    counter.flush_s += time.perf_counter() - t0


def decode_volume(base: str, dat_out: str, geo: EcGeometry,
                  coder: ErasureCoder, dat_size: int | None = None) -> None:
    """Concatenate data shards row-interleaved back into a .dat
    (reference ec_decoder.go:154 WriteDatFile). Rebuilds missing data shards
    first if any."""
    present = find_shards(base, geo.n)
    missing_data = [i for i in range(geo.d) if i not in present]
    if missing_data:
        rebuild_shards(base, geo, coder, wanted=missing_data)
        present = find_shards(base, geo.n)
    if dat_size is None:
        info = files.read_vif(base + ".vif")
        dat_size = info.get("dat_size")
        if dat_size is None:
            dat_size = files.max_ecx_extent(base + ".ecx")
    if dat_size == 0:
        open(dat_out, "wb").close()
        return
    shards = [np.memmap(present[i], dtype=np.uint8, mode="r") for i in range(geo.d)]
    with open(dat_out, "wb") as f:
        f.truncate(dat_size)
    out = np.memmap(dat_out, dtype=np.uint8, mode="r+", shape=(dat_size,))
    # vectorized region copies (mirror of stream._VolumePlan region views)
    d, lb, sb = geo.d, geo.large_block, geo.small_block
    nl = geo.large_rows(dat_size)
    large_bytes = nl * d * lb
    if nl:
        view = out[:large_bytes].reshape(nl, d, lb)
        for i in range(d):
            view[:, i, :] = np.asarray(shards[i][:nl * lb]).reshape(nl, lb)
    rest = dat_size - large_bytes
    full = rest // (d * sb)
    if full:
        view = out[large_bytes:large_bytes + full * d * sb].reshape(full, d, sb)
        for i in range(d):
            view[:, i, :] = np.asarray(
                shards[i][nl * lb:nl * lb + full * sb]).reshape(full, sb)
    tail_start = large_bytes + full * d * sb
    pos = tail_start
    shard_base = nl * lb + full * sb
    for i in range(d):
        if pos >= dat_size:
            break
        ln = min(sb, dat_size - pos)
        out[pos:pos + ln] = shards[i][shard_base:shard_base + ln]
        pos += ln
    out.flush()
