"""Repair-traffic plumbing: byte-counted shard readers, codec overlay
seals, ranged/codec-aware rebuild paths, and degraded-interval
reconstruction for piggybacked and MSR volumes.

Port of seaweedfs_tpu/ec/repair.py. This module is the file-and-wire half
of ops/piggyback.py and ops/product_matrix.py: the coders own the GF math
and the repair *plan* (which byte ranges, or computed fragments, of which
survivors); this module executes plans against local shard files and
remote fetches (`shard_reader` for ranges, `fragment_reader` for a
holder's ranged-compute read, one packed fragment per survivor per
window), counts every survivor byte, and streams in bounded windows.

Every coder output goes through `host_result`: on the card the inner
TorchCoder hands back a DeviceResult, not an array.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np

from ..ops.coder import host_result
from ..ops.piggyback import PiggybackCoder
from ..stats import REPAIR_BYTES_READ, REPAIR_BYTES_WRITTEN
from ..utils.log import logger
from . import files

log = logger("ec.repair")

# streaming window for the windowed repair paths: big enough to amortize
# per-call fetch overhead, small enough to keep d in-flight rows bounded
REPAIR_WINDOW = 4 << 20

# shard_reader(shard_id, offset, length) -> bytes (ec/volume.py contract)
ShardReader = Callable[[int, int, int], bytes]

# fragment_reader(shard_id, [(offset, length), ...]) -> bytes: the
# ranged-compute shard read — the holder gathers the scattered ranges and
# ships ONE packed fragment
FragmentReader = Callable[[int, list], bytes]


class RepairCounter:
    """Survivor bytes read and rebuilt bytes written by one repair, mirrored
    to the codec-labelled repair counters as they accumulate, and where its
    wall time went: read_s (loading survivor slabs on the positional
    plain-RS path), write_s (copying rebuilt rows out), flush_s (flushing
    the rebuilt files), and the time spent in remote and local survivor
    reads with the bytes each served (on the codec paths these two are the
    whole read time)."""

    def __init__(self, codec: str):
        self.codec = codec or "rs"
        self.bytes_read = 0
        self.bytes_written = 0
        self.read_s = self.write_s = self.flush_s = 0.0
        self.remote_bytes_read = 0
        self.remote_read_s = self.local_read_s = 0.0

    def read(self, n: int, seconds: float = 0.0, remote: bool = False) -> None:
        self.bytes_read += n
        REPAIR_BYTES_READ.inc(self.codec, amount=n)
        if remote:
            self.remote_bytes_read += n
            self.remote_read_s += seconds
        else:
            self.local_read_s += seconds

    def wrote(self, n: int) -> None:
        self.bytes_written += n
        REPAIR_BYTES_WRITTEN.inc(self.codec, amount=n)


def make_readers(base: str, present_local: "dict[int, str]",
                 shard_reader: "ShardReader | None",
                 remote_sids, counter: RepairCounter,
                 fragment_reader: "FragmentReader | None" = None,
                 ) -> "tuple[dict[int, Callable[[int, int], np.ndarray]], dict[int, Callable], Callable[[], None]]":
    """(readers, frag_readers, close): per-shard `read(offset, length)` and
    `frag(ranges) -> concatenated uint8 array` over local files and remote
    fetches, every byte counted; a short read raises OSError. Fragment
    reads of local shards are gathered preads; remote ones go through
    `fragment_reader` when the caller wires it, else one ranged
    `shard_reader` fetch per run."""
    fds: dict[int, int] = {}

    def local(sid: int):
        def read(off: int, ln: int) -> np.ndarray:
            t0 = time.perf_counter()
            buf = os.pread(fds[sid], ln, off)
            if len(buf) != ln:
                raise OSError(f"short read of shard {sid} at {off}")
            counter.read(ln, time.perf_counter() - t0)
            return np.frombuffer(buf, dtype=np.uint8)
        return read

    def local_frag(sid: int):
        def frag(ranges) -> np.ndarray:
            t0 = time.perf_counter()
            out = np.empty(sum(ln for _, ln in ranges), dtype=np.uint8)
            pos = 0
            for off, ln in ranges:
                buf = os.pread(fds[sid], ln, off)
                if len(buf) != ln:
                    raise OSError(f"short read of shard {sid} at {off}")
                out[pos:pos + ln] = np.frombuffer(buf, dtype=np.uint8)
                pos += ln
            counter.read(len(out), time.perf_counter() - t0)
            return out
        return frag

    def remote(sid: int):
        def read(off: int, ln: int) -> np.ndarray:
            t0 = time.perf_counter()
            buf = shard_reader(sid, off, ln)
            if len(buf) != ln:
                raise OSError(f"short remote read of shard {sid} at {off}")
            counter.read(ln, time.perf_counter() - t0, remote=True)
            return np.frombuffer(buf, dtype=np.uint8)
        return read

    def remote_frag(sid: int):
        def frag(ranges) -> np.ndarray:
            t0 = time.perf_counter()
            want = sum(ln for _, ln in ranges)
            if fragment_reader is not None:
                buf = fragment_reader(sid, list(ranges))
                if len(buf) != want:
                    raise OSError(f"short fragment from shard {sid}: "
                                  f"{len(buf)} != {want}")
                counter.read(want, time.perf_counter() - t0, remote=True)
                return np.frombuffer(buf, dtype=np.uint8)
            out = np.empty(want, dtype=np.uint8)
            pos = 0
            for off, ln in ranges:
                buf = shard_reader(sid, off, ln)
                if len(buf) != ln:
                    raise OSError(f"short remote read of shard {sid}")
                out[pos:pos + ln] = np.frombuffer(buf, dtype=np.uint8)
                pos += ln
            counter.read(want, time.perf_counter() - t0, remote=True)
            return out
        return frag

    readers: dict[int, Callable] = {}
    frag_readers: dict[int, Callable] = {}
    try:
        for sid, path in present_local.items():
            fds[sid] = os.open(path, os.O_RDONLY)
            readers[sid] = local(sid)
            frag_readers[sid] = local_frag(sid)
    except BaseException:
        for fd in fds.values():
            os.close(fd)
        raise
    for sid in remote_sids or ():
        if sid not in readers and shard_reader is not None:
            readers[sid] = remote(sid)
            frag_readers[sid] = remote_frag(sid)

    def close() -> None:
        for fd in fds.values():
            try:
                os.close(fd)
            except OSError:
                log.debug("closing survivor fd under %s failed", base,
                          exc_info=True)
    return readers, frag_readers, close


def _open_outputs(base: str, missing, shard_size: int) -> "dict[int, int]":
    outs = {}
    for m in missing:
        p = base + files.shard_ext(m)
        with open(p, "wb") as f:
            f.truncate(shard_size)
        outs[m] = os.open(p, os.O_RDWR)
    return outs


def _pwrite(fd: int, arr: np.ndarray, off: int) -> None:
    mv = memoryview(np.ascontiguousarray(arr)).cast("B")
    n = os.pwrite(fd, mv, off)
    while n < len(mv):
        mv = mv[n:]
        off += n
        n = os.pwrite(fd, mv, off)




def _write_out(counter: RepairCounter, fd: int, arr: np.ndarray,
               off: int) -> None:
    """pwrite one rebuilt row, counted into bytes_written and write_s."""
    t0 = time.perf_counter()
    _pwrite(fd, arr, off)
    counter.write_s += time.perf_counter() - t0
    counter.wrote(arr.size)


def _close_outputs(outs: "dict[int, int]", counter: RepairCounter) -> None:
    """fsync and close the rebuilt files (flush_s); every fd is closed
    even when an fsync fails."""
    t0 = time.perf_counter()
    try:
        for fd in outs.values():
            os.fsync(fd)
    finally:
        for fd in outs.values():
            os.close(fd)
        counter.flush_s += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Hitchhiker single-data-shard repair: execute the coder's ranged plan.
# ---------------------------------------------------------------------------

def rebuild_piggyback_single(base: str, pb: PiggybackCoder, f: int,
                             readers: dict, shard_size: int,
                             counter: RepairCounter,
                             window: int = REPAIR_WINDOW) -> None:
    """Rebuild data shard f from byte ranges of survivors (the plan
    ops/piggyback.repair_plan describes): (d-1) b-halves + parity 0's
    b-half decode b_f; the piggybacked parity's b-half plus the group's
    a-halves release a_f. Reads (d + |S_g|) / 2 shard-equivalents."""
    d = pb.d
    g, grp = pb.group_of(f)
    half = shard_size // 2
    present_b = tuple(sorted([i for i in range(d) if i != f] + [d]))
    outs = _open_outputs(base, [f], shard_size)
    try:
        for w in range(0, half, window):
            wl = min(window, half - w)
            b_rows = np.stack([readers[s](half + w, wl) for s in present_b])
            b_f = host_result(pb.inner.reconstruct(b_rows, present_b, (f,)))[0]
            # full b substripe of the data shards, in id order
            all_b = np.empty((d, wl), dtype=np.uint8)
            for idx, s in enumerate(present_b[:-1]):
                all_b[s] = b_rows[idx]
            all_b[f] = b_f
            p_g = host_result(pb.inner.reconstruct(
                all_b, tuple(range(d)), (d + g,)))[0]
            a_f = readers[d + g](half + w, wl) ^ p_g
            for i in grp:
                if i != f:
                    a_f = a_f ^ readers[i](w, wl)
            _write_out(counter, outs[f], a_f, w)
            _write_out(counter, outs[f], b_f, half + w)
    finally:
        _close_outputs(outs, counter)


# ---------------------------------------------------------------------------
# General piggyback rebuild (multi-loss, parity loss): two streamed passes.
# ---------------------------------------------------------------------------

def rebuild_piggyback_general(base: str, pb: PiggybackCoder,
                              present, missing, readers: dict,
                              shard_size: int, counter: RepairCounter,
                              window: int = REPAIR_WINDOW) -> None:
    """Pass A rebuilds the a-halves (substripe a is plain RS over ALL
    shards, piggybacked parities included); pass B purifies surviving
    piggybacked parities with the now-complete a substripe, decodes the
    b-halves, and re-applies the piggyback to rebuilt parities."""
    d = pb.d
    half = shard_size // 2
    used = tuple(sorted(present))[:d]
    missing = tuple(sorted(missing))
    outs = _open_outputs(base, missing, shard_size)

    def out_read(m: int, off: int, ln: int) -> np.ndarray:
        buf = os.pread(outs[m], ln, off)
        return np.frombuffer(buf, dtype=np.uint8)

    try:
        for w in range(0, half, window):  # pass A: a substripe
            wl = min(window, half - w)
            a_rows = np.stack([readers[s](w, wl) for s in used])
            rec = host_result(pb.inner.reconstruct(a_rows, used, missing))
            for wi, m in enumerate(missing):
                _write_out(counter, outs[m], rec[wi], w)
        # which piggyback groups pass B must materialize: one per
        # surviving piggybacked parity (to purify) or rebuilt one
        need_g = sorted({s - d for s in used if s > d}
                        | {m - d for m in missing if m > d})
        # a group member may be missing WITHOUT being rebuilt here (the
        # caller wanted only a parity): its a-half exists nowhere on
        # disk, so decode it per-window from the survivors' a substripe
        aux = tuple(sorted({i for g in need_g for i in pb.groups[g - 1]
                            if i not in readers and i not in outs}))
        for w in range(0, half, window):  # pass B: b substripe
            wl = min(window, half - w)
            b_rows = np.stack([readers[s](half + w, wl) for s in used])
            aux_a = {}
            if aux:
                a_rows = np.stack([readers[s](w, wl) for s in used])
                rec_a = host_result(pb.inner.reconstruct(a_rows, used, aux))
                aux_a = {i: rec_a[ai] for ai, i in enumerate(aux)}
            xg = {}
            for g in need_g:
                x = np.zeros(wl, dtype=np.uint8)
                for i in pb.groups[g - 1]:
                    if i in aux_a:
                        x = x ^ aux_a[i]
                    elif i in readers:
                        x = x ^ readers[i](w, wl)
                    else:
                        x = x ^ out_read(i, w, wl)
                xg[g] = x
            for idx, s in enumerate(used):
                if s > d:
                    b_rows[idx] ^= xg[s - d]
            rec = host_result(pb.inner.reconstruct(b_rows, used, missing))
            for wi, m in enumerate(missing):
                row = rec[wi]
                if m > d:
                    row = row ^ xg[m - d]
                _write_out(counter, outs[m], row, half + w)
    finally:
        _close_outputs(outs, counter)


# ---------------------------------------------------------------------------
# Encode-side overlay: plain-RS shard files -> piggybacked parity files.
# ---------------------------------------------------------------------------

def apply_piggyback_overlay(out_base: str, pb: PiggybackCoder,
                            shard_size: int,
                            window: int = REPAIR_WINDOW) -> None:
    """Fold the piggyback XORs into freshly written plain-RS parity files
    (ec/stream.py encodes slabs with the inner coder, then seals through
    this overlay): for each piggybacked parity g, parity_file[half:] ^=
    XOR of the group's data files[:half]."""
    if shard_size == 0:
        return
    if shard_size % 2:
        raise ValueError(f"piggyback needs an even shard size, got "
                         f"{shard_size} (block sizes must be even)")
    half = shard_size // 2
    d = pb.d
    for g, grp in enumerate(pb.groups, start=1):
        if not grp:
            continue
        data_fds = [os.open(out_base + files.shard_ext(i), os.O_RDONLY)
                    for i in grp]
        pfd = os.open(out_base + files.shard_ext(d + g), os.O_RDWR)
        try:
            for w in range(0, half, window):
                wl = min(window, half - w)
                x = np.frombuffer(os.pread(pfd, wl, half + w),
                                  dtype=np.uint8).copy()
                for fd in data_fds:
                    x ^= np.frombuffer(os.pread(fd, wl, w), dtype=np.uint8)
                _pwrite(pfd, x, half + w)
            os.fsync(pfd)
        finally:
            os.close(pfd)
            for fd in data_fds:
                os.close(fd)


# ---------------------------------------------------------------------------
# MSR (product-matrix) repair: beta-sized computed fragments from every
# survivor for single loss; streamed coupled decode for multi-loss.
# ---------------------------------------------------------------------------

def _msr_window(pm, shard_size: int, window: int) -> int:
    """Inner-offset window width: the decode working set is
    nbar * alpha * width, so dividing `window` by alpha caps it near
    nbar * window (~64 MB at the default 4 MB window) while each helper's
    in-flight fragment stays <= window / q."""
    s = shard_size // pm.alpha
    return max(1, min(s, window // pm.alpha))


def rebuild_msr_single(base: str, pm, f: int, readers: dict,
                       frag_readers: dict, shard_size: int,
                       counter: RepairCounter,
                       window: int = REPAIR_WINDOW, folds=()) -> None:
    """Rebuild any single lost shard — data OR parity — from computed
    fragments of ALL n-1 survivors: each ships only its repair-plane
    sub-symbols ((n-1)/p shard-equivalents total, the MSR cut-set bound),
    one fragment read per survivor per window.

    `folds` is a list of (sids, fetch) relay groups: a relay holder
    gathers those survivors' plane rows and folds them through the stacked
    per-helper repair matrix (geo/repair_fold.py); `fetch(ranges)` returns
    the group's ONE folded partial of alpha rows per window. Folded
    survivors skip the per-survivor fetch; their contribution XORs into
    the near-side decode, byte-identical to the flat path because
    `repair_decode` is GF-linear in the helpers' plane symbols."""
    g = pm.grid
    planes = g.repair_planes(f)
    s = shard_size // pm.alpha
    wl = _msr_window(pm, shard_size, window)
    folded_sids = {sid for sids, _fetch in folds for sid in sids}
    outs = _open_outputs(base, [f], shard_size)
    try:
        for u in range(0, s, wl):
            w = min(wl, s - u)
            ranges = [(int(z) * s + u, w) for z in planes]
            c = np.zeros((g.nbar, g.alpha, w), dtype=np.uint8)
            for sid in range(pm.n):
                if sid == f or sid in folded_sids:
                    continue
                frag = frag_readers[sid](ranges)
                c[sid, planes] = frag.reshape(len(planes), w)
            row = pm.repair_decode(c, f)
            for _sids, fetch in folds:
                part = fetch(ranges)
                counter.read(part.size, remote=True)
                row = row ^ part.reshape(pm.alpha, w)
            for z in range(pm.alpha):
                _write_out(counter, outs[f], row[z], z * s + u)
    finally:
        _close_outputs(outs, counter)


def rebuild_msr_general(base: str, pm, present, missing, readers: dict,
                        frag_readers: dict, shard_size: int,
                        counter: RepairCounter,
                        window: int = REPAIR_WINDOW) -> None:
    """Multi-loss (or missing-helper) rebuild: stream the coupled layered
    decode over d full survivors, reading EACH SURVIVOR EXACTLY ONCE
    across all losses — never once per lost shard."""
    g = pm.grid
    s = shard_size // pm.alpha
    missing = tuple(sorted(missing))
    # prefer local survivors: make_readers inserts local fds before
    # remote fetchers, so frag_readers' iteration order is the byte-
    # cheapest d-subset
    avail = set(present)
    order = [sid for sid in frag_readers if sid in avail]
    used = tuple(sorted(order[: pm.d]))
    if len(used) < pm.d:
        raise RuntimeError(f"msr rebuild needs {pm.d} survivors, "
                           f"have {len(used)}")
    all_layers = np.arange(pm.alpha)
    wl = _msr_window(pm, shard_size, window)
    outs = _open_outputs(base, missing, shard_size)
    try:
        for u in range(0, s, wl):
            w = min(wl, s - u)
            c = np.zeros((g.nbar, g.alpha, w), dtype=np.uint8)
            for sid in used:
                ranges = [(int(z) * s + u, w) for z in all_layers]
                c[sid] = frag_readers[sid](ranges).reshape(pm.alpha, w)
            pm.decode_coupled(c, used)
            for m in missing:
                for z in range(pm.alpha):
                    _write_out(counter, outs[m], c[m, z], z * s + u)
    finally:
        _close_outputs(outs, counter)


def apply_msr_overlay(out_base: str, pm, shard_size: int,
                      window: int = REPAIR_WINDOW) -> None:
    """Encode-side seal: rewrite the parity files with the MSR coupled
    parities computed from the data shard files (ec/stream.py's device
    pipeline encodes plain-RS slabs, codec-agnostic, and this overlay
    replaces the parity bytes before the .vif seals the codec)."""
    if shard_size == 0:
        return
    if shard_size % pm.alpha:
        raise ValueError(
            f"msr needs shard files divisible by alpha={pm.alpha}, got "
            f"{shard_size}: use a power-of-two p or a small_block "
            "divisible by alpha")
    s = shard_size // pm.alpha
    wl = _msr_window(pm, shard_size, window)
    data_fds: list[int] = []
    par_fds: list[int] = []
    try:
        for i in range(pm.d):
            data_fds.append(os.open(out_base + files.shard_ext(i), os.O_RDONLY))
        for j in range(pm.p):
            par_fds.append(os.open(out_base + files.shard_ext(pm.d + j),
                                   os.O_RDWR))
        for u in range(0, s, wl):
            w = min(wl, s - u)
            sub = np.empty((pm.d, pm.alpha, w), dtype=np.uint8)
            for i, fd in enumerate(data_fds):
                for z in range(pm.alpha):
                    buf = os.pread(fd, w, z * s + u)
                    if len(buf) != w:
                        raise OSError(f"short read sealing {out_base}")
                    sub[i, z] = np.frombuffer(buf, dtype=np.uint8)
            par = pm.encode_subsymbols(sub)
            for j, fd in enumerate(par_fds):
                for z in range(pm.alpha):
                    _pwrite(fd, par[j, z], z * s + u)
        for fd in par_fds:
            os.fsync(fd)
    finally:
        for fd in data_fds + par_fds:
            os.close(fd)


def apply_codec_overlay(out_base: str, coder, shard_size: int,
                        window: int = REPAIR_WINDOW) -> None:
    """Seal-time overlay dispatch for codecs whose parity differs from the
    plain-RS slabs the streaming pipeline writes."""
    fn = OVERLAYS.get(coder.codec)
    if fn is None:
        raise ValueError(f"codec {coder.codec!r} has no overlay seal")
    fn(out_base, coder, shard_size, window)


# ---------------------------------------------------------------------------
# Degraded reads: reconstruct one interval of a lost data shard when the
# gathered survivors include piggybacked parities.
# ---------------------------------------------------------------------------

def reconstruct_interval(pb: PiggybackCoder, gathered: "dict[int, bytes]",
                         f: int, offset: int, length: int, shard_size: int,
                         fetch_pair, fetch_map=None) -> bytes:
    """gathered: >= d survivors' bytes for [offset, offset+length) of their
    shard files. Survivors from {0..d} (data + the unpiggybacked parity)
    are positionally plain RS everywhere, and *every* shard is positionally
    plain in the a-half — only b-half spans decoded through a piggybacked
    parity need its piggyback stripped, which takes the paired a-range:
    `fetch_pair(sid, off, ln) -> bytes` supplies it. `fetch_map(fetch_pair,
    [(sid, off, ln), ...]) -> [bytes, ...]` lets the caller fan the d
    paired fetches out concurrently; default is sequential."""
    half = shard_size // 2
    used = tuple(sorted(gathered))[: pb.d]
    rows = np.stack([np.frombuffer(gathered[s], dtype=np.uint8)
                     for s in used])
    out = np.empty(length, dtype=np.uint8)
    a_len = max(0, min(length, half - offset))
    if a_len:  # a-half span: all shards positionally plain
        rec = host_result(pb.inner.reconstruct(rows[:, :a_len], used, (f,)))
        out[:a_len] = rec[0]
    if a_len < length:  # b-half span
        b_rows = rows[:, a_len:].copy()
        pair_off = offset + a_len - half
        pair_len = length - a_len
        piggy_gs = sorted({s - pb.d for s in used if s > pb.d})
        if piggy_gs:
            reqs = [(s, pair_off, pair_len) for s in used]
            if fetch_map is None:
                rows_b = [fetch_pair(*r) for r in reqs]
            else:
                rows_b = fetch_map(fetch_pair, reqs)
            pair = np.stack([np.frombuffer(r, dtype=np.uint8)
                             for r in rows_b])
            a_data = host_result(pb.inner.reconstruct(
                pair, used, tuple(range(pb.d))))
            for idx, s in enumerate(used):
                if s > pb.d:
                    b_rows[idx] ^= pb._xor_group(a_data, pb.groups[s - pb.d - 1])
        rec = host_result(pb.inner.reconstruct(b_rows, used, (f,)))
        out[a_len:] = rec[0]
    return out.tobytes()


# ---------------------------------------------------------------------------
# Codec dispatch: how encoder.rebuild_shards executes each codec's cheapest
# path. Uniform signatures:
#   ranged(base, coder, f, readers, frag_readers, shard_size, counter)
#   general(base, coder, present, missing, readers, frag_readers,
#           shard_size, counter)
# A codec registered here never falls through to the positional plain-RS
# rebuild (which would decode its parities as if they were RS).
# ---------------------------------------------------------------------------

def _pb_single(base, coder, f, readers, frag_readers, shard_size, counter):
    rebuild_piggyback_single(base, coder, f, readers, shard_size, counter)


def _pb_general(base, coder, present, missing, readers, frag_readers,
                shard_size, counter):
    rebuild_piggyback_general(base, coder, present, missing, readers,
                              shard_size, counter)


REBUILDERS = {
    "piggyback": (_pb_single, _pb_general),
    "msr": (rebuild_msr_single, rebuild_msr_general),
}

OVERLAYS = {
    "piggyback": apply_piggyback_overlay,
    "msr": apply_msr_overlay,
}
