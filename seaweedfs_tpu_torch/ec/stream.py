"""Streaming multi-volume EC encode: disk -> host views -> device -> shards.

Port of seaweedfs_tpu/ec/stream.py. Reference hot loop:
weed/storage/erasure_coding/ec_encoder.go:198-233 (`encodeDatFile`) reads
14 x 256 KB striped buffers per row and calls the CPU encoder once per slab,
one volume at a time. This module replaces that with a pipeline whose three
stages — fill, compute, write — overlap:

* **Vectorized stripe views.** A .dat's large region is *already* a
  [rows, d, large_block] tensor laid out contiguously on disk; numpy reshapes
  of the memmap expose every slab as a strided view. Each input byte is read
  from disk ONCE: the fill pass builds the [B, d, C] parity batch with one
  strided copy per run and the data-shard bytes are written straight out of
  the source mapping (sync coders) or that same host batch (device coders).
* **Fixed-shape device batches.** Parity is computed over [B, d, C] uint8
  slabs (C = 1 MB, B = 32 by default -> 320 MB of data per device call at
  d=10).
* **Writeback plane.** Completed data/parity runs are handed to a
  `WriterPool` — one io thread per target shard-file group, bounded work
  queues, `os.pwrite` of batch-contiguous runs — so shard writeback overlaps
  fill and compute. A writer failure (ENOSPC, bad disk) poisons the pool:
  the job fails cleanly, threads join, partial shard files are removed.
* **Writer-gated double buffering.** A device coder's encode is an async
  dispatch (ops/coder.TorchCoder: pinned H2D copy, kernel, D2H copy into a
  pinned host buffer, CUDA event, all queued on the current stream); the
  pipeline keeps `depth` batches in flight and only blocks when fetching
  parity bytes for batch N while N+1..N+depth transfer and compute. Host
  staging buffers (pinned, from the coder) rotate through a pool sized
  depth+2, and recycling a buffer additionally waits until the writer pool
  has drained every data run still reading it.
* **Cross-volume batching.** `encode_volumes` feeds slabs from many volumes
  through one shared batch stream; a batch may span the tail of volume k and
  the head of volume k+1, so the device never sees a partial batch until the
  very end of the whole job. Volumes are opened lazily as they enter the
  fill window; a volume's source mapping is closed as soon as its last run
  has been computed AND written.

Shard-file writes are batch-contiguous: a run's k slabs land at consecutive
offsets of each shard file, so a run is ONE queue item per shard that the
writer flushes with k contiguous `os.pwrite`s (or a single one when the
source bytes are themselves contiguous).

Stage timings are returned in a plain dict (`stats`), observed into
SeaweedFS_ec_pipeline_seconds{stage} and set on the call's ec.encode span;
SeaweedFS_ec_encode_bytes_total{coder} counts the bytes fed to the coder
and SeaweedFS_ec_writer_queue_depth the runs queued to the writers. The
layered codecs (piggyback, msr) stream their slabs as plain RS through
their inner coder and seal their parities with an overlay before the .vif
(ec/repair.py).
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .. import tracing
from ..ops.coder import ErasureCoder, host_result
from ..stats import (EC_ENCODE_BYTES, EC_PIPELINE_SECONDS,
                     EC_WRITER_QUEUE_DEPTH)
from ..utils.env import env_int
from ..utils.fsutil import fsync_path
from ..utils.log import logger
from . import files
from .locate import EcGeometry
from .repair import OVERLAYS, apply_codec_overlay

log = logger("ec.stream")

DEFAULT_CHUNK = 1 << 20   # device slab length (= reference small block)
DEFAULT_BATCH = 32        # slabs per device call
DEFAULT_DEPTH = 2         # batches in flight beyond the one being drained


def _default_writers() -> int:
    return env_int("SWTPU_EC_WRITERS", max(2, min(8, os.cpu_count() or 1)))


def _default_writer_queue() -> int:
    # per-writer item bound; items reference (not copy) up to batch*chunk
    # bytes each, so this also bounds parity arrays kept alive
    return env_int("SWTPU_EC_WRITER_QUEUE", 8)


def fit_chunk(geo: EcGeometry, chunk: int) -> int:
    """Largest slab length <= chunk that divides both block sizes.

    Any valid slab length divides g = gcd(large_block, small_block), so the
    answer is the largest divisor of g that is <= chunk — found by an
    O(sqrt(g)) divisor walk.
    """
    g = math.gcd(geo.large_block, geo.small_block)
    if chunk >= g:
        return g
    chunk = max(1, chunk)
    best = 1
    i = 1
    while i * i <= g:
        if g % i == 0:
            if best < i <= chunk:
                best = i
            j = g // i
            if best < j <= chunk:
                best = j
        i += 1
    return best


def _populated_view(path: str) -> "tuple[np.ndarray, object]":
    """Read-only uint8 view of a file, page tables pre-populated.

    MAP_POPULATE establishes all PTEs in one syscall, so the pipeline's
    strided reads do not pay a minor fault per page.

    Returns (array, mmap); the caller owns the mapping and must close it
    once every derived view is dropped (see _VolumePlan._release_source).
    """
    import mmap as _mmap
    size = os.path.getsize(path)
    if size == 0:
        return np.empty(0, dtype=np.uint8), None
    f = open(path, "rb")
    try:
        flags = _mmap.MAP_SHARED | getattr(_mmap, "MAP_POPULATE", 0)
        m = _mmap.mmap(f.fileno(), size, flags=flags, prot=_mmap.PROT_READ)
    finally:
        f.close()
    return np.frombuffer(m, dtype=np.uint8), m


def _pwrite_full(fd: int, mv, off: int) -> None:
    n = os.pwrite(fd, mv, off)
    while n < len(mv):  # partial writes are legal, if rare, on regular files
        mv = memoryview(mv)[n:]
        off += n
        n = os.pwrite(fd, mv, off)


def _write_run(fd: int, off: int, arr: np.ndarray) -> None:
    """Write one batch-contiguous run: arr is 1-D (contiguous source) or
    [k, chunk] whose k rows land at consecutive chunk offsets of fd."""
    if arr.ndim == 1:
        _pwrite_full(fd, arr.data, off)
        return
    if arr.flags.c_contiguous:
        _pwrite_full(fd, arr.reshape(-1).data, off)
        return
    step = arr.shape[-1]
    for r in range(arr.shape[0]):
        _pwrite_full(fd, arr[r].data, off + r * step)


class WriterPool:
    """The writeback plane: one io thread per target shard-file group.

    Work is routed group = shard_id % writers, so every write to a given
    shard file is issued by the same thread. Queues are bounded: `submit`
    blocks when the pipeline outruns the disks, which is the backpressure
    that keeps memory flat.

    A writer that fails (ENOSPC, EIO) records the first exception and keeps
    draining its queue without writing — completion callbacks still run so
    buffer gating can never hang — and the error surfaces on the next
    `submit()`/`drain()` on the submitting thread.
    """

    def __init__(self, writers: "int | None" = None,
                 queue_depth: "int | None" = None):
        self.writers = max(1, int(writers if writers is not None
                                  else _default_writers()))
        depth = max(1, int(queue_depth if queue_depth is not None
                           else _default_writer_queue()))
        self._queues = [queue.Queue(maxsize=depth)
                        for _ in range(self.writers)]
        self._busy = [0.0] * self.writers
        self.block_s = 0.0          # submitting-thread seconds lost to backpressure
        self._err: "BaseException | None" = None
        self._err_lock = threading.Lock()
        self._closed = False
        self._threads = [
            threading.Thread(target=self._run, args=(i,), daemon=True,
                             name=f"swtpu-torch-ec-writer-{i}")
            for i in range(self.writers)]
        for t in self._threads:
            t.start()

    # -- writer side --------------------------------------------------------
    def _run(self, i: int) -> None:
        q = self._queues[i]
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            fd, off, arr, on_done = item
            item = None
            if self._err is None:
                t0 = time.perf_counter()
                try:
                    _write_run(fd, off, arr)
                    self._busy[i] += time.perf_counter() - t0
                except BaseException as e:  # noqa: BLE001 — surfaced via submit/drain
                    with self._err_lock:
                        if self._err is None:
                            self._err = e
            # drop the data reference BEFORE signalling completion: on_done
            # may recycle the buffer / close the source mmap this run reads
            arr = None
            if on_done is not None:
                try:
                    on_done()
                except Exception:  # noqa: BLE001 — a callback must not kill the writer
                    log.warning("ec writer completion callback failed",
                                exc_info=True)
            EC_WRITER_QUEUE_DEPTH.add(amount=-1)
            q.task_done()

    # -- submitting side ----------------------------------------------------
    def submit(self, shard_id: int, fd: int, off: int, arr: np.ndarray,
               on_done=None) -> None:
        """Queue one batch-contiguous run for shard_id's writer thread."""
        if self._err is not None:
            raise self._err
        q = self._queues[shard_id % self.writers]
        item = (fd, off, arr, on_done)
        t0 = time.perf_counter()
        # delta, not an absolute set: concurrent encodes each run their own
        # pool but share the gauge. Counted BEFORE the put so the writer's
        # post-dequeue decrement can never take the gauge below zero.
        EC_WRITER_QUEUE_DEPTH.add(amount=1)
        while True:
            try:
                q.put(item, timeout=0.2)
                break
            except queue.Full:
                if self._err is not None:
                    EC_WRITER_QUEUE_DEPTH.add(amount=-1)  # never enqueued
                    raise self._err from None
        self.block_s += time.perf_counter() - t0

    def drain(self) -> None:
        """Barrier: wait for every queued run, then re-raise any failure."""
        t0 = time.perf_counter()
        for q in self._queues:
            q.join()
        self.block_s += time.perf_counter() - t0
        if self._err is not None:
            raise self._err

    def poison(self, exc: "BaseException | None" = None) -> None:
        """Abort: queued-but-unwritten runs are skipped (callbacks still run)."""
        with self._err_lock:
            if self._err is None:
                self._err = exc or RuntimeError("ec writer pool aborted")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join()

    # -- introspection ------------------------------------------------------
    @property
    def busy_s(self) -> float:
        """Aggregate seconds writer threads spent inside pwrite."""
        return sum(self._busy)

    @property
    def error(self) -> "BaseException | None":
        return self._err


class AsyncPipe:
    """Depth-bounded async dispatch with a writer-gated host-buffer pool.

    Shared by encode_volumes and encoder.rebuild_shards. `depth` batches may
    be in flight beyond the one being drained; the pool holds depth+2
    buffers from `alloc(shape)` (the coder's `host_buffer`: pinned memory
    for the GPU coder). With a pinned buffer the H2D copy is asynchronous:
    the copy engine still READS the buffer after the coder's call returns.
    A batch's input is provably consumed once its output has been fetched
    (the output's event follows the H2D copy on the same stream), and batch
    N's buffer is only reused at N + depth + 2 > N + depth, by which point N
    has been drained.

    With a writer pool in the picture drain order alone is not enough: data
    runs submitted to writers keep READING the fill buffer after its batch
    drained. Callers `retain(buf)` per outstanding run and the writer's
    completion callback `release(buf)`s it; `next_buffer` blocks until the
    slot's hold count is zero. `recycle_wait_s` accumulates that blocking —
    it shows up as writer backpressure in the pipeline stats.
    """

    def __init__(self, shape: tuple, depth: int = DEFAULT_DEPTH, alloc=None):
        self.depth = depth
        alloc = alloc or (lambda s: np.zeros(s, dtype=np.uint8))
        self.pool = [alloc(shape) for _ in range(depth + 2)]
        self.pending: deque = deque()
        self._slot = 0
        self._holds = [0] * len(self.pool)
        self._ids = {id(b): i for i, b in enumerate(self.pool)}
        self._cv = threading.Condition()
        self.recycle_wait_s = 0.0

    def next_buffer(self) -> np.ndarray:
        i = self._slot
        self._slot = (self._slot + 1) % len(self.pool)
        t0 = time.perf_counter()
        with self._cv:
            while self._holds[i]:
                self._cv.wait()
        self.recycle_wait_s += time.perf_counter() - t0
        return self.pool[i]

    def retain(self, buf: np.ndarray) -> None:
        with self._cv:
            self._holds[self._ids[id(buf)]] += 1

    def release(self, buf: np.ndarray) -> None:
        with self._cv:
            self._holds[self._ids[id(buf)]] -= 1
            self._cv.notify_all()

    def submit(self, fut, ctx, drain_fn) -> None:
        """Queue (future, ctx); drain the oldest once over depth."""
        self.pending.append((fut, ctx, drain_fn))
        if len(self.pending) > self.depth:
            self.drain_one()

    def drain_one(self) -> None:
        fut, ctx, drain_fn = self.pending.popleft()
        drain_fn(host_result(fut), ctx)  # blocks on the device's event

    def flush(self) -> None:
        while self.pending:
            self.drain_one()


@dataclass
class _Run:
    """k consecutive slabs of one volume occupying batch rows [b0, b0+k)."""
    plan: "_VolumePlan"
    shard_off: int              # where slab 0's parity lands in each shard file
    b0: int
    k: int


@dataclass
class _VolumePlan:
    """Slab enumeration state for one volume's .dat."""
    dat_path: str
    out_base: str
    idx_path: str | None
    geo: EcGeometry
    chunk: int
    dat_size: int = 0
    shard_size: int = 0
    fds: list[int] = field(default_factory=list)
    inflight_runs: int = 0
    finished: bool = False
    # seconds spent creating outputs + mapping the source, and sealing
    # (overlay_s: the codec overlay, inside seal_s)
    open_s: float = 0.0
    seal_s: float = 0.0
    overlay_s: float = 0.0
    # overlay codec (ops/piggyback.py, ops/product_matrix.py) to seal with:
    # slabs are encoded as plain RS by the inner coder and finish() applies
    # the codec's overlay — piggyback XOR-folds, msr rewrites the parities
    # — before the .vif seal
    overlay: "ErasureCoder | None" = None
    # (view4d [rows, d, nch, C], shard_base, rows, nch) per region
    regions: list[tuple[np.ndarray, int, int, int]] = field(default_factory=list)
    # iteration cursor: (region_idx, row, chunk)
    _pos: tuple[int, int, int] = (0, 0, 0)
    # source mapping ownership + outstanding writer-pool runs
    _arr: "np.ndarray | None" = None
    _mm: object = None
    _pending_writes: int = 0
    _cv: threading.Condition = field(default_factory=threading.Condition)

    def open(self) -> None:
        t0 = time.perf_counter()
        try:
            self._open()
        finally:
            self.open_s += time.perf_counter() - t0

    def _open(self) -> None:
        geo, chunk = self.geo, self.chunk
        self.dat_size = os.path.getsize(self.dat_path)
        self.shard_size = geo.shard_file_size(self.dat_size)
        paths = [self.out_base + files.shard_ext(i) for i in range(geo.n)]
        for p in paths:
            with open(p, "wb") as f:
                if self.shard_size:
                    f.truncate(self.shard_size)
        if self.dat_size == 0:
            return
        # append as we go: a mid-list EMFILE must leave the already-
        # opened fds visible to _close_fds/abort, not leak them
        for p in paths:
            self.fds.append(os.open(p, os.O_WRONLY))
        mm, raw = _populated_view(self.dat_path)
        self._arr, self._mm = mm, raw

        nl = geo.large_rows(self.dat_size)
        lb, sb, d = geo.large_block, geo.small_block, geo.d
        large_bytes = nl * d * lb
        regions = []
        if nl:
            nch = lb // chunk
            v = np.asarray(mm[:large_bytes]).reshape(nl, d, nch, chunk)
            regions.append((v, 0, nl, nch))
        rest = self.dat_size - large_bytes
        ns = geo.small_rows(self.dat_size)
        if ns:
            nchs = sb // chunk
            full = rest // (d * sb)
            if full:
                v = np.asarray(
                    mm[large_bytes:large_bytes + full * d * sb]
                ).reshape(full, d, nchs, chunk)
                regions.append((v, nl * lb, full, nchs))
            tail = rest - full * d * sb
            if tail:
                pad = np.zeros((1, d, nchs, chunk), dtype=np.uint8)
                flat = pad.reshape(-1)
                flat[:tail] = mm[large_bytes + full * d * sb:]
                regions.append((pad, nl * lb + full * sb, 1, nchs))
        self.regions = regions

    def fill(self, buf: np.ndarray, b0: int) -> tuple[int, int | None]:
        """Fill buf[b0:] with the next slabs; return (rows_filled, shard_off).

        shard_off is where the first filled slab lands in each shard file
        (None if this volume is exhausted). Slabs within one call are
        guaranteed contiguous in the shard files.
        """
        ri, row, ch = self._pos
        if ri >= len(self.regions):
            return 0, None
        view, base, rows, nch = self.regions[ri]
        space = buf.shape[0] - b0
        # contiguous slabs remaining in the current row
        k = min(space, nch - ch)
        buf[b0:b0 + k] = view[row, :, ch:ch + k].transpose(1, 0, 2)
        shard_off = base + (row * nch + ch) * self.chunk
        ch += k
        if ch == nch:
            row, ch = row + 1, 0
            if row == rows:
                ri, row = ri + 1, 0
        self._pos = (ri, row, ch)
        return k, shard_off

    def exhausted(self) -> bool:
        return self._pos[0] >= len(self.regions)

    # -- writer-pool accounting ---------------------------------------------
    def note_write(self) -> None:
        with self._cv:
            self._pending_writes += 1

    def write_done(self) -> None:
        with self._cv:
            self._pending_writes -= 1
            self._cv.notify_all()

    def writes_done(self) -> bool:
        with self._cv:
            return self._pending_writes == 0

    # -- teardown ------------------------------------------------------------
    def _release_source(self) -> None:
        """Drop every view of the source mapping and close it NOW, so the
        address space is returned immediately instead of at some future GC.
        A stray export (caller still holding a view) makes close raise
        BufferError — fall back to GC-close for that mapping."""
        self.regions = []
        self._arr = None
        mm, self._mm = self._mm, None
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                log.debug("ec source mmap for %s still exported; "
                          "deferring close to GC", self.dat_path)

    def _close_fds(self) -> None:
        fds, self.fds = self.fds, []
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                log.debug("closing shard fd for %s failed", self.out_base,
                          exc_info=True)

    def finish(self) -> None:
        """All runs computed AND written: seal the volume's outputs.

        Shard bytes must be durable BEFORE the .vif seals the volume: a
        power loss must never leave a valid-looking .vif over shards still
        in page cache, because a converted volume's .dat may already be
        gone.
        """
        t0 = time.perf_counter()
        try:
            self._seal()
        finally:
            self.seal_s += time.perf_counter() - t0

    def _seal(self) -> None:
        for fd in self.fds:
            os.fsync(fd)
        self._close_fds()
        self._release_source()
        geo = self.geo
        codec = "rs"
        if self.overlay is not None:
            # overlay BEFORE the .vif seal: a crash mid-overlay leaves
            # unsealed outputs, never a valid-looking .vif over
            # half-sealed parities (the overlay fsyncs what it rewrites)
            t0 = time.perf_counter()
            apply_codec_overlay(self.out_base, self.overlay, self.shard_size)
            self.overlay_s += time.perf_counter() - t0
            codec = self.overlay.codec
        if self.idx_path and os.path.exists(self.idx_path):
            files.write_ecx_from_idx(self.idx_path, self.out_base + ".ecx")
            # the .ecx must be durable BEFORE the .vif seals the volume
            fsync_path(self.out_base + ".ecx")
        files.write_vif(self.out_base + ".vif", version=3,
                        dat_size=self.dat_size, d=geo.d, p=geo.p,
                        large_block=geo.large_block,
                        small_block=geo.small_block, codec=codec)
        self.finished = True

    def abort(self) -> None:
        """Failure path: close everything and remove partial outputs."""
        self._close_fds()
        self._release_source()
        for i in range(self.geo.n):
            _unlink_quiet(self.out_base + files.shard_ext(i))
        _unlink_quiet(self.out_base + ".ecx")
        _unlink_quiet(self.out_base + ".vif")


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    except OSError:
        log.warning("could not remove partial EC output %s", path,
                    exc_info=True)


def _reap(finishing: deque, pool: "WriterPool | None" = None,
          force: bool = False) -> None:
    """Finish (in submit order) every plan whose writeback has completed.

    A poisoned pool's writers SKIP queued runs but still fire their
    completion callbacks, which makes writes_done() true for a volume whose
    bytes never hit disk — sealing it would leave a valid-looking .vif over
    holed shards. The error check must come AFTER the writes_done()
    observation: _err is set before any run is skipped, so writes_done() ==
    True with _err still None proves every run was genuinely written.
    """
    while finishing and (force or finishing[0].writes_done()):
        if not force and pool is not None and pool.error is not None:
            return  # job is failing; _abort removes the partial outputs
        finishing.popleft().finish()


def encode_volumes(jobs: "list[tuple[str, str, str | None]]", geo: EcGeometry,
                   coder: ErasureCoder, chunk: int = DEFAULT_CHUNK,
                   batch: int = DEFAULT_BATCH, depth: int = DEFAULT_DEPTH,
                   stats: "dict | None" = None,
                   writers: "int | None" = None,
                   ) -> "dict[str, list[str]]":
    """Encode many volumes through one shared device stream.

    jobs: (dat_path, out_base, idx_path | None) per volume.
    Returns {dat_path: [shard paths]}. `chunk` is clamped to the largest
    value that divides both block sizes (fit_chunk). Pass a dict as `stats`
    to receive pipeline timings (wall_s, fill_s, dispatch_s, drain_block_s,
    write_s, write_block_s, ...). `writers` sizes the writeback plane
    (default SWTPU_EC_WRITERS).

    Reference equivalent: the per-volume VolumeEcShardsGenerate RPC body
    (volume_grpc_erasure_coding.go:39 -> WriteEcFiles ec_encoder.go:57), but
    batched across volumes so the device always sees full [B, d, C] slabs.

    Synchronous host coders (numpy) skip the batch assembly: each volume
    region feeds the coder zero-copy [k, d, chunk] views of the source
    mapping. Device coders (TorchCoder) go through the async path.
    Overlay codecs (piggyback, msr) encode their slabs as plain RS through
    `coder.inner`, so both paths stay codec-agnostic, and seal the real
    parities at finish() (repair.apply_codec_overlay, timed as
    `overlay_s`).

    On failure (a writer hitting ENOSPC, a coder error) the pool is
    poisoned and joined, and every not-yet-finished volume's partial
    outputs (.ec*, .ecx, .vif) are removed before the error re-raises.
    """
    assert coder.d == geo.d and coder.p == geo.p
    chunk = fit_chunk(geo, chunk)
    overlay = coder if coder.codec in OVERLAYS else None
    slab_coder = coder.inner if overlay is not None else coder
    if stats is None:
        stats = {}
    total = sum(os.path.getsize(j[0]) for j in jobs
                if os.path.exists(j[0]))
    with tracing.start_span(
            "ec.encode", component="ec",
            attrs={"volumes": len(jobs), "bytes": total,
                   "coder": type(coder).__name__, "codec": coder.codec,
                   "geometry": f"{geo.d}+{geo.p}"}) as sp:
        if not slab_coder.async_dispatch:
            res = _encode_volumes_sync(jobs, geo, slab_coder, chunk, batch,
                                       stats, writers=writers, overlay=overlay)
        else:
            res = _encode_volumes_async(jobs, geo, slab_coder, chunk, batch,
                                        depth, stats, writers=writers,
                                        overlay=overlay)
        _publish_pipeline_stats(stats, sp)
    return res


def _publish_pipeline_stats(stats: dict, span) -> None:
    """Feed the per-call stage breakdown into the stage histogram (the
    active trace exemplar-linked automatically) and onto the ec.encode
    span, so a trace shows where an encode spent its wall time."""
    wall = stats.get("wall_s", 0.0)
    stages = {
        "fill": stats.get("fill_s", 0.0),
        "dispatch": stats.get("dispatch_s", stats.get("coder_s", 0.0)),
        "drain": stats.get("drain_block_s", 0.0),
        "write": stats.get("write_s", 0.0),
    }
    for stage, secs in stages.items():
        EC_PIPELINE_SECONDS.observe(stage, value=secs)
        span.set_attr(f"{stage}_s", round(secs, 4))
    span.set_attr("wall_s", round(wall, 4))
    span.set_attr("write_block_s", round(stats.get("write_block_s", 0.0), 4))
    span.set_attr("writers", stats.get("writers", 0))
    if wall > 0:
        # fraction of writer busy time hidden behind fill/compute: 1 means
        # writes were free (fully overlapped), 0 means fully additive
        stats["write_overlap"] = round(
            1.0 - min(1.0, stats.get("write_block_s", 0.0) / wall), 4)
        span.set_attr("write_overlap", stats["write_overlap"])
    if "batches" in stats:
        span.set_attr("batches", stats["batches"])


def _encode_volumes_sync(jobs, geo: EcGeometry, coder: ErasureCoder,
                         chunk: int, batch: int, stats: dict,
                         writers: "int | None" = None,
                         overlay: "ErasureCoder | None" = None,
                         ) -> "dict[str, list[str]]":
    """Zero-copy streaming encode for synchronous host coders.

    Per region with one chunk per row, the coder input is a [k, d, chunk]
    VIEW of the populated source mapping. Data-shard runs are views of the
    source mapping and parity runs are views of the coder's fresh output —
    both queued to the writer pool; only strided multi-chunk (large-block)
    coder inputs and padded tails stage through a scratch buffer.
    """
    d, p = geo.d, geo.p
    out: dict[str, list[str]] = {}
    scratch = None
    t_wall0 = time.perf_counter()
    coder_s = fill_s = 0.0
    pool = WriterPool(writers)
    finishing: deque = deque()
    created: list[_VolumePlan] = []
    try:
        for dat_path, out_base, idx_path in jobs:
            plan = _VolumePlan(dat_path, out_base, idx_path, geo, chunk,
                               overlay=overlay)
            created.append(plan)
            out[dat_path] = [out_base + files.shard_ext(i)
                             for i in range(geo.n)]
            plan.open()
            if plan.dat_size == 0:
                plan.finish()
                continue
            for view, base, rows, nch in plan.regions:
                contiguous = nch == 1 and view.base is not None
                r0 = 0
                while r0 < rows * nch:
                    row, ch = divmod(r0, nch)
                    if contiguous:
                        k = min(batch, rows - r0)
                        inp = view[r0:r0 + k].reshape(k, d, chunk)
                    else:
                        # strided slabs (large-block region) or padded tail
                        if scratch is None:
                            scratch = np.zeros((batch, d, chunk),
                                               dtype=np.uint8)
                        k = min(batch, nch - ch)
                        t0 = time.perf_counter()
                        scratch[:k] = view[row, :, ch:ch + k].transpose(1, 0, 2)
                        fill_s += time.perf_counter() - t0
                        inp = scratch[:k]
                    t0 = time.perf_counter()
                    parity = host_result(coder.encode(inp))
                    coder_s += time.perf_counter() - t0
                    shard_off = base + r0 * chunk
                    # data runs come straight off the source mapping
                    # (scratch is recycled next batch; the view is not)
                    for i in range(d):
                        arr = (inp[:, i, :] if contiguous
                               else view[row, i, ch:ch + k].reshape(-1))
                        plan.note_write()
                        pool.submit(i, plan.fds[i], shard_off, arr,  # swtpu-lint: disable=executor-no-context (WriterPool is an io plane: its threads never read the trace context)
                                    plan.write_done)
                    for j in range(p):
                        plan.note_write()
                        pool.submit(d + j, plan.fds[d + j], shard_off,  # swtpu-lint: disable=executor-no-context (WriterPool is an io plane: its threads never read the trace context)
                                    parity[:, j, :], plan.write_done)
                    r0 += k
            EC_ENCODE_BYTES.inc(type(coder).__name__, amount=plan.dat_size)
            if not plan.finished:
                finishing.append(plan)
            _reap(finishing, pool)  # seal volumes whose writeback drained
        pool.drain()
        _reap(finishing, force=True)
    except BaseException:
        _abort(pool, created)
        raise
    finally:
        pool.close()
    stats.update(mode="sync", wall_s=time.perf_counter() - t_wall0,
                 coder_s=coder_s, fill_s=fill_s,
                 write_s=pool.busy_s, write_block_s=pool.block_s,
                 writers=pool.writers,
                 **_plan_stages(created))
    return out


def _plan_stages(plans: "list[_VolumePlan]") -> dict:
    """open_s: creating shard files and mapping sources; seal_s: fsync of
    the shards, the codec overlay (overlay_s), .ecx and .vif (all on the
    submitting thread)."""
    return dict(open_s=sum(p.open_s for p in plans),
                seal_s=sum(p.seal_s for p in plans),
                overlay_s=sum(p.overlay_s for p in plans))


def _abort(pool: WriterPool, created: "list[_VolumePlan]") -> None:
    """Shared failure path: stop the writeback plane (queued runs are
    skipped, callbacks still fire, threads join) and remove every
    unfinished volume's partial outputs. Completed volumes are kept."""
    pool.poison()
    pool.close()
    for plan in created:
        if not plan.finished:
            plan.abort()


def _encode_volumes_async(jobs, geo: EcGeometry, coder: ErasureCoder,
                          chunk: int, batch: int, depth: int, stats: dict,
                          writers: "int | None" = None,
                          overlay: "ErasureCoder | None" = None,
                          ) -> "dict[str, list[str]]":
    out: dict[str, list[str]] = {}
    todo = deque()
    for dat_path, out_base, idx_path in jobs:
        todo.append(_VolumePlan(dat_path, out_base, idx_path, geo, chunk,
                                overlay=overlay))
        out[dat_path] = [out_base + files.shard_ext(i) for i in range(geo.n)]

    d, p = geo.d, geo.p
    pool = WriterPool(writers)
    finishing: deque = deque()
    created: list[_VolumePlan] = []
    try:
        pipe = AsyncPipe((batch, d, chunk), depth, alloc=coder.host_buffer)
    except BaseException:
        pool.close()
        raise

    def drain(parity: np.ndarray, runs: "list[_Run]") -> None:
        # parity is a fresh host array; the queued run slices keep it alive
        # until the writers have flushed them
        for run in runs:
            plan = run.plan
            for j in range(p):
                plan.note_write()
                pool.submit(d + j, plan.fds[d + j], run.shard_off,
                            parity[run.b0:run.b0 + run.k, j],
                            plan.write_done)
            plan.inflight_runs -= 1
            if plan.exhausted() and plan.inflight_runs == 0:
                finishing.append(plan)

    active: deque = deque()  # opened plans still producing slabs

    def pump() -> bool:
        """Open lazily until a plan with slabs is at the front; False if done.

        Exhausted plans leave `active` here; their finish() runs once their
        last parity batch has drained AND the writer pool has flushed their
        runs (_reap on the main thread).
        """
        while not active or active[0].exhausted():
            if active and active[0].exhausted():
                active.popleft()
                continue
            if not todo:
                return False
            plan = todo.popleft()
            created.append(plan)
            plan.open()
            if plan.dat_size == 0:
                plan.finish()
                continue
            active.append(plan)
        return True

    def _data_done(plan: _VolumePlan, buf: np.ndarray):
        def done():
            pipe.release(buf)
            plan.write_done()
        return done

    t_wall0 = time.perf_counter()
    fill_s = dispatch_s = 0.0
    batches = 0
    drain_block = [0.0]
    orig_drain_one = pipe.drain_one

    def timed_drain_one():
        t0 = time.perf_counter()
        orig_drain_one()
        drain_block[0] += time.perf_counter() - t0
    pipe.drain_one = timed_drain_one

    try:
        while pump():
            buf = pipe.next_buffer()  # waits for writers still reading it
            b0, runs = 0, []
            t0 = time.perf_counter()
            while b0 < batch and pump():
                plan = active[0]
                k, shard_off = plan.fill(buf, b0)
                if k:
                    run = _Run(plan, shard_off, b0, k)
                    plan.inflight_runs += 1
                    runs.append(run)
                    # data shards go to the writer pool straight out of the
                    # host batch (one disk read per input byte); each run
                    # holds the buffer until its writer flushes it
                    done = _data_done(plan, buf)
                    for i in range(d):
                        pipe.retain(buf)
                        plan.note_write()
                        pool.submit(i, plan.fds[i], shard_off,  # swtpu-lint: disable=executor-no-context (WriterPool is an io plane: its threads never read the trace context)
                                    buf[b0:b0 + k, i], done)
                    b0 += k
            fill_s += time.perf_counter() - t0
            if b0 == 0:
                break
            if b0 < batch:
                buf[b0:] = 0  # final partial batch: one fixed batch shape
            EC_ENCODE_BYTES.inc(type(coder).__name__, amount=buf.nbytes)
            t0 = time.perf_counter()
            fut = coder.encode(buf)
            dispatch_s += time.perf_counter() - t0
            pipe.submit(fut, runs, drain)
            batches += 1
            _reap(finishing, pool)
        pipe.flush()
        pool.drain()
        _reap(finishing, force=True)
    except BaseException:
        _abort(pool, created)
        raise
    finally:
        pool.close()
    stats.update(mode="async", batches=batches,
                 batch_bytes=batch * geo.d * chunk,
                 wall_s=time.perf_counter() - t_wall0,
                 fill_s=fill_s, dispatch_s=dispatch_s,
                 drain_block_s=drain_block[0],
                 write_s=pool.busy_s,
                 write_block_s=pool.block_s + pipe.recycle_wait_s,
                 writers=pool.writers, **_plan_stages(created))
    return out
