"""Repair-traffic plumbing: byte-counted survivor readers over local shard
files and remote fetches, and the rebuilt-file outputs.

Port of the plain-RS part of seaweedfs_tpu/ec/repair.py (:43-173). The
codec rebuilders of the JAX package (piggyback and msr, their overlays and
`reconstruct_interval`) are not ported yet, so `REBUILDERS` is empty and
every rebuild takes ec/encoder.py's positional plain-RS path. Ranged-compute
survivor reads (`fragment_reader`) serve only those codecs: a caller that
passes one is refused, never ignored.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np

from ..utils.log import logger
from . import files

log = logger("ec.repair")

# streaming window for the windowed repair paths: big enough to amortize
# per-call fetch overhead, small enough to keep d in-flight rows bounded
REPAIR_WINDOW = 4 << 20

# shard_reader(shard_id, offset, length) -> bytes (ec/volume.py contract)
ShardReader = Callable[[int, int, int], bytes]


class RepairCounter:
    """Survivor bytes read and rebuilt bytes written by one repair, and
    where its wall time went: read_s (loading survivor slabs), write_s
    (copying rebuilt rows out), flush_s (flushing the rebuilt files), and
    inside read_s the time spent in remote and local survivor reads with
    the bytes each served."""

    def __init__(self, codec: str):
        self.codec = codec or "rs"
        self.bytes_read = 0
        self.bytes_written = 0
        self.read_s = self.write_s = self.flush_s = 0.0
        self.remote_bytes_read = 0
        self.remote_read_s = self.local_read_s = 0.0

    def read(self, n: int, seconds: float = 0.0, remote: bool = False) -> None:
        self.bytes_read += n
        if remote:
            self.remote_bytes_read += n
            self.remote_read_s += seconds
        else:
            self.local_read_s += seconds

    def wrote(self, n: int) -> None:
        self.bytes_written += n


def make_readers(base: str, present_local: "dict[int, str]",
                 shard_reader: "ShardReader | None",
                 remote_sids, counter: RepairCounter,
                 fragment_reader=None,
                 ) -> "tuple[dict[int, Callable[[int, int], np.ndarray]], dict, Callable[[], None]]":
    """(readers, frag_readers, close): one `read(offset, length)` per
    survivor over local files and `shard_reader` fetches, every byte
    counted; a short read raises OSError. `frag_readers` stays empty:
    ranged-compute reads serve only the codecs not ported yet."""
    if fragment_reader is not None:
        raise NotImplementedError(
            "fragment_reader serves the piggyback and msr rebuilders, which "
            "are not yet ported to seaweedfs_tpu_torch")
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

    def remote(sid: int):
        def read(off: int, ln: int) -> np.ndarray:
            t0 = time.perf_counter()
            buf = shard_reader(sid, off, ln)
            if len(buf) != ln:
                raise OSError(f"short remote read of shard {sid} at {off}")
            counter.read(ln, time.perf_counter() - t0, remote=True)
            return np.frombuffer(buf, dtype=np.uint8)
        return read

    readers: dict[int, Callable] = {}
    try:
        for sid, path in present_local.items():
            fds[sid] = os.open(path, os.O_RDONLY)
            readers[sid] = local(sid)
    except BaseException:
        for fd in fds.values():
            os.close(fd)
        raise
    for sid in remote_sids or ():
        if sid not in readers and shard_reader is not None:
            readers[sid] = remote(sid)

    def close() -> None:
        for fd in fds.values():
            try:
                os.close(fd)
            except OSError:
                log.debug("closing survivor fd under %s failed", base,
                          exc_info=True)
    return readers, {}, close


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


# codec -> (ranged single-loss rebuilder, general rebuilder). Empty until
# the layered codecs are ported: ec/encoder._dispatch_rebuild then takes the
# positional plain-RS path, after require_plain_rs has refused any other
# codec.
REBUILDERS: dict = {}
