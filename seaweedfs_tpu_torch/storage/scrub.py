"""Operational CRC scrub: stream a volume's needles through the batched CRC
of kernel K3 on the card (ops/crc_cuda.py) and report corrupt needles.

Port of the JAX package's storage/scrub.py, with the same record walk, the
same skip rules and the same torn-walk error. A tiered volume (remote .dat)
is skipped, mode "skipped-tiered", before anything is read or launched: a
scrub must not pull the whole volume back from the tier; its integrity
story is the backend's checksums. The device is chosen by the
caller and never changes on its own:

    device="cuda"  the batched path through K3 (the default; raises
                   without a card or when K3 fails to build or launch)
    device="cpu"   the batched path through K3's plain PyTorch version
    device="off"   the per-needle host loop (ops/crc32c.crc32c)

The reference's "auto" (device if JAX initialises, else the host loop) and
"on" are refused. Modes are the reference's: "device" for the batched path,
"cpu" for the host loop.

Batching: needles are LEFT-zero-padded into [B, L] blocks (L = the
batch's max data length rounded up to a power of two, at least the
512-byte chunk); the raw states are corrected for the zero prefix with
crc32c.finalize(lengths). Unlike the reference, where one long needle
pads its whole batch to its power of two (an 8 MiB needle among 4,096
makes a 32 GiB block), a batch is grouped by padded width, and each group
is cut into blocks of at most `BLOCK_BYTES` (a lone row wider than that is
its own block): each block is one K3 call. Verdicts and the order of the
corrupt list are the reference's.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import crc32c as crcmod
from ..ops import crc_cuda
from ..ops.coder import resolve_device
from ..utils.log import logger
from . import types as t
from .needle import record_size_from_header
from .volume import Volume

log = logger("scrub")

_CHUNK = crc_cuda.CHUNK
DEVICES = ("cuda", "cpu", "off")
# largest padded block one K3 call takes, unless a single row is wider
BLOCK_BYTES = 64 << 20


@dataclass
class ScrubResult:
    volume_id: int
    scanned: int = 0
    corrupt: list[int] = field(default_factory=list)  # needle ids
    bytes_checked: int = 0
    elapsed_s: float = 0.0
    mode: str = "cpu"
    error: str = ""  # volume-level trouble (torn walk, ...)

    @property
    def needles_per_s(self) -> float:
        return self.scanned / self.elapsed_s if self.elapsed_s else 0.0


class _BatchCrc:
    """CRC32C of a batch of left-padded needles through crc_cuda.crc_states
    on one device: K3 on a CUDA device, its plain version on the CPU."""

    def __init__(self, device: str):
        self.device = resolve_device(device)

    def crcs(self, blocks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(blocks).to(self.device)
        raw = crc_cuda.crc_states(x).cpu().numpy().astype(np.uint32)
        return crcmod.finalize(raw, lengths)


def _pad_pow2(n: int) -> int:
    out = _CHUNK
    while out < n:
        out *= 2
    return out


def _blocks(datas: "list[bytes]"):
    """Yield (rows, block) for a batch: rows of one padded width, each
    left-zero-padded, at most BLOCK_BYTES a block (or one wider row)."""
    by_width: dict[int, list[int]] = {}
    for i, d in enumerate(datas):
        by_width.setdefault(_pad_pow2(len(d)), []).append(i)
    for width, rows in sorted(by_width.items()):
        per = max(1, BLOCK_BYTES // width)
        for s in range(0, len(rows), per):
            part = rows[s:s + per]
            block = np.zeros((len(part), width), dtype=np.uint8)
            for j, i in enumerate(part):
                if datas[i]:
                    block[j, width - len(datas[i]):] = np.frombuffer(
                        datas[i], np.uint8)
            yield part, block


def _iter_batches(v: Volume, batch: int, res: ScrubResult):
    """Yield (ids, datas, stored_crcs) batches of LIVE needles, walking
    the .dat through volume.iter_records (the single source of truth for
    the on-disk record walk) on a private read-only handle — no lock
    contention with writers. Garbage records (overwritten/tombstoned,
    pre-vacuum) are skipped: rot in unreachable data must not alarm.
    A walk that ends before the append offset (header rot desyncing the
    record chain) is reported in res.error — the silent failure mode the
    tool exists to catch."""
    from .super_block import SUPER_BLOCK_SIZE
    from .volume import iter_records
    with v._lock:
        v._dat.flush()  # the private read handle must see buffered appends
        end = v._append_offset
    ids: list[int] = []
    datas: list[bytes] = []
    stored: list[int] = []
    last_end = SUPER_BLOCK_SIZE
    with open(v.dat_path, "rb") as f:
        for pos, nid, nsize in iter_records(f, SUPER_BLOCK_SIZE, end):
            last_end = pos + record_size_from_header(nsize)
            if t.is_tombstone(nsize):
                continue
            nv = v.nm.get(nid)
            if nv is None or nv.offset != pos:
                continue  # garbage: overwritten or tombstoned version
            f.seek(pos + t.NEEDLE_HEADER_SIZE)
            body = f.read(nsize + 4)
            (dlen,) = struct.unpack_from("<I", body, 0)
            if dlen + 4 > nsize:
                # live record whose length field is itself rotted
                res.corrupt.append(nid)
                res.scanned += 1
                continue
            ids.append(nid)
            datas.append(bytes(body[4:4 + dlen]))
            stored.append(struct.unpack_from("<I", body, nsize)[0])
            if len(ids) >= batch:
                yield ids, datas, stored
                ids, datas, stored = [], [], []
    if ids:
        yield ids, datas, stored
    if last_end < end:
        res.error = (f"record walk torn at offset {last_end}: "
                     f"{end - last_end} trailing bytes unscanned "
                     f"(header rot or torn write)")


def scrub_volume(v: Volume, device: str = "cuda", batch: int = 4096,
                 stats: "dict | None" = None) -> ScrubResult:
    """Verify every live needle's stored CRC against its data bytes.

    device: "cuda" (K3 on the card), "cpu" (K3's plain version) or "off"
    (the host loop); see the module doc. `stats`, when given, receives the
    seconds spent in each stage, summed over batches: walk_s (the record
    walk), pack_s (left-padding into blocks), crc_s (H2D copy, K3 or its
    plain version, D2H copy and finalize; or the host loop), compare_s.
    A tiered volume returns mode "skipped-tiered" without a read.
    """
    if device not in DEVICES:
        raise ValueError(f"scrub device {device!r}: choose one of "
                         f"{', '.join(map(repr, DEVICES))} explicitly")
    res = ScrubResult(volume_id=v.id)
    if v.remote_spec is not None:
        res.mode = "skipped-tiered"
        return res
    dev = _BatchCrc(device) if device != "off" else None
    res.mode = "device" if dev is not None else "cpu"
    spent = dict.fromkeys(("walk_s", "pack_s", "crc_s", "compare_s"), 0.0)
    t0 = t_walk = time.monotonic()
    for ids, datas, stored in _iter_batches(v, batch, res):
        t_pack = time.monotonic()
        spent["walk_s"] += t_pack - t_walk
        lengths = np.array([len(d) for d in datas], dtype=np.int64)
        if dev is not None:
            got = np.zeros(len(datas), dtype=np.uint32)
            crc_s = 0.0
            for rows, block in _blocks(datas):
                t_k = time.monotonic()
                got[rows] = dev.crcs(block, lengths[rows])
                crc_s += time.monotonic() - t_k
            # packing is the loop's time outside the K3 calls
            t_crc = time.monotonic() - crc_s
        else:
            t_crc = time.monotonic()
            got = np.array([crcmod.crc32c(d) for d in datas],
                           dtype=np.uint32)
        t_cmp = time.monotonic()
        want = np.array(stored, dtype=np.uint32)
        bad = np.nonzero(got != want)[0]
        for i in bad:
            res.corrupt.append(ids[int(i)])
        res.scanned += len(ids)
        res.bytes_checked += int(lengths.sum())
        t_walk = time.monotonic()
        spent["pack_s"] += t_crc - t_pack
        spent["crc_s"] += t_cmp - t_crc
        spent["compare_s"] += t_walk - t_cmp
    res.elapsed_s = time.monotonic() - t0
    spent["walk_s"] += res.elapsed_s - (t_walk - t0)
    if stats is not None:
        stats.update(spent)
    if res.corrupt:
        log.warning("scrub volume %d: %d/%d needles corrupt: %s",
                    v.id, len(res.corrupt), res.scanned,
                    [f"{n:x}" for n in res.corrupt[:10]])
    if res.error:
        log.warning("scrub volume %d: %s", v.id, res.error)
    return res
