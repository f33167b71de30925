"""Bulk-PUT wire framing: many needles in one HTTP body.

The single-needle PUT pays ~115 us of HTTP protocol per write; packing N
needles into one framed body amortizes that to ~115/N us. The frame is
deliberately dumb — length-prefixed binary, no compression, no nesting —
so both ends parse it with one struct walk and the volume server can
hand payload views straight to the needle encoder without copying.

Layout (little-endian):

    frame header : magic "SWBF" | version u8 (=1) | count u32 | vid u32
    per needle   : key u64 | cookie u32 | size u32 | flags u8 | crc u32
                   | data[size]

`flags` carries the needle flag bits that survive bulk ingest (gzip).
`crc` is crc32c(data) — the same checksum the needle trailer stores, so
the server verifies wire integrity once and reuses the value as the
needle's eTag. The reference has no bulk frame (its Assign(count=N)
clients still PUT per needle); this is the fork's ingest data plane.

The port's copy of the JAX package's storage/bulk.py, byte for byte on the
wire; the CRC32C is the port's host `ops/crc32c.py`. The READ_* statuses
are also what Volume.read_needles returns.
"""

from __future__ import annotations

import struct
from typing import Iterator, NamedTuple

from ..ops.crc32c import crc32c

FRAME_MAGIC = b"SWBF"
FRAME_VERSION = 1
_FRAME_HEADER = struct.Struct("<4sBII")   # magic | version | count | vid
_NEEDLE_HEADER = struct.Struct("<QIIBI")  # key | cookie | size | flags | crc

# a single frame is bounded well under the volume server's 256 MB body
# cap; clients chunk larger batches into multiple frames
MAX_FRAME_NEEDLES = 65536


class FrameError(ValueError):
    """Malformed/corrupt bulk frame (maps to HTTP 400 — the client must
    not retry the identical bytes)."""


class BulkEntry(NamedTuple):
    key: int
    cookie: int
    flags: int
    crc: int
    data: memoryview  # zero-copy view into the frame body


def pack_frame(vid: int, entries: "list[tuple[int, int, bytes, int]]",
               ) -> bytes:
    """Build one frame from (key, cookie, data, flags) tuples."""
    if not entries:
        raise FrameError("empty bulk frame")
    if len(entries) > MAX_FRAME_NEEDLES:
        raise FrameError(f"frame of {len(entries)} needles exceeds "
                         f"{MAX_FRAME_NEEDLES}")
    parts = [_FRAME_HEADER.pack(FRAME_MAGIC, FRAME_VERSION,
                                len(entries), vid)]
    for key, cookie, data, flags in entries:
        parts.append(_NEEDLE_HEADER.pack(key, cookie, len(data),
                                         flags & 0xFF, crc32c(data)))
        parts.append(bytes(data))
    return b"".join(parts)


def unpack_frame(body: bytes | memoryview,
                 verify_crc: bool = True) -> "tuple[int, list[BulkEntry]]":
    """(vid, entries) from a frame body. Raises FrameError on a bad
    magic/version, truncation, count mismatch, or (when verify_crc) a
    payload whose crc32c disagrees with its header — the whole frame is
    rejected before a single byte lands in a volume."""
    buf = memoryview(body)
    if len(buf) < _FRAME_HEADER.size:
        raise FrameError("frame shorter than its header")
    magic, version, count, vid = _FRAME_HEADER.unpack_from(buf, 0)
    if magic != FRAME_MAGIC:
        raise FrameError(f"bad frame magic {bytes(magic)!r}")
    if version != FRAME_VERSION:
        raise FrameError(f"unsupported frame version {version}")
    if not 0 < count <= MAX_FRAME_NEEDLES:
        raise FrameError(f"bad frame needle count {count}")
    entries: list[BulkEntry] = []
    off = _FRAME_HEADER.size
    for _ in range(count):
        if off + _NEEDLE_HEADER.size > len(buf):
            raise FrameError("truncated needle header")
        key, cookie, size, flags, crc = _NEEDLE_HEADER.unpack_from(buf, off)
        off += _NEEDLE_HEADER.size
        if off + size > len(buf):
            raise FrameError(f"truncated needle payload (key {key:x})")
        data = buf[off:off + size]
        off += size
        if verify_crc and crc32c(data) != crc:
            raise FrameError(f"needle {key:x} crc mismatch on the wire")
        entries.append(BulkEntry(key, cookie, flags, crc, data))
    if off != len(buf):
        raise FrameError(f"{len(buf) - off} trailing bytes after "
                         f"{count} needles")
    return vid, entries


def iter_frame(body: bytes | memoryview) -> Iterator[BulkEntry]:
    """Convenience generator over a frame's entries."""
    _, entries = unpack_frame(body)
    yield from entries


# ---------------------------------------------------------------------------
# Bulk GET: the same framing idea in reverse. The request names a vid +
# (key, cookie) list; the response streams found needles back in one
# length-prefixed frame with a per-needle status, so misses and deleted
# needles cost 17 bytes instead of an HTTP round-trip each.
# ---------------------------------------------------------------------------

READ_REQ_MAGIC = b"SWBR"
READ_RESP_MAGIC = b"SWBG"
_READ_REQ_ENTRY = struct.Struct("<QI")      # key | cookie
_READ_RESP_ENTRY = struct.Struct("<QIBBII")  # key|cookie|status|flags|size|crc

# per-needle status in the response frame
READ_OK = 0
READ_NOT_FOUND = 1     # missing/deleted — a definitive per-needle miss
READ_ERROR = 2         # IO/crc/cookie failure — client retries elsewhere
READ_OVERFLOW = 3      # needle didn't fit the frame's byte budget —
                       # client re-fetches it per-needle


class ReadResult(NamedTuple):
    key: int
    cookie: int
    status: int        # READ_OK / READ_NOT_FOUND / READ_ERROR
    flags: int         # needle flag bits (gzip) when READ_OK
    crc: int           # crc32c(data) when READ_OK (doubles as eTag)
    data: memoryview   # zero-copy view into the response body


def pack_read_request(vid: int, pairs: "list[tuple[int, int]]") -> bytes:
    """Request frame from (key, cookie) pairs."""
    if not pairs:
        raise FrameError("empty bulk-read request")
    if len(pairs) > MAX_FRAME_NEEDLES:
        raise FrameError(f"bulk-read of {len(pairs)} needles exceeds "
                         f"{MAX_FRAME_NEEDLES}")
    parts = [_FRAME_HEADER.pack(READ_REQ_MAGIC, FRAME_VERSION,
                                len(pairs), vid)]
    parts.extend(_READ_REQ_ENTRY.pack(key, cookie) for key, cookie in pairs)
    return b"".join(parts)


def unpack_read_request(body: bytes | memoryview,
                        ) -> "tuple[int, list[tuple[int, int]]]":
    """(vid, [(key, cookie)]) from a request frame."""
    buf = memoryview(body)
    if len(buf) < _FRAME_HEADER.size:
        raise FrameError("bulk-read request shorter than its header")
    magic, version, count, vid = _FRAME_HEADER.unpack_from(buf, 0)
    if magic != READ_REQ_MAGIC:
        raise FrameError(f"bad bulk-read magic {bytes(magic)!r}")
    if version != FRAME_VERSION:
        raise FrameError(f"unsupported bulk-read version {version}")
    if not 0 < count <= MAX_FRAME_NEEDLES:
        raise FrameError(f"bad bulk-read needle count {count}")
    want = _FRAME_HEADER.size + count * _READ_REQ_ENTRY.size
    if len(buf) != want:
        raise FrameError(f"bulk-read request is {len(buf)} bytes, "
                         f"expected {want}")
    off = _FRAME_HEADER.size
    pairs = []
    for _ in range(count):
        pairs.append(_READ_REQ_ENTRY.unpack_from(buf, off))
        off += _READ_REQ_ENTRY.size
    return vid, pairs


def pack_read_response(vid: int,
                       results: "list[tuple[int, int, int, int, bytes]]",
                       ) -> bytes:
    """Response frame from (key, cookie, status, flags, data) tuples;
    non-OK statuses carry no payload bytes."""
    parts = [_FRAME_HEADER.pack(READ_RESP_MAGIC, FRAME_VERSION,
                                len(results), vid)]
    for key, cookie, status, flags, data in results:
        if status != READ_OK:
            data = b""
        parts.append(_READ_RESP_ENTRY.pack(key, cookie, status & 0xFF,
                                           flags & 0xFF, len(data),
                                           crc32c(data) if data else 0))
        if data:
            parts.append(bytes(data))
    return b"".join(parts)


def unpack_read_response(body: bytes | memoryview,
                         verify_crc: bool = True,
                         ) -> "tuple[int, list[ReadResult]]":
    """(vid, [ReadResult]) from a response frame; the per-needle crc is
    verified on the wire like the PUT frame's, so a corrupted hop is a
    FrameError, never silently-wrong payload bytes."""
    buf = memoryview(body)
    if len(buf) < _FRAME_HEADER.size:
        raise FrameError("bulk-read response shorter than its header")
    magic, version, count, vid = _FRAME_HEADER.unpack_from(buf, 0)
    if magic != READ_RESP_MAGIC:
        raise FrameError(f"bad bulk-read response magic {bytes(magic)!r}")
    if version != FRAME_VERSION:
        raise FrameError(f"unsupported bulk-read version {version}")
    if not 0 < count <= MAX_FRAME_NEEDLES:
        raise FrameError(f"bad bulk-read result count {count}")
    off = _FRAME_HEADER.size
    results: "list[ReadResult]" = []
    for _ in range(count):
        if off + _READ_RESP_ENTRY.size > len(buf):
            raise FrameError("truncated bulk-read result header")
        key, cookie, status, flags, size, crc = \
            _READ_RESP_ENTRY.unpack_from(buf, off)
        off += _READ_RESP_ENTRY.size
        if off + size > len(buf):
            raise FrameError(f"truncated bulk-read payload (key {key:x})")
        data = buf[off:off + size]
        off += size
        if size and verify_crc and crc32c(data) != crc:
            raise FrameError(f"needle {key:x} crc mismatch on the wire")
        results.append(ReadResult(key, cookie, status, flags, crc, data))
    if off != len(buf):
        raise FrameError(f"{len(buf) - off} trailing bytes after "
                         f"{count} bulk-read results")
    return vid, results
