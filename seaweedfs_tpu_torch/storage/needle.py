"""Needle: the unit blob record inside a volume (the port's copy of the JAX
package's storage/needle.py; its CRC runs the port's host library,
ops/crc32c.py).

On-disk record (re-specified from reference weed/storage/needle/needle.go:25-46
and needle_write.go:14-100, version 3):

    header   : cookie u32 | needle_id u64 | size u32        (16 B, little-endian)
    body     : data_size u32 | data | flags u8
               [name_len u8 | name]          if FLAG_NAME
               [mime_len u8 | mime]          if FLAG_MIME
               [last_modified u40]           if FLAG_LAST_MODIFIED (5 B seconds)
               [ttl 2B]                      if FLAG_TTL
               [pairs_len u16 | pairs_json]  if FLAG_PAIRS
    trailer  : crc32c u32 | append_at_ns u64 | zero pad to 8 B boundary

`size` in the header counts the body bytes (data_size..pairs). A deletion is
an appended tombstone record with size = 0xFFFFFFFF and empty body.
CRC covers only `data` (reference crc.go semantics).
"""

from __future__ import annotations

import json
import struct
import time
from dataclasses import dataclass, field

from ..ops.crc32c import crc32c
from . import types as t

FLAG_GZIP = 0x01
FLAG_NAME = 0x02
FLAG_MIME = 0x04
FLAG_LAST_MODIFIED = 0x08
FLAG_TTL = 0x10
FLAG_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES = 5


@dataclass
class Needle:
    id: int
    cookie: int
    data: bytes = b""
    name: bytes = b""
    mime: bytes = b""
    pairs: dict[str, str] = field(default_factory=dict)
    last_modified: int = 0
    ttl: t.TTL = field(default_factory=t.TTL)
    is_gzipped: bool = False
    is_chunk_manifest: bool = False
    checksum: int = 0
    append_at_ns: int = 0
    is_tombstone_record: bool = False  # parsed from header size == 0xFFFFFFFF

    # -- encode ------------------------------------------------------------
    def _flags(self) -> int:
        f = 0
        if self.is_gzipped:
            f |= FLAG_GZIP
        if self.name:
            f |= FLAG_NAME
        if self.mime:
            f |= FLAG_MIME
        if self.last_modified:
            f |= FLAG_LAST_MODIFIED
        if self.ttl.count:
            f |= FLAG_TTL
        if self.pairs:
            f |= FLAG_PAIRS
        if self.is_chunk_manifest:
            f |= FLAG_IS_CHUNK_MANIFEST
        return f

    def to_bytes(self, now_ns: int | None = None) -> bytes:
        """Full padded on-disk record. One exact-size allocation and a
        single copy of `data` — the old incremental bytearray appends
        copied a large chunk three times (append-resize, record concat,
        final bytes()), which made serialization the volume server's
        hottest line under multi-MB chunk PUTs."""
        meta = bytearray()
        meta += struct.pack("<B", self._flags())
        if self.name:
            if len(self.name) > 255:
                raise ValueError("needle name too long")
            meta += struct.pack("<B", len(self.name)) + self.name
        if self.mime:
            if len(self.mime) > 255:
                raise ValueError("mime too long")
            meta += struct.pack("<B", len(self.mime)) + self.mime
        if self.last_modified:
            meta += self.last_modified.to_bytes(LAST_MODIFIED_BYTES, "little")
        if self.ttl.count:
            meta += self.ttl.to_bytes()
        if self.pairs:
            pj = json.dumps(self.pairs, separators=(",", ":")).encode()
            if len(pj) > 0xFFFF:
                raise ValueError("pairs too large")
            meta += struct.pack("<H", len(pj)) + pj

        self.checksum = crc32c(self.data)
        self.append_at_ns = now_ns if now_ns is not None else time.time_ns()
        dlen = len(self.data)
        body_len = 4 + dlen + len(meta)
        total = 16 + body_len + 12
        rec = bytearray(total + (-total % t.NEEDLE_PADDING))
        struct.pack_into("<IQII", rec, 0, self.cookie, self.id, body_len,
                         dlen)
        rec[20:20 + dlen] = self.data
        rec[20 + dlen:20 + dlen + len(meta)] = meta
        struct.pack_into("<IQ", rec, 16 + body_len, self.checksum,
                         self.append_at_ns)
        return bytes(rec)

    @staticmethod
    def tombstone(needle_id: int, cookie: int = 0, now_ns: int | None = None) -> bytes:
        rec = bytearray()
        rec += struct.pack("<IQI", cookie, needle_id, t.TOMBSTONE_SIZE)
        rec += struct.pack("<IQ", 0, now_ns if now_ns is not None else time.time_ns())
        pad = -len(rec) % t.NEEDLE_PADDING
        rec += b"\x00" * pad
        return bytes(rec)

    # -- decode ------------------------------------------------------------
    @classmethod
    def from_bytes(cls, buf: bytes | memoryview, verify_crc: bool = True) -> "Needle":
        """Parse one record from the start of buf (may extend past record end)."""
        cookie, nid, size = struct.unpack_from("<IQI", buf, 0)
        if size == t.TOMBSTONE_SIZE:
            n = cls(id=nid, cookie=cookie, is_tombstone_record=True)
            n.checksum, n.append_at_ns = struct.unpack_from(
                "<IQ", buf, t.NEEDLE_HEADER_SIZE)
            return n
        off = t.NEEDLE_HEADER_SIZE
        end_body = off + size
        (data_size,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = bytes(buf[off:off + data_size])
        off += data_size
        (flags,) = struct.unpack_from("<B", buf, off)
        off += 1
        name = mime = b""
        pairs: dict[str, str] = {}
        last_modified = 0
        ttl = t.TTL()
        if flags & FLAG_NAME:
            (ln,) = struct.unpack_from("<B", buf, off)
            off += 1
            name = bytes(buf[off:off + ln])
            off += ln
        if flags & FLAG_MIME:
            (lm,) = struct.unpack_from("<B", buf, off)
            off += 1
            mime = bytes(buf[off:off + lm])
            off += lm
        if flags & FLAG_LAST_MODIFIED:
            last_modified = int.from_bytes(bytes(buf[off:off + LAST_MODIFIED_BYTES]), "little")
            off += LAST_MODIFIED_BYTES
        if flags & FLAG_TTL:
            ttl = t.TTL.from_bytes(bytes(buf[off:off + 2]))
            off += 2
        if flags & FLAG_PAIRS:
            (lp,) = struct.unpack_from("<H", buf, off)
            off += 2
            pairs = json.loads(bytes(buf[off:off + lp]))
            off += lp
        if off != end_body:
            raise ValueError(
                f"needle {nid:x} body mismatch: consumed {off - t.NEEDLE_HEADER_SIZE} of {size}")
        checksum, append_at_ns = struct.unpack_from("<IQ", buf, end_body)
        if verify_crc and checksum != crc32c(data):
            raise ValueError(f"needle {nid:x} CRC mismatch")
        return cls(
            id=nid, cookie=cookie, data=data, name=name, mime=mime, pairs=pairs,
            last_modified=last_modified, ttl=ttl,
            is_gzipped=bool(flags & FLAG_GZIP),
            is_chunk_manifest=bool(flags & FLAG_IS_CHUNK_MANIFEST),
            checksum=checksum, append_at_ns=append_at_ns)

    @property
    def is_deleted(self) -> bool:
        """True only for parsed tombstone records (header size 0xFFFFFFFF) —
        a live zero-length needle is NOT deleted."""
        return self.is_tombstone_record

    def disk_size(self) -> int:
        """Size of the padded record this needle would occupy."""
        return len(self.to_bytes(now_ns=self.append_at_ns or 1))


def record_size_from_header(size: int) -> int:
    """Padded record length given the header's size field."""
    if size == t.TOMBSTONE_SIZE:
        body = 0
    else:
        body = size
    return t.actual_record_size(body)
