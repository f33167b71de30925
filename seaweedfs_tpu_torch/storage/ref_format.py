"""Readers for the REFERENCE on-disk volume format (big-endian).

Our own needle/.idx layouts are re-specified little-endian
(storage/needle.py, storage/needle_map.py); this module reads the
*reference's* big-endian format so a cluster can migrate: import a
reference volume server's .dat/.idx (or validate EC shards produced by
either implementation against the other's volumes).

Layout sources (all verified against the mounted snapshot):
- super block: weed/storage/super_block/super_block.go:8-36
  (version 1B, replica placement 1B, TTL 2B, compaction revision 2B,
  reserved — 8 bytes total; v2/3 may append ExtraSize extra bytes)
- needle header: cookie 4B, id 8B, size 4B, all big-endian
  (weed/storage/types/needle_types.go:35, util/bytes.go BytesToUint64)
- needle body v2/v3: DataSize 4B + data + flags 1B + optional
  name/mime/last-modified/ttl/pairs (needle_read.go:115-188)
- record size: header + size + CRC 4B [+ appendAtNs 8B in v3] + padding
  to the next 8-byte boundary, where an already-aligned record still
  gets 8 pad bytes (needle_read.go:208-221 PaddingLength quirk)
- CRC: CRC32-Castagnoli over n.Data; both the raw value and the
  legacy scrambled `Value()` form are accepted (needle/crc.go:25,
  needle_read.go:76-80)
- .idx entry: key 8B + offset/8 4B + size 4B, big-endian (idx/walk.go)

The port's copy of seaweedfs_tpu/storage/ref_format.py; the CRC runs
through the port's host `ops/crc32c.crc32c`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

NEEDLE_HEADER_SIZE = 16
CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
PADDING = 8
TOMBSTONE = 0xFFFFFFFF

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20


@dataclass
class RefSuperBlock:
    version: int
    replica_placement: int
    ttl_raw: bytes
    compaction_revision: int
    extra_size: int = 0

    @property
    def block_size(self) -> int:
        return 8 + (self.extra_size if self.version >= 2 else 0)


def parse_super_block(b: bytes) -> RefSuperBlock:
    if len(b) < 8:
        raise ValueError("super block too short")
    extra = struct.unpack(">H", b[6:8])[0] if b[0] >= 2 else 0
    return RefSuperBlock(version=b[0], replica_placement=b[1],
                         ttl_raw=b[2:4],
                         compaction_revision=struct.unpack(">H", b[4:6])[0],
                         extra_size=extra)


def padding_length(size: int, version: int) -> int:
    base = NEEDLE_HEADER_SIZE + size + CHECKSUM_SIZE
    if version == 3:
        base += TIMESTAMP_SIZE
    return PADDING - (base % PADDING)


def record_size(size: int, version: int) -> int:
    """Full on-disk footprint of one needle record (GetActualSize)."""
    body = size + CHECKSUM_SIZE + padding_length(size, version)
    if version == 3:
        body += TIMESTAMP_SIZE
    return NEEDLE_HEADER_SIZE + body


def crc32c_scrambled(raw: int) -> int:
    """The legacy CRC `Value()` form (needle/crc.go:25): rot17 + const."""
    return (((raw >> 15) | (raw << 17)) + 0xA282EAD8) & 0xFFFFFFFF


@dataclass
class RefNeedle:
    offset: int  # byte offset of the record in the .dat
    cookie: int
    id: int
    size: int  # the header's size field (body payload length)
    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    last_modified: int = 0
    ttl_raw: bytes = b""
    pairs: bytes = b""
    checksum: int = 0
    append_at_ns: int = 0
    crc_ok: bool = True
    extra: dict = field(default_factory=dict)

    @property
    def is_tombstone(self) -> bool:
        return self.size == TOMBSTONE or self.size == 0


def parse_needle(buf: bytes, offset: int, version: int) -> RefNeedle:
    """Parse one record from `buf` (the whole .dat mmap/bytes) at
    byte `offset` (readNeedleDataVersion2, needle_read.go:115)."""
    cookie, nid, size = struct.unpack_from(">IQI", buf, offset)
    n = RefNeedle(offset=offset, cookie=cookie, id=nid, size=size)
    if size in (TOMBSTONE, 0):
        n.size = 0 if size == TOMBSTONE else size
        n.extra["raw_size"] = size
        return n
    body = buf[offset + NEEDLE_HEADER_SIZE: offset + NEEDLE_HEADER_SIZE + size]
    if version == 1:
        n.data = bytes(body)
    else:
        i = 0
        (data_size,) = struct.unpack_from(">I", body, i)
        i += 4
        n.data = bytes(body[i:i + data_size])
        i += data_size
        if i < len(body):
            n.flags = body[i]
            i += 1
        if i < len(body) and n.flags & FLAG_HAS_NAME:
            ln = body[i]
            n.name = bytes(body[i + 1:i + 1 + ln])
            i += 1 + ln
        if i < len(body) and n.flags & FLAG_HAS_MIME:
            ln = body[i]
            n.mime = bytes(body[i + 1:i + 1 + ln])
            i += 1 + ln
        if i < len(body) and n.flags & FLAG_HAS_LAST_MODIFIED:
            n.last_modified = int.from_bytes(body[i:i + 5], "big")
            i += 5
        if i < len(body) and n.flags & FLAG_HAS_TTL:
            n.ttl_raw = bytes(body[i:i + 2])
            i += 2
        if i < len(body) and n.flags & FLAG_HAS_PAIRS:
            (psize,) = struct.unpack_from(">H", body, i)
            n.pairs = bytes(body[i + 2:i + 2 + psize])
            i += 2 + psize
    (stored_crc,) = struct.unpack_from(
        ">I", buf, offset + NEEDLE_HEADER_SIZE + size)
    n.checksum = stored_crc
    from ..ops.crc32c import crc32c
    raw = crc32c(n.data)
    n.crc_ok = stored_crc in (raw, crc32c_scrambled(raw))
    if version == 3:
        (n.append_at_ns,) = struct.unpack_from(
            ">Q", buf, offset + NEEDLE_HEADER_SIZE + size + CHECKSUM_SIZE)
    return n


def walk_dat(path: str):
    """Yield (super_block, [RefNeedle...]) scanning a reference .dat
    sequentially (the `weed fix`/scan pattern, command/fix.go:74)."""
    with open(path, "rb") as f:
        buf = f.read()
    sb = parse_super_block(buf[:8])
    needles = []
    pos = sb.block_size
    while pos + NEEDLE_HEADER_SIZE <= len(buf):
        _, _, size = struct.unpack_from(">IQI", buf, pos)
        if size == TOMBSTONE:
            size = 0
        n = parse_needle(buf, pos, sb.version)
        needles.append(n)
        pos += record_size(size, sb.version)
    return sb, needles


def read_idx(path: str) -> list[tuple[int, int, int]]:
    """Parse a reference big-endian .idx: (key, stored_offset, size)."""
    out = []
    with open(path, "rb") as f:
        raw = f.read()
    for i in range(0, len(raw) - len(raw) % 16, 16):
        out.append(struct.unpack_from(">QII", raw, i))
    return out


def write_sorted_ecx(idx_path: str, ecx_path: str) -> int:
    """Reference WriteSortedFileFromIdx (ec_encoder.go:27): the .ecx is
    the .idx's 16-byte entries re-ordered ascending by needle id, bytes
    otherwise untouched. Returns the entry count."""
    with open(idx_path, "rb") as f:
        raw = f.read()
    entries = [raw[i:i + 16] for i in range(0, len(raw) - len(raw) % 16, 16)]
    entries.sort(key=lambda e: struct.unpack(">Q", e[:8])[0])
    with open(ecx_path, "wb") as f:
        f.write(b"".join(entries))
    return len(entries)
