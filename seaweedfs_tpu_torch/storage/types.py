"""Core storage types and on-disk constants (the port's copy of the JAX
package's storage/types.py).

Re-specified (not copied) from the reference's layouts so the semantics match:
reference weed/storage/types/needle_types.go:36-42 (NeedleId 8B, Offset
stored /8 in 4B => 32 GB max volume, Size int32 with tombstone -1),
weed/storage/needle/needle.go:25-46 (record layout), super_block/super_block.go:8-36.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4          # stored as actual_offset // PADDING
SIZE_SIZE = 4
NEEDLE_HEADER_SIZE = 4 + NEEDLE_ID_SIZE + SIZE_SIZE  # cookie + id + size
NEEDLE_PADDING = 8       # every record padded to 8B; offsets are /8
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
IDX_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16 bytes

TOMBSTONE_SIZE = 0xFFFFFFFF  # uint32 representation of -1 (deleted marker)
MAX_VOLUME_SIZE = NEEDLE_PADDING * (1 << (8 * OFFSET_SIZE))  # 32 GiB

CURRENT_VERSION = 3  # matches reference v3 (append_at_ns trailer)


def offset_to_stored(actual: int) -> int:
    assert actual % NEEDLE_PADDING == 0, actual
    return actual // NEEDLE_PADDING


def stored_to_offset(stored: int) -> int:
    return stored * NEEDLE_PADDING


def is_tombstone(size: int) -> bool:
    return size == TOMBSTONE_SIZE or size < 0


def actual_record_size(data_block_size):
    """Total bytes a needle occupies on disk including header+crc+ts+padding:
    of one body size, or element-wise of a numpy int64 array of them."""
    raw = NEEDLE_HEADER_SIZE + data_block_size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE
    return raw + (-raw) % NEEDLE_PADDING


class DiskType(str, enum.Enum):
    HDD = "hdd"
    SSD = "ssd"

    @classmethod
    def parse(cls, s: str) -> "DiskType":
        s = (s or "hdd").lower()
        if s in ("", "hdd"):
            return cls.HDD
        if s == "ssd":
            return cls.SSD
        raise ValueError(f"unknown disk type {s!r}")


_TTL_UNITS = {0: ("", 0), 1: ("m", 60), 2: ("h", 3600), 3: ("d", 86400),
              4: ("w", 604800), 5: ("M", 2592000), 6: ("y", 31536000)}
_TTL_SUFFIX = {v[0]: k for k, v in _TTL_UNITS.items() if v[0]}


@dataclass(frozen=True)
class TTL:
    """Two-byte TTL: count + unit (reference weed/storage/needle/volume_ttl.go)."""
    count: int = 0
    unit: int = 0

    @classmethod
    def parse(cls, s: str | None) -> "TTL":
        if not s:
            return cls(0, 0)
        s = s.strip()
        if s[-1] in _TTL_SUFFIX:
            return cls(int(s[:-1]), _TTL_SUFFIX[s[-1]])
        return cls(int(s), 1)  # bare number = minutes

    @property
    def seconds(self) -> int:
        return self.count * _TTL_UNITS[self.unit][1]

    def to_bytes(self) -> bytes:
        return struct.pack("<BB", self.count & 0xFF, self.unit & 0xFF)

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        c, u = struct.unpack("<BB", b[:2])
        return cls(c, u)

    def __str__(self) -> str:
        if self.count == 0:
            return ""
        return f"{self.count}{_TTL_UNITS[self.unit][0] or 'm'}"


@dataclass(frozen=True)
class ReplicaPlacement:
    """xyz replication code (reference super_block/replica_placement.go:8-54):
    x = copies on other data centers, y = other racks same DC, z = other
    servers same rack. '000' = single copy."""
    other_dc: int = 0
    other_rack: int = 0
    same_rack: int = 0

    @classmethod
    def parse(cls, s: str | int | None) -> "ReplicaPlacement":
        if s is None or s == "":
            return cls()
        if isinstance(s, int):
            return cls(s // 100 % 10, s // 10 % 10, s % 10)
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"replication code must be 3 digits, got {s!r}")
        return cls(int(s[0]), int(s[1]), int(s[2]))

    @property
    def copy_count(self) -> int:
        return self.other_dc + self.other_rack + self.same_rack + 1

    def to_byte(self) -> int:
        return self.other_dc * 100 + self.other_rack * 10 + self.same_rack

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(b // 100 % 10, b // 10 % 10, b % 10)

    def __str__(self) -> str:
        return f"{self.other_dc}{self.other_rack}{self.same_rack}"


def file_id(volume_id: int, needle_id: int, cookie: int) -> str:
    """Render 'vid,key_hex+cookie_hex' like reference weed/storage/needle/file_id.go."""
    return f"{volume_id},{needle_id:x}{cookie:08x}"


def parse_file_id(fid: str) -> tuple[int, int, int]:
    """fid -> (volume_id, needle_id, cookie)."""
    if "," not in fid:
        raise ValueError(f"bad file id {fid!r}")
    vid_s, rest = fid.split(",", 1)
    # strip any sub-fid suffix like '_1'
    rest = rest.split("_")[0]
    if len(rest) <= 8:
        raise ValueError(f"bad file id key+cookie {fid!r}")
    return int(vid_s), int(rest[:-8], 16), int(rest[-8:], 16)
