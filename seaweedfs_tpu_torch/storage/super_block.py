"""Volume super block: the 8-byte header of every .dat file.

Layout (re-specified from reference weed/storage/super_block/super_block.go:8-36):
    version u8 | replica_placement u8 | ttl 2B | compaction_revision u16 | extra u16
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .types import TTL, CURRENT_VERSION, ReplicaPlacement

SUPER_BLOCK_SIZE = 8
_FMT = struct.Struct("<BB2sHH")


@dataclass
class SuperBlock:
    version: int = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    compaction_revision: int = 0
    extra: int = 0

    def to_bytes(self) -> bytes:
        return _FMT.pack(self.version, self.replica_placement.to_byte(),
                         self.ttl.to_bytes(), self.compaction_revision, self.extra)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("super block truncated")
        v, rp, ttl_b, rev, extra = _FMT.unpack(b[:SUPER_BLOCK_SIZE])
        if v == 0 or v > CURRENT_VERSION:
            raise ValueError(f"unsupported volume version {v}")
        return cls(v, ReplicaPlacement.from_byte(rp), TTL.from_bytes(ttl_b), rev, extra)
