"""Seeded needle sets and SeaweedFS's version-3 needle record.

A record: cookie u32, id u64, body size u32 (little-endian), then the
body, data size u32, the data and one flags byte (0: no name, mime or
other extras), then the CRC32C of the data u32 and the append time u64,
zero-padded to 8 bytes. A volume's .dat starts with an 8-byte superblock.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

SUPER_BLOCK = 8
HEADER = 16
PADDING = 8


def record_size(data_size: int) -> int:
    raw = HEADER + 4 + data_size + 1 + 4 + 8
    return raw + (-raw) % PADDING


@dataclass
class Volume:
    """The needles of one volume: ids 1..n in write order."""
    vid: int
    sizes: np.ndarray      # data bytes of each needle
    cookies: np.ndarray    # uint32
    data: bytes            # every needle's data, back to back
    starts: np.ndarray     # where each needle's data starts in `data`

    @property
    def n(self) -> int:
        return len(self.sizes)

    def needle(self, i: int) -> bytes:
        """Data of the needle with id i + 1."""
        s = int(self.starts[i])
        return self.data[s:s + int(self.sizes[i])]

    def offsets(self) -> np.ndarray:
        """Each record's offset in a .dat that holds them in order."""
        rec = np.array([record_size(int(s)) for s in self.sizes], np.int64)
        return SUPER_BLOCK + np.concatenate([[0], np.cumsum(rec)[:-1]])

    def dat_size(self) -> int:
        return SUPER_BLOCK + sum(record_size(int(s)) for s in self.sizes)


def needle_sizes(data: dict) -> "list[np.ndarray]":
    """Each volume's needle sizes from a configuration's `data` block:
    `needles` of `needle_bytes` spread evenly, or `objects` of
    `object_bytes` cut into chunks of at most `chunk_bytes`, whole objects
    dealt to the volumes in turn."""
    vols = int(data["volumes"])
    if "needles" in data:
        per = int(data["needles"]) // vols
        return [np.full(per, int(data["needle_bytes"]), np.int64)
                for _ in range(vols)]
    size, chunk = int(data["object_bytes"]), int(data["chunk_bytes"])
    one = [chunk] * (size // chunk) + ([size % chunk] if size % chunk else [])
    per = int(data["objects"]) // vols
    return [np.array(one * per, np.int64) for _ in range(vols)]


def chunks_per_object(data: dict) -> int:
    if "needles" in data:
        return 1
    size, chunk = int(data["object_bytes"]), int(data["chunk_bytes"])
    return -(-size // chunk)


def generate(data: dict, seed: int) -> "list[Volume]":
    """The needle sets of a configuration, all from `seed`: volume v's
    bytes and cookies come from its own stream, so every seed gives the
    same sizes and only other bytes."""
    out = []
    for v, sizes in enumerate(needle_sizes(data), start=1):
        rng = np.random.default_rng([seed & (2**63 - 1), v])
        cookies = rng.integers(0, 1 << 32, len(sizes), dtype=np.uint64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        out.append(Volume(v, sizes, cookies.astype(np.uint32),
                          rng.bytes(int(sizes.sum())), starts))
    return out


@dataclass
class Parsed:
    ids: np.ndarray
    cookies: np.ndarray
    data_at: np.ndarray    # offset of each record's data in the .dat
    sizes: np.ndarray
    crcs: np.ndarray       # the CRC32C each record stores


def parse_dat(buf: bytes) -> Parsed:
    """Walk a .dat's records (live needles with no extras, no
    tombstones)."""
    ids, cookies, at, sizes, crcs = [], [], [], [], []
    pos, end = SUPER_BLOCK, len(buf)
    while pos + HEADER <= end:
        cookie, nid, body = struct.unpack_from("<IQI", buf, pos)
        (dsize,) = struct.unpack_from("<I", buf, pos + HEADER)
        if body != 4 + dsize + 1:
            raise ValueError(f"record at {pos}: body {body} for data {dsize}")
        (crc,) = struct.unpack_from("<I", buf, pos + HEADER + body)
        ids.append(nid)
        cookies.append(cookie)
        at.append(pos + HEADER + 4)
        sizes.append(dsize)
        crcs.append(crc)
        pos += record_size(dsize)
    return Parsed(np.array(ids, np.uint64), np.array(cookies, np.uint32),
                  np.array(at, np.int64), np.array(sizes, np.int64),
                  np.array(crcs, np.uint32))
