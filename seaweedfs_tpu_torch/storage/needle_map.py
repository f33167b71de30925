"""In-memory needle index: id -> (offset, size), plus the .idx append log
(the port's copy of the JAX package's storage/needle_map.py).

Reference equivalents: weed/storage/needle_map.go (NeedleMapper),
compact_map.go:202-268 (CompactMap: 16 B/entry sectioned sorted arrays),
idx/walk.go (WalkIndexFile). Our CompactMap keeps the same asymptotics with a
numpy flavor: a sorted base (three parallel arrays, binary-searched) plus a
small dict overlay for recent writes that is merged down when it grows. This
keeps steady-state memory near 20 B/needle and lookups O(log n).

.idx entry (16 B, little-endian): needle_id u64 | offset u32 (/8) | size u32.
Tombstones are written as size = 0xFFFFFFFF with offset 0 (reference writes
deletes to the idx the same way, needle_map.go).
"""

from __future__ import annotations

import os
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from . import types as t

_ENTRY = struct.Struct("<QII")


@dataclass
class NeedleValue:
    key: int
    offset: int  # actual byte offset in .dat
    size: int    # body size from header (not padded record size)


class CompactMap:
    """id -> (offset/8 stored, size) with numpy sorted base + dict overlay.

    Concurrency contract: writers (set/delete/_merge) are serialized by
    the volume lock, but the seqlock read path calls get() with NO lock.
    The three base arrays therefore live in ONE tuple attribute swapped
    atomically (a single STORE_ATTR): a reader snapshots `self._base`
    once and indexes a consistent (keys, offsets, sizes) triple. Storing
    them as three attributes would let a reader interleave between the
    stores and index the new keys against the old offsets — a wrong (or
    out-of-range) record for a perfectly healthy needle. Order matters
    in _merge too: the new base is published BEFORE the overlay clears,
    so a lock-free get() always finds a key in at least one of them.
    """

    MERGE_THRESHOLD = 65536

    _EMPTY = (np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint32),
              np.empty(0, dtype=np.uint32))

    def __init__(self) -> None:
        self._base: "tuple[np.ndarray, np.ndarray, np.ndarray]" = self._EMPTY
        self._overlay: dict[int, tuple[int, int]] = {}

    def __len__(self) -> int:
        # approximate live count: base + overlay (minus overlap, ignored)
        return int(self._base[0].size) + len(self._overlay)

    def _merge(self) -> None:
        if not self._overlay:
            return
        bkeys, boffs, bsizes = self._base
        ok = np.fromiter(self._overlay.keys(), dtype=np.uint64, count=len(self._overlay))
        ov = np.array(list(self._overlay.values()), dtype=np.uint32).reshape(-1, 2)
        keys = np.concatenate([bkeys, ok])
        offsets = np.concatenate([boffs, ov[:, 0]])
        sizes = np.concatenate([bsizes, ov[:, 1]])
        # stable sort; later (overlay) entries win on duplicates
        order = np.argsort(keys, kind="stable")
        keys, offsets, sizes = keys[order], offsets[order], sizes[order]
        if keys.size:
            last = np.ones(keys.size, dtype=bool)
            last[:-1] = keys[:-1] != keys[1:]
            keys, offsets, sizes = keys[last], offsets[last], sizes[last]
        # publish the new base BEFORE dropping the overlay (see class doc)
        self._base = (keys, offsets, sizes)
        self._overlay.clear()

    def set(self, key: int, stored_offset: int, size: int) -> None:
        self._overlay[key] = (stored_offset, size & 0xFFFFFFFF)
        if len(self._overlay) >= self.MERGE_THRESHOLD:
            self._merge()

    def delete(self, key: int) -> bool:
        existed = self.get(key) is not None
        self._overlay[key] = (0, t.TOMBSTONE_SIZE)
        if len(self._overlay) >= self.MERGE_THRESHOLD:
            self._merge()
        return existed

    def get(self, key: int) -> NeedleValue | None:
        v = self._overlay.get(key)
        if v is None:
            keys, offsets, sizes = self._base  # one atomic snapshot
            if keys.size:
                i = int(np.searchsorted(keys, np.uint64(key)))
                if i < keys.size and int(keys[i]) == key:
                    v = (int(offsets[i]), int(sizes[i]))
        if v is None or t.is_tombstone(v[1]):
            return None
        return NeedleValue(key, t.stored_to_offset(v[0]), v[1])

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        self._merge()
        keys, offsets, sizes = self._base
        for i in range(keys.size):
            sz = int(sizes[i])
            if not t.is_tombstone(sz):
                fn(NeedleValue(int(keys[i]), t.stored_to_offset(int(offsets[i])), sz))

    def items_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sorted live (keys, stored_offsets, sizes) — feeds the EC .ecx writer
        and device batch pipelines without per-entry Python overhead."""
        self._merge()
        keys, offsets, sizes = self._base
        live = ~np.equal(sizes, np.uint32(t.TOMBSTONE_SIZE))
        return keys[live], offsets[live], sizes[live]


class NeedleMap:
    """CompactMap + .idx append log + live-bytes accounting.

    Mirrors reference NeedleMap (needle_map_memory.go): every set/delete is
    appended to the .idx so the map can be rebuilt on restart.
    """

    def __init__(self, idx_path: str, kind: str = "memory"):
        self.idx_path = idx_path
        self.kind = kind
        self.map = make_map(kind, idx_path)
        self.file_counter = 0
        self.deleted_counter = 0
        self.data_size = 0          # bytes of live needle bodies
        self.deleted_size = 0
        self.max_key = 0
        self._idx = open(idx_path, "ab")
        if os.path.getsize(idx_path):
            # persistent kinds (sqlite) already hold the mapping and the
            # sorted_file kind was just built from the .idx — replay sets
            # only when the map is empty; counters always need the walk
            self._load(populate=(kind in ("", "memory")
                                 or len(self.map) == 0))

    def _load(self, populate: bool = True) -> None:
        for key, stored_off, size in walk_idx_file(self.idx_path):
            self.max_key = max(self.max_key, key)
            if t.is_tombstone(size):
                old = self.map.get(key) if populate else None
                if old is not None:
                    self.deleted_counter += 1
                    self.deleted_size += old.size
                if populate:
                    self.map.delete(key)
            else:
                old = self.map.get(key) if populate else None
                if old is not None:
                    self.deleted_counter += 1
                    self.deleted_size += old.size
                if populate:
                    self.map.set(key, stored_off, size)
                self.file_counter += 1
                self.data_size += size

    def put(self, key: int, actual_offset: int, size: int) -> None:
        old = self.map.get(key)
        if old is not None:
            # overwrite: the previous record becomes garbage (reference
            # needle_map_memory.go counts it toward deletion accounting)
            self.deleted_counter += 1
            self.deleted_size += old.size
        stored = t.offset_to_stored(actual_offset)
        self.map.set(key, stored, size)
        self.file_counter += 1
        self.data_size += size
        self.max_key = max(self.max_key, key)
        self._idx.write(_ENTRY.pack(key, stored, size & 0xFFFFFFFF))

    def put_many(self, entries: "list[tuple[int, int, int]]") -> None:
        """Batched put of (key, actual_offset, size) entries: identical
        accounting to N put() calls, but the .idx log grows by ONE write
        of all the packed entries — the bulk ingest path's needle-map
        update is one syscall per frame, not one per needle."""
        packed = bytearray()
        for key, actual_offset, size in entries:
            old = self.map.get(key)
            if old is not None:
                self.deleted_counter += 1
                self.deleted_size += old.size
            stored = t.offset_to_stored(actual_offset)
            self.map.set(key, stored, size)
            self.file_counter += 1
            self.data_size += size
            self.max_key = max(self.max_key, key)
            packed += _ENTRY.pack(key, stored, size & 0xFFFFFFFF)
        if packed:
            self._idx.write(bytes(packed))

    def delete(self, key: int) -> bool:
        old = self.map.get(key)
        if old is None:
            return False
        self.map.delete(key)
        self.deleted_counter += 1
        self.deleted_size += old.size
        self._idx.write(_ENTRY.pack(key, 0, t.TOMBSTONE_SIZE))
        return True

    def get(self, key: int) -> NeedleValue | None:
        return self.map.get(key)

    def flush(self) -> None:
        if self._idx.closed:
            return
        self._idx.flush()
        os.fsync(self._idx.fileno())

    def close(self) -> None:
        if self._idx.closed:
            return
        try:
            self.flush()
        finally:
            self._idx.close()

    @property
    def live_count(self) -> int:
        return self.file_counter - self.deleted_counter


def walk_idx_file(path: str) -> Iterator[tuple[int, int, int]]:
    """Yield (key, stored_offset, size) for every entry (reference idx/walk.go)."""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(t.IDX_ENTRY_SIZE * 4096)
            if not chunk:
                return
            usable = len(chunk) - len(chunk) % t.IDX_ENTRY_SIZE
            for i in range(0, usable, t.IDX_ENTRY_SIZE):
                yield _ENTRY.unpack_from(chunk, i)


def idx_entries_numpy(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized .idx read -> (keys u64, stored_offsets u32, sizes u32)."""
    raw = np.fromfile(path, dtype=np.uint8)
    usable = raw.size - raw.size % t.IDX_ENTRY_SIZE
    raw = raw[:usable].reshape(-1, t.IDX_ENTRY_SIZE)
    keys = raw[:, 0:8].copy().view("<u8").ravel()
    offs = raw[:, 8:12].copy().view("<u4").ravel()
    sizes = raw[:, 12:16].copy().view("<u4").ravel()
    return keys, offs, sizes


def write_idx_entries(path: str, keys, stored_offsets, sizes) -> None:
    arr = np.empty((len(keys), t.IDX_ENTRY_SIZE), dtype=np.uint8)
    arr[:, 0:8] = np.asarray(keys, dtype="<u8").reshape(-1, 1).view(np.uint8).reshape(-1, 8)
    arr[:, 8:12] = np.asarray(stored_offsets, dtype="<u4").reshape(-1, 1).view(np.uint8).reshape(-1, 4)
    arr[:, 12:16] = np.asarray(sizes, dtype="<u4").reshape(-1, 1).view(np.uint8).reshape(-1, 4)
    # plain open+write rather than ndarray.tofile, which bypasses the io
    # layer (the JAX package's crash-consistency shim hooks it there)
    with open(path, "wb") as f:
        f.write(arr.tobytes())


class SqliteMap:
    """Disk-backed needle map (the reference's LevelDB kind,
    needle_map_leveldb.go): O(1)-RAM lookups via a b-tree on disk. Same
    set/get/delete/items_arrays surface as CompactMap."""

    def __init__(self, db_path: str):
        import sqlite3

        self.db_path = db_path
        # autocommit: a long-held implicit write txn would lock out every
        # other connection (restart probes, tools) until close
        self._conn = sqlite3.connect(db_path, check_same_thread=False,
                                     isolation_level=None)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS needles ("
            "key INTEGER PRIMARY KEY, off INTEGER, size INTEGER)")
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM needles").fetchone()
        return n

    def set(self, key: int, stored_offset: int, size: int) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO needles VALUES (?, ?, ?)",
                (_signed64(key), stored_offset, size & 0xFFFFFFFF))

    def delete(self, key: int) -> bool:
        with self._lock:
            cur = self._conn.execute("DELETE FROM needles WHERE key = ?",
                                     (_signed64(key),))
        return cur.rowcount > 0

    def get(self, key: int) -> NeedleValue | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT off, size FROM needles WHERE key = ?",
                (_signed64(key),)).fetchone()
        if row is None or t.is_tombstone(row[1]):
            return None
        return NeedleValue(key, t.stored_to_offset(row[0]), row[1])

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, off, size FROM needles ORDER BY key").fetchall()
        for k, off, sz in rows:
            if not t.is_tombstone(sz):
                fn(NeedleValue(k & 0xFFFFFFFFFFFFFFFF,
                               t.stored_to_offset(off), sz))

    def items_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT key, off, size FROM needles ORDER BY key").fetchall()
        arr = np.array(rows, dtype=np.int64).reshape(-1, 3)
        keys = arr[:, 0].astype(np.int64).view(np.uint64)
        return (keys, arr[:, 1].astype(np.uint32),
                arr[:, 2].astype(np.uint32))

    def flush(self) -> None:
        with self._lock:
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.commit()
            self._conn.close()


def _signed64(key: int) -> int:
    """sqlite INTEGER is signed 64-bit; map u64 keys losslessly."""
    return key - (1 << 64) if key >= 1 << 63 else key


class SortedFileMap:
    """Read-mostly map (reference needle_map_sorted_file.go): the base set
    lives in a sorted on-disk sidecar binary-searched via mmap — near-zero
    RAM for sealed/readonly volumes — with a dict overlay for late writes."""

    def __init__(self, sdx_path: str):
        self.sdx_path = sdx_path
        self._overlay: dict[int, tuple[int, int]] = {}
        self._keys = np.empty(0, dtype=np.uint64)
        self._mm: "np.memmap | None" = None
        if os.path.exists(sdx_path) and os.path.getsize(sdx_path):
            self._open()

    def _open(self) -> None:
        self._mm = np.memmap(self.sdx_path, dtype=np.uint8, mode="r")
        n = self._mm.shape[0] // t.IDX_ENTRY_SIZE
        view = np.asarray(self._mm[:n * t.IDX_ENTRY_SIZE]).reshape(
            n, t.IDX_ENTRY_SIZE)
        # keys column copied for searchsorted; offsets/sizes read per hit
        self._keys = view[:, 0:8].copy().view("<u8").ravel()
        self._view = view

    @classmethod
    def build(cls, idx_path: str, sdx_path: str) -> "SortedFileMap":
        """Sort a .idx (append log, tombstones and all) into the sidecar
        (reference WriteSortedFileFromIdx shape)."""
        keys, offs, sizes = idx_entries_numpy(idx_path)
        order = np.argsort(keys, kind="stable")
        keys, offs, sizes = keys[order], offs[order], sizes[order]
        if keys.size:  # newest duplicate wins (append order preserved)
            last = np.ones(keys.size, dtype=bool)
            last[:-1] = keys[:-1] != keys[1:]
            keys, offs, sizes = keys[last], offs[last], sizes[last]
        live = ~np.equal(sizes, np.uint32(t.TOMBSTONE_SIZE))
        write_idx_entries(sdx_path, keys[live], offs[live], sizes[live])
        return cls(sdx_path)

    def __len__(self) -> int:
        return int(self._keys.size) + len(self._overlay)

    def set(self, key: int, stored_offset: int, size: int) -> None:
        self._overlay[key] = (stored_offset, size & 0xFFFFFFFF)

    def delete(self, key: int) -> bool:
        existed = self.get(key) is not None
        self._overlay[key] = (0, t.TOMBSTONE_SIZE)
        return existed

    def _base_get(self, key: int) -> "tuple[int, int] | None":
        if not self._keys.size:
            return None
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i < self._keys.size and int(self._keys[i]) == key:
            row = self._view[i]
            off = int(row[8:12].view("<u4")[0])
            sz = int(row[12:16].view("<u4")[0])
            return off, sz
        return None

    def get(self, key: int) -> NeedleValue | None:
        v = self._overlay.get(key)
        if v is None:
            v = self._base_get(key)
        if v is None or t.is_tombstone(v[1]):
            return None
        return NeedleValue(key, t.stored_to_offset(v[0]), v[1])

    def _merged(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self._keys.size and not self._overlay:
            z = np.empty(0, dtype=np.uint64)
            return z, z.astype(np.uint32), z.astype(np.uint32)
        base_off = self._view[:, 8:12].copy().view("<u4").ravel() \
            if self._keys.size else np.empty(0, dtype=np.uint32)
        base_sz = self._view[:, 12:16].copy().view("<u4").ravel() \
            if self._keys.size else np.empty(0, dtype=np.uint32)
        keys = np.concatenate([
            self._keys,
            np.fromiter(self._overlay.keys(), dtype=np.uint64,
                        count=len(self._overlay))])
        ov = (np.array(list(self._overlay.values()),
                       dtype=np.uint32).reshape(-1, 2)
              if self._overlay else np.empty((0, 2), dtype=np.uint32))
        offs = np.concatenate([base_off, ov[:, 0]])
        sizes = np.concatenate([base_sz, ov[:, 1]])
        order = np.argsort(keys, kind="stable")
        keys, offs, sizes = keys[order], offs[order], sizes[order]
        last = np.ones(keys.size, dtype=bool)
        last[:-1] = keys[:-1] != keys[1:]
        return keys[last], offs[last], sizes[last]

    def ascending_visit(self, fn: Callable[[NeedleValue], None]) -> None:
        keys, offs, sizes = self._merged()
        for i in range(keys.size):
            sz = int(sizes[i])
            if not t.is_tombstone(sz):
                fn(NeedleValue(int(keys[i]),
                               t.stored_to_offset(int(offs[i])), sz))

    def items_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        keys, offs, sizes = self._merged()
        live = ~np.equal(sizes, np.uint32(t.TOMBSTONE_SIZE))
        return keys[live], offs[live], sizes[live]

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._mm = None


def make_map(kind: str, idx_path: str):
    """Needle-map factory (the reference's -index flag:
    memory | leveldb | sorted_file; needle_map.go kinds)."""
    if kind in ("", "memory"):
        return CompactMap()
    if kind in ("leveldb", "sqlite"):
        return SqliteMap(idx_path[:-4] + ".ldb")
    if kind in ("sorted_file", "sortedfile"):
        base = idx_path[:-4] + ".sdx"
        if os.path.exists(idx_path) and os.path.getsize(idx_path):
            return SortedFileMap.build(idx_path, base)
        return SortedFileMap(base)
    raise ValueError(f"unknown needle map kind {kind!r}")
