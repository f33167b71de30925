"""Volume: one append-only .dat file + its .idx needle index.

The port's copy of the JAX package's storage/volume.py for a LOCAL .dat:
write, bulk write, delete, read (lock-free seqlock path and locked
fallback), load-time integrity check, sync, close and destroy. A volume
whose .vif names a remote tier raises NotImplementedError: tiered volumes
(storage/backend.py) are not yet ported. The tail / incremental-copy
readers (offset_by_append_ns, read_records_since, append_records) come
with the volume server.

Reference equivalents: weed/storage/volume.go, volume_write.go:111-180,
volume_read.go, volume_loading.go, volume_checking.go:17
(CheckAndFixVolumeDataIntegrity: validate the last idx entry against the .dat,
truncate torn tails).
"""

from __future__ import annotations

import os
import threading

from . import types as t
from . import read_cache
from ..utils import failpoints
from ..utils.log import logger
from .needle import Needle, record_size_from_header
from .needle_map import NeedleMap, idx_entries_numpy
from .super_block import SUPER_BLOCK_SIZE, SuperBlock

log = logger("volume")


class VolumeClosedError(OSError):
    """A lock-free read raced this volume's close (vacuum commit swap,
    unmount). The volume OBJECT is dead but the volume usually is not —
    the store retries once through its fresh mapping."""


def iter_records(f, start: int, end: int):
    """Walk whole needle records in [start, end): yields
    (offset, needle_id, header_size). Stops at the first torn/partial record.
    Single source of truth for the on-disk record walk (used by load-time
    integrity check and by idx-rebuild repair)."""
    import struct

    pos = start
    while pos + t.NEEDLE_HEADER_SIZE <= end:
        f.seek(pos)
        hdr = f.read(t.NEEDLE_HEADER_SIZE)
        if len(hdr) < t.NEEDLE_HEADER_SIZE:
            return
        _, nid, nsize = struct.unpack("<IQI", hdr)
        rec = record_size_from_header(nsize)
        if pos + rec > end:
            return
        yield pos, nid, nsize
        pos += rec


def rebuild_idx_from_dat(dat_path: str, idx_path: str) -> int:
    """Rebuild a .idx by scanning needle headers in the .dat
    (reference command/fix.go:74). Returns entry count."""
    from .needle_map import write_idx_entries

    size = os.path.getsize(dat_path)
    keys, offs, sizes = [], [], []
    with open(dat_path, "rb") as f:
        for pos, nid, nsize in iter_records(f, SUPER_BLOCK_SIZE, size):
            keys.append(nid)
            offs.append(pos // t.NEEDLE_PADDING if nsize != t.TOMBSTONE_SIZE else 0)
            sizes.append(nsize)
    write_idx_entries(idx_path, keys, offs, sizes)
    return len(keys)


class Volume:
    def __init__(self, dirname: str, collection: str, vid: int,
                 needle_map_kind: str = "memory",
                 replica_placement: t.ReplicaPlacement | None = None,
                 ttl: t.TTL | None = None,
                 create_if_missing: bool = True):
        self.dir = dirname
        self.collection = collection
        self.id = vid
        self.read_only = False
        self.last_append_at_ns = 0
        self._nm_kind = needle_map_kind
        self._lock = threading.RLock()
        # seqlock read-path state: reads pread() the .dat WITHOUT the
        # volume lock, validating against the commit watermark (bytes
        # flushed to the OS before their index entries published) and
        # the closed flag (set BEFORE the fd is released, so a reused
        # fd number can never masquerade as this volume's data)
        self._closed = False
        self._fileno = -1
        self._commit_offset = SUPER_BLOCK_SIZE

        base = self.file_name()
        self.dat_path = base + ".dat"
        self.idx_path = base + ".idx"
        self.vif_path = base + ".vif"
        # Tiered volume: the .vif carries a remote location (reference
        # volume_tier.go). Refused whole, never opened as a local volume.
        if "remote" in self._read_vif():
            raise NotImplementedError(
                f"volume {vid}: tiered (remote .dat) volumes are not yet "
                f"ported to seaweedfs_tpu_torch")
        exists = os.path.exists(self.dat_path)
        if not exists and not create_if_missing:
            raise FileNotFoundError(self.dat_path)
        if not exists:
            self.super_block = SuperBlock(
                replica_placement=replica_placement or t.ReplicaPlacement(),
                ttl=ttl or t.TTL())
            with open(self.dat_path, "wb") as f:
                f.write(self.super_block.to_bytes())
        self._dat = open(self.dat_path, "r+b")
        self._fileno = self._dat.fileno()
        self.super_block = SuperBlock.from_bytes(self._dat.read(SUPER_BLOCK_SIZE))
        self.nm = NeedleMap(self.idx_path, needle_map_kind)
        self._check_integrity()

    def _read_vif(self) -> dict:
        from ..ec import files as ec_files
        return ec_files.read_vif(self.vif_path)

    # -- naming ------------------------------------------------------------
    def file_name(self) -> str:
        return self.path_for(self.dir, self.collection, self.id)

    @staticmethod
    def path_for(dirname: str, collection: str, vid: int) -> str:
        name = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(dirname, name)

    # -- integrity (reference volume_checking.go:17) -----------------------
    def _check_integrity(self) -> None:
        """Find the end of the last whole record; truncate any torn tail.

        Starts from the highest offset the .idx knows about (cheap), then
        walks record headers forward — the same repair the reference does at
        load (volume_checking.go:17), generalized to also cover appended
        tombstones whose idx entries carry no offset.
        """
        dat_size = os.path.getsize(self.dat_path)
        start = SUPER_BLOCK_SIZE
        if os.path.getsize(self.idx_path):
            _, offs, sizes = idx_entries_numpy(self.idx_path)
            live = sizes != t.TOMBSTONE_SIZE
            if live.any():
                starts = offs[live].astype("int64") * t.NEEDLE_PADDING
                # resume the record walk after the highest entry whose
                # WHOLE record fits the .dat. A torn BULK frame can
                # leave many indexed entries past EOF (the batched .idx
                # append landed, the .dat write tore mid-frame), so
                # anchoring on the max offset alone would skip the
                # truncation repair entirely.
                raw = (t.NEEDLE_HEADER_SIZE + t.NEEDLE_CHECKSUM_SIZE
                       + t.TIMESTAMP_SIZE + sizes[live].astype("int64"))
                pad = (-raw) % t.NEEDLE_PADDING
                ends = starts + raw + pad
                fits = ends <= dat_size
                if fits.any():
                    start = int(ends[fits].max())
        end = self._scan_forward(start, dat_size)
        if end < dat_size:
            self._dat.truncate(end)
        # drop idx entries pointing at or past the valid end — even when
        # nothing was truncated: a crash can persist the .idx append while
        # the .dat append is lost entirely (end == dat_size), and a stale
        # entry at EOF would serve garbage reads instead of not-found
        for key in list(self._keys_past(end)):
            self.nm.delete(key)
        self._append_offset = max(end, SUPER_BLOCK_SIZE)
        self._commit_offset = self._append_offset

    def _keys_past(self, end: int):
        keys, offs, sizes = self.nm.map.items_arrays()
        for i in range(keys.size):
            if t.stored_to_offset(int(offs[i])) >= end:
                yield int(keys[i])

    def _scan_forward(self, start: int, dat_size: int) -> int:
        """Walk records from `start`; return the end of the last whole record."""
        pos = start
        for off, _, nsize in iter_records(self._dat, start, dat_size):
            pos = off + record_size_from_header(nsize)
        return pos

    # -- write path (reference volume_write.go:119 writeNeedle2) -----------
    def write_needle(self, n: Needle, sync: bool = False) -> int:
        """`sync=True` is the durable single-needle write (the upload's
        ?fsync=true param, fed by a filer path rule's fsync flag): the
        ack stands on an fsync, like every bulk-frame ack."""
        with self._lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read-only")
            rec = n.to_bytes()
            off = self._append_offset
            if off + len(rec) > t.MAX_VOLUME_SIZE:
                raise OSError(f"volume {self.id} exceeds max size")
            self._dat.seek(off)
            # failpoint: persist only a prefix while the in-memory state
            # believes the full record landed — a crash mid-write; the
            # reopen-time _check_integrity heal is driven by this
            self._dat.write(failpoints.torn("volume.write.torn", rec))
            self._append_offset = off + len(rec)
            # publish order (seqlock read path): bytes reach the OS
            # BEFORE the index entry appears and the commit watermark
            # advances — a lock-free pread that resolved this key is
            # guaranteed to see the record, not the write buffer's hole
            self._dat.flush()
            self._commit_offset = self._append_offset
            self.nm.put(n.id, off, self._body_size(rec))
            self.last_append_at_ns = n.append_at_ns
            if sync:
                os.fsync(self._dat.fileno())
                self.nm.flush()
        read_cache.invalidate(self.id, n.id)  # overwrite coherence
        return off

    def write_needles(self, needles: "list[Needle]",
                      sync: bool = True) -> "list[int]":
        """Append a whole bulk frame under ONE lock acquisition: all
        records concatenated into a single .dat write, the needle map
        updated with one batched .idx append, and (by default) one
        fsync covering every needle — the per-frame durability point
        the bulk-PUT ack stands on. Returns each needle's offset.

        All-or-nothing admission: sizes are checked before any byte
        lands, so a frame that would overflow the volume leaves it
        untouched (the master's size accounting rolls the volume over
        on the next heartbeat, same as the single-needle path)."""
        if not needles:
            return []
        with self._lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read-only")
            recs = []
            offs = []
            off = self._append_offset
            for n in needles:
                rec = n.to_bytes()
                offs.append(off)
                recs.append(rec)
                off += len(rec)
            if off > t.MAX_VOLUME_SIZE:
                raise OSError(f"volume {self.id} exceeds max size")
            buf = b"".join(recs)
            self._dat.seek(self._append_offset)
            # same torn-write failpoint as the single path: a crash can
            # tear the frame mid-record; _check_integrity truncates back
            # to the last whole record on reopen
            self._dat.write(failpoints.torn("volume.write.torn", buf))
            self._append_offset = off
            # flush BEFORE the batched index publish (seqlock read
            # path), then fsync for the frame's durability ack
            self._dat.flush()
            self._commit_offset = self._append_offset
            self.nm.put_many([(n.id, o, self._body_size(rec))
                              for n, o, rec in zip(needles, offs, recs)])
            self.last_append_at_ns = needles[-1].append_at_ns
            if sync:
                os.fsync(self._dat.fileno())
                self.nm.flush()
        # bulk-frame appends share the one chokepoint, batched: one
        # epoch bump + one lock pass instead of 2N on the ingest ack
        read_cache.invalidate_keys(self.id, [n.id for n in needles])
        return offs

    @staticmethod
    def _body_size(rec: bytes) -> int:
        import struct
        _, _, size = struct.unpack_from("<IQI", rec, 0)
        return size

    def delete_needle(self, needle_id: int, cookie: int = 0) -> bool:
        with self._lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read-only")
            if self.nm.get(needle_id) is None:
                return False
            rec = Needle.tombstone(needle_id, cookie)
            self._dat.seek(self._append_offset)
            self._dat.write(rec)
            self._append_offset += len(rec)
            deleted = self.nm.delete(needle_id)
        # after the map hides the needle: a racing fill that read the
        # live bytes snapshotted a pre-bump epoch and gets rejected
        read_cache.invalidate(self.id, needle_id)
        return deleted

    # -- read path (reference volume_read.go; lock-free — see below) -------
    def read_needle(self, needle_id: int, cookie: int | None = None,
                    verify_crc: bool = True) -> Needle:
        buf = self._read_record(needle_id)
        n = Needle.from_bytes(buf, verify_crc=verify_crc)
        if n.id != needle_id:
            raise ValueError(f"needle id mismatch for {needle_id:x} "
                             f"in volume {self.id}")
        if cookie is not None and n.cookie != cookie:
            raise PermissionError(f"cookie mismatch for needle {needle_id:x}")
        return n

    def _read_record(self, needle_id: int) -> bytes:
        """One needle record's bytes, seqlock-style: index snapshot ->
        pread -> post-read validation. Concurrent GETs never queue
        behind a writer's fsync.

        Safety argument: the .dat is append-only between compactions —
        a record's bytes at a published (offset, size) are immutable
        for this Volume object's lifetime (overwrites append NEW
        records; deletes append tombstones; compaction swaps in a NEW
        Volume). The index publishes an entry only AFTER its bytes were
        flushed to the OS (write_needle/write_needles ordering), so a
        pread of a resolved entry under the commit watermark always
        finds whole bytes. The only hazard left is the fd dying under
        us (vacuum commit / unmount closes this object): `_closed` is
        set BEFORE the fd is released, so checking it AFTER the pread
        proves the fd was ours for the read's whole duration — a reused
        fd number can never leak another file's bytes past validation.
        Any validation failure falls back to the locked path, which
        raises VolumeClosedError for the store to retry on its fresh
        volume mapping."""
        if not self._closed:
            nv = self.nm.get(needle_id)  # index snapshot (GIL-atomic)
            if nv is None:
                raise KeyError(f"needle {needle_id:x} not found in "
                               f"volume {self.id}")
            rec_len = record_size_from_header(nv.size)
            if nv.offset + rec_len <= self._commit_offset:
                try:
                    buf = os.pread(self._fileno, rec_len, nv.offset)
                except OSError:
                    buf = b""  # racing close: take the locked path
                if len(buf) == rec_len and not self._closed:
                    return buf
        with self._lock:
            if self._closed or self._dat.closed:
                raise VolumeClosedError(
                    f"volume {self.id} closed mid-read")
            nv = self.nm.get(needle_id)
            if nv is None:
                raise KeyError(f"needle {needle_id:x} not found in "
                               f"volume {self.id}")
            rec_len = record_size_from_header(nv.size)
            self._dat.seek(nv.offset)
            return self._dat.read(rec_len)

    def read_needles(self, pairs: "list[tuple[int, int | None]]",
                     verify_crc: bool = True,
                     byte_budget: "int | None" = None,
                     ) -> "list[tuple[int, Needle | None]]":
        """Bulk-GET storage path: resolve and read a whole batch of
        (key, cookie) pairs through the lock-free read protocol — one
        index pass, zero volume-lock acquisitions on the fast path (the
        locked fallback only fires on a racing close).
        Returns [(status, needle)] aligned with `pairs`; statuses are
        storage/bulk.py's READ_OK / READ_NOT_FOUND / READ_ERROR /
        READ_OVERFLOW. `byte_budget` bounds the bytes MATERIALIZED for
        one response frame: once served payloads exceed it, remaining
        found needles come back READ_OVERFLOW without being read at all
        (the client re-fetches those per-needle) — a frame of large
        needles must not allocate gigabytes server-side.
        VolumeClosedError propagates whole — the store retries the
        batch against its fresh volume mapping."""
        from .bulk import (READ_ERROR, READ_NOT_FOUND, READ_OK,
                           READ_OVERFLOW)
        out: "list[tuple[int, Needle | None]]" = []
        used = 0
        for key, cookie in pairs:
            if byte_budget is not None and used >= byte_budget:
                # still resolve: a miss must report NOT_FOUND, not ask
                # the client to chase a needle that does not exist
                out.append((READ_NOT_FOUND if self.nm.get(key) is None
                            else READ_OVERFLOW, None))
                continue
            try:
                n = self.read_needle(key, cookie=cookie,
                                     verify_crc=verify_crc)
                used += len(n.data)
                out.append((READ_OK, n))
            except KeyError:
                out.append((READ_NOT_FOUND, None))
            except VolumeClosedError:
                raise
            except (PermissionError, ValueError, OSError) as e:
                log.debug("bulk read %d/%x: %s", self.id, key, e)
                out.append((READ_ERROR, None))
        return out

    def read_raw(self, offset: int, length: int) -> bytes:
        with self._lock:
            self._dat.seek(offset)
            return self._dat.read(length)

    # -- stats -------------------------------------------------------------
    @property
    def content_size(self) -> int:
        return self._append_offset

    @property
    def file_count(self) -> int:
        return self.nm.live_count

    @property
    def deleted_count(self) -> int:
        return self.nm.deleted_counter

    def garbage_ratio(self) -> float:
        used = self._append_offset - SUPER_BLOCK_SIZE
        if used <= 0:
            return 0.0
        return self.nm.deleted_size / max(used, 1)

    def sync(self) -> None:
        with self._lock:
            self._dat.flush()
            self._commit_offset = self._append_offset
            os.fsync(self._dat.fileno())
            self.nm.flush()

    def close(self) -> None:
        with self._lock:
            if self._dat.closed:
                return
            # order matters for the lock-free readers: the closed flag
            # must be visible BEFORE the fd is released (their post-read
            # validation checks it after pread)
            self._closed = True
            try:
                self._dat.flush()
            finally:
                self._dat.close()
                self.nm.close()
        read_cache.invalidate_volume(self.id)

    def destroy(self) -> None:
        self.close()
        # the .vif is shared with an EC conversion of this volume: after
        # VolumeEcShardsGenerate it carries the stripe's codec + geometry
        # and belongs to the shard set, so deleting the source volume
        # must leave it (rebuild decodes with the codec that encoded)
        from ..ec import files as ec_files
        base = self.file_name()
        vif = self._read_vif()
        n = (vif.get("d") or 0) + (vif.get("p") or 0)
        has_ec = (os.path.exists(base + ".ecx")
                  or any(os.path.exists(base + ec_files.shard_ext(i))
                         for i in range(max(32, n))))
        exts = (".dat", ".idx") if has_ec else (".dat", ".idx", ".vif")
        for ext in exts:
            p = base + ext
            if os.path.exists(p):
                os.remove(p)
