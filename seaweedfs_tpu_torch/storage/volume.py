"""Volume: one append-only .dat file + its .idx needle index.

The port's copy of the JAX package's storage/volume.py: write, bulk write,
delete, read (lock-free seqlock path and locked fallback), load-time
integrity check, the tail / incremental-copy readers (offset_by_append_ns,
read_records_since, append_records), sync, close and destroy. A tiered
volume (its .vif names a remote tier, reference volume_tier.go) opens
read-only: with no local .dat its reads go through storage/backend's
RemoteDatFile under the volume lock.

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
        # append offset when vacuum.compact snapshotted the live set; the
        # commit replays what landed after it (vacuum._makeup_diff)
        self.last_compact_offset: int | None = None

        base = self.file_name()
        self.dat_path = base + ".dat"
        self.idx_path = base + ".idx"
        self.vif_path = base + ".vif"
        # Tiered volume: the sealed .dat lives in a remote backend
        # (reference volume_tier.go; the .vif carries the remote location)
        self.remote_spec: dict | None = None
        if not os.path.exists(self.dat_path):
            vif = self._read_vif()
            if "remote" in vif:
                self._open_remote(vif["remote"])
                return
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
        # a volume tiered with keep_local serves reads from the local .dat
        # but stays read-only: writes would silently diverge from the
        # remote copy
        vif = self._read_vif()
        if "remote" in vif:
            self.remote_spec = vif["remote"]
            self.read_only = True

    def _read_vif(self) -> dict:
        from ..ec import files as ec_files
        return ec_files.read_vif(self.vif_path)

    def _open_remote(self, remote: dict) -> None:
        """Open a tiered (remote .dat) volume read-only."""
        from .backend import RemoteDatFile, open_remote
        client = open_remote(remote["spec"])
        self.remote_spec = remote
        self._dat = RemoteDatFile(client, remote["key"], remote.get("size"))
        self._dat.seek(0)
        self.super_block = SuperBlock.from_bytes(
            self._dat.read(SUPER_BLOCK_SIZE))
        self.nm = NeedleMap(self.idx_path, self._nm_kind)
        self.read_only = True
        self._append_offset = self._dat.size
        self._commit_offset = self._append_offset

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
                starts = t.stored_to_offset(offs[live].astype("int64"))
                # resume the record walk after the highest entry whose
                # WHOLE record fits the .dat. A torn BULK frame can
                # leave many indexed entries past EOF (the batched .idx
                # append landed, the .dat write tore mid-frame), so
                # anchoring on the max offset alone would skip the
                # truncation repair entirely.
                ends = starts + t.actual_record_size(
                    sizes[live].astype("int64"))
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

    # -- tail / incremental sync (reference volume_grpc_tail.go,
    #    volume_grpc_copy_incremental.go) ----------------------------------
    def record_append_ns(self, offset: int, nsize: int) -> int:
        """append_at_ns from a record's trailer (crc u32 then ts u64,
        needle.py layout)."""
        import struct
        body = 0 if t.is_tombstone(nsize) else nsize
        raw = self.read_raw(offset + t.NEEDLE_HEADER_SIZE + body + 4, 8)
        return struct.unpack("<Q", raw)[0]

    def _probe_entries(self, end: int):
        """.idx entries usable as timestamp probes: live, whole, within
        `end` (a torn-tail repair truncates the .dat but leaves the original
        live entries in the raw .idx — filter those out)."""
        if not os.path.exists(self.idx_path):
            return []
        import numpy as np
        _keys, offs, sizes = idx_entries_numpy(self.idx_path)
        # record_size_from_header over the whole .idx at once: a tail or
        # incremental copy of a million-needle volume probes it per pass
        body = np.where(sizes == t.TOMBSTONE_SIZE, 0, sizes).astype(np.int64)
        off = t.stored_to_offset(offs.astype(np.int64))
        ok = (offs > 0) & (off + t.actual_record_size(body) <= end)
        return list(zip(off[ok].tolist(), sizes[ok].tolist()))

    def offset_by_append_ns(self, since_ns: int) -> int:
        """First .dat offset whose record has append_at_ns > since_ns.

        Binary search over the append-ordered .idx probing timestamps from
        the .dat (reference BinarySearchByAppendAtNs), then a short linear
        walk so tombstone records (absent from probe entries) are included.
        Requires the .dat to be append-time-ordered: vacuum preserves that
        (compact copies in offset order) and a compaction-revision bump
        tells cross-revision followers to resync in full.
        Returns self._append_offset when fully caught up.
        """
        with self._lock:
            self.sync()
            end = self._append_offset
            probes = self._probe_entries(end)
            lo, hi = 0, len(probes)  # first probe with ts > since_ns
            while lo < hi:
                mid = (lo + hi) // 2
                off, nsize = probes[mid]
                if self.record_append_ns(off, nsize) > since_ns:
                    hi = mid
                else:
                    lo = mid + 1
            if lo == 0:
                start = SUPER_BLOCK_SIZE
            else:
                off, nsize = probes[lo - 1]  # last record at-or-before
                start = off + record_size_from_header(nsize)
            # walk (possibly tombstone) records until ts > since_ns
            for off, _nid, nsize in iter_records(self._dat, start, end):
                if self.record_append_ns(off, nsize) > since_ns:
                    return off
            return end

    def last_record_append_ns(self) -> int:
        """append_at_ns of the newest record (0 for an empty volume):
        jump to the newest .idx probe, walk the short tail."""
        with self._lock:
            self.sync()
            end = self._append_offset
            probes = self._probe_entries(end)
            start = max((off for off, _ in probes), default=SUPER_BLOCK_SIZE)
            last = 0
            for off, _nid, nsize in iter_records(self._dat, start, end):
                last = self.record_append_ns(off, nsize)
            return last

    def read_records_since(self, since_ns: int, max_batch: int = 2 << 20):
        """Yield (record_bytes, append_at_ns, nsize) for records newer than
        since_ns, in append order (tail sender body). Records are collected
        in <= max_batch byte batches under the volume lock and yielded
        outside it, so a slow stream consumer never blocks writers."""
        pos = self.offset_by_append_ns(since_ns)
        while True:
            batch = []
            with self._lock:
                self.sync()
                end = self._append_offset
                if pos >= end:
                    return
                got = 0
                for off, _nid, nsize in iter_records(self._dat, pos, end):
                    rec_len = record_size_from_header(nsize)
                    self._dat.seek(off)
                    rec = self._dat.read(rec_len)
                    batch.append((rec, self.record_append_ns(off, nsize),
                                  nsize))
                    pos = off + rec_len
                    got += rec_len
                    if got >= max_batch:
                        break
            yield from batch

    def append_records(self, raw: bytes) -> int:
        """Append raw record bytes (from tail/incremental copy) and replay
        them into the needle map. Returns records applied."""
        import struct
        touched: "list[int]" = []
        with self._lock:
            if self.read_only:
                raise PermissionError(f"volume {self.id} is read-only")
            start = self._append_offset
            if start + len(raw) > t.MAX_VOLUME_SIZE:
                raise OSError(f"volume {self.id} exceeds max size")
            self._dat.seek(start)
            self._dat.write(raw)
            self._append_offset = start + len(raw)
            # flush before any index replay publishes the new records
            # (seqlock read path); the torn-tail branch re-anchors the
            # watermark after its truncate
            self._dat.flush()
            self._commit_offset = self._append_offset
            applied = 0
            pos = 0
            while pos + t.NEEDLE_HEADER_SIZE <= len(raw):
                _, nid, nsize = struct.unpack_from("<IQI", raw, pos)
                rec_len = record_size_from_header(nsize)
                if pos + rec_len > len(raw):
                    # torn tail: truncate back to the last whole record
                    self._append_offset = start + pos
                    self._dat.seek(self._append_offset)
                    self._dat.truncate()
                    self._commit_offset = self._append_offset
                    break
                if t.is_tombstone(nsize):
                    self.nm.delete(nid)
                else:
                    self.nm.put(nid, start + pos, nsize)
                    ts = struct.unpack_from(
                        "<Q", raw, pos + t.NEEDLE_HEADER_SIZE + nsize + 4)[0]
                    self.last_append_at_ns = ts
                touched.append(nid)
                pos += rec_len
                applied += 1
        # tail replay mutates through the chokepoint (batched)
        read_cache.invalidate_keys(self.id, touched)
        return applied

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
                if self.remote_spec is None:
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
                if self.remote_spec is None:
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
        volume mapping. A tiered volume has no fd (`_fileno`): its reads
        take the locked path through the RemoteDatFile."""
        if self.remote_spec is None and not self._closed:
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
        locked fallback only fires on a racing close or a tiered volume).
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
            if self.remote_spec is None:
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
        if self.remote_spec is not None:
            # best-effort: replicas may share the remote key, so a failure
            # here only leaks an orphan object
            try:
                from .backend import open_remote
                open_remote(self.remote_spec["spec"]).delete_object(
                    self.remote_spec["key"])
            except Exception as e:  # noqa: BLE001 — an orphan object, not data
                log.warning("delete remote copy of volume %d: %s",
                            self.id, e)
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
