"""Vacuum (compaction): reclaim space from deleted needles, writes allowed.

Port of seaweedfs_tpu/storage/vacuum.py. Reference:
weed/storage/volume_vacuum.go — `Compact2` copies live needles into
.cpd/.cpx siblings guided by the index (copyDataBasedOnIndexFile :418), then
`CommitCompact` (:102) replays whatever was appended to the live volume while
the copy ran (`makeupDiff` :200-418: scan the old .dat past the offset
recorded at compact start, append new writes to the .cpd and their entries to
the .cpx, record deletes as tombstone index entries) and atomically renames
the siblings over the originals, bumping the super block's compaction
revision.

`compact()` snapshots the append offset + live needle set under the volume
lock, then copies without the lock (appends only ever extend the .dat, so
concurrent writes and deletes land past the snapshot and are replayed by
`commit_compact`, which holds the lock only for the replay + rename window).
The commit drops the volume's read-cache entries: every live needle moved.

A tiered volume (remote .dat) is never compacted; the caller (the volume
server's vacuum RPCs) refuses it before calling in.
"""

from __future__ import annotations

import os

import numpy as np

from . import types as t
from .needle import record_size_from_header
from .needle_map import _ENTRY, write_idx_entries
from .super_block import SUPER_BLOCK_SIZE, SuperBlock
from .volume import Volume, iter_records
from ..utils import fsutil


def compact(vol: Volume) -> tuple[int, int]:
    """Copy live needles to .cpd/.cpx. Returns (live_count, reclaimed_bytes).

    Safe under concurrent writes: the live-set + append-offset snapshot is
    taken atomically; anything appended afterwards is replayed at commit.
    """
    base = vol.file_name()
    cpd, cpx = base + ".cpd", base + ".cpx"
    with vol._lock:
        vol.sync()
        vol.last_compact_offset = vol._append_offset
        keys, offs, sizes = vol.nm.map.items_arrays()
    # copy in offset (= append-time) order, not key order: tail/incremental
    # sync binary-searches the .dat by append_at_ns and needs monotonicity
    # (reference copyDataBasedOnIndexFile walks the .idx in file order)
    order = np.argsort(offs, kind="stable")
    keys, offs, sizes = keys[order], offs[order], sizes[order]
    sb = SuperBlock(
        version=vol.super_block.version,
        replica_placement=vol.super_block.replica_placement,
        ttl=vol.super_block.ttl,
        compaction_revision=(vol.super_block.compaction_revision + 1) & 0xFFFF,
    )
    new_offs = np.zeros_like(offs)
    with open(cpd, "wb") as out:
        out.write(sb.to_bytes())
        pos = SUPER_BLOCK_SIZE
        for i in range(keys.size):
            src_off = t.stored_to_offset(int(offs[i]))
            rec_len = record_size_from_header(int(sizes[i]))
            rec = vol.read_raw(src_off, rec_len)
            out.write(rec)
            new_offs[i] = t.offset_to_stored(pos)
            pos += rec_len
    write_idx_entries(cpx, keys, new_offs, sizes)
    reclaimed = vol.content_size - pos
    return int(keys.size), int(reclaimed)


def _makeup_diff(vol: Volume, cpd: str, cpx: str) -> int:
    """Replay appends/deletes that raced the copy onto .cpd/.cpx.

    Caller holds vol._lock. Returns the number of replayed records.
    Reference: volume_vacuum.go:200 makeupDiff.
    """
    from_off = vol.last_compact_offset
    if from_off is None:
        return 0
    end = vol._append_offset
    if from_off >= end:
        return 0
    replayed = 0
    with open(cpd, "ab") as out, open(cpx, "ab") as idx:
        pos = out.tell()
        for off, nid, nsize in iter_records(vol._dat, from_off, end):
            rec_len = record_size_from_header(nsize)
            out.write(vol.read_raw(off, rec_len))
            if t.is_tombstone(nsize):
                # delete: the tombstone record keeps the .dat
                # self-describing, the tombstone idx entry overrides any
                # earlier live entry
                idx.write(_ENTRY.pack(nid, 0, t.TOMBSTONE_SIZE))
            else:
                idx.write(_ENTRY.pack(nid, t.offset_to_stored(pos), nsize))
            pos += rec_len
            replayed += 1
    return replayed


def commit_compact(vol: Volume) -> Volume:
    """Replay concurrent changes, swap .cpd/.cpx into place, reopen."""
    base = vol.file_name()
    cpd, cpx = base + ".cpd", base + ".cpx"
    if not (os.path.exists(cpd) and os.path.exists(cpx)):
        raise FileNotFoundError("no compaction files; run compact() first")
    dirname, collection, vid = vol.dir, vol.collection, vol.id
    with vol._lock:
        vol.sync()
        _makeup_diff(vol, cpd, cpx)
        vol.close()
        os.replace(cpd, base + ".dat")
        os.replace(cpx, base + ".idx")
        # the compacted files replace the live volume: a crash before the
        # directory entries hit disk would resurrect the pre-compaction
        # .dat/.idx (stale offsets for every replayed needle)
        fsutil.fsync_dir(base + ".dat")
    # every live needle moved to a new offset: the whole volume's cached
    # entries are stale (close() already invalidated; this covers the swap
    # explicitly so the coherence story reads at the chokepoint)
    from .read_cache import invalidate_volume
    invalidate_volume(vid)
    return Volume(dirname, collection, vid, create_if_missing=False)
