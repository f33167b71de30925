"""EC sidecar files: .ecx (sorted index), .ecj (delete journal), .vif (info).

Reference: weed/storage/erasure_coding/ec_encoder.go:27
(`WriteSortedFileFromIdx`), ec_decoder.go:18/:121 (.ecx+.ecj -> .idx),
ec_volume.go:47 (.vif carries version + fork's DestroyTime, and the remote
tier's `remote` / `remote_shards` mappings). The .vif is JSON
rather than a VolumeInfo protobuf — same fields, human-debuggable — and its
bytes are the same as the JAX package's for the same volume, so either
package rebuilds and decodes what the other encoded.
"""

from __future__ import annotations

import json
import os
import struct
import threading

import numpy as np

from ..storage import types as t
from ..storage.needle_map import idx_entries_numpy, write_idx_entries
from ..utils.fsutil import fsync_dir


def shard_ext(i: int) -> str:
    """'.ec00' ... (reference ec_encoder.go:65 ToExt)."""
    return f".ec{i:02d}"


def write_ecx_from_idx(idx_path: str, ecx_path: str) -> int:
    """Sort the .idx's final state by key and write it as .ecx.

    Deleted keys keep a tombstone entry (size 0xFFFFFFFF) so lookups can
    distinguish 'deleted' from 'never existed', matching the reference's
    memdb-then-sort approach. Returns entry count.
    """
    keys, offs, sizes = idx_entries_numpy(idx_path)
    if keys.size == 0:
        write_idx_entries(ecx_path, [], [], [])
        return 0
    # last write per key wins
    order = np.argsort(keys, kind="stable")
    keys, offs, sizes = keys[order], offs[order], sizes[order]
    last = np.ones(keys.size, dtype=bool)
    last[:-1] = keys[:-1] != keys[1:]
    keys, offs, sizes = keys[last], offs[last], sizes[last]
    write_idx_entries(ecx_path, keys, offs, sizes)
    return int(keys.size)


def _find_ecx(f, count: int, needle_id: int) -> "tuple[int, int, int] | None":
    """Binary search an open .ecx -> (entry index, stored offset, size)."""
    lo, hi = 0, count - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        f.seek(mid * t.IDX_ENTRY_SIZE)
        key, off, sz = struct.unpack("<QII", f.read(t.IDX_ENTRY_SIZE))
        if key == needle_id:
            return mid, off, sz
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid - 1
    return None


def search_ecx(ecx_path: str, needle_id: int) -> tuple[int, int] | None:
    """Binary-search one key -> (actual_offset, size) or None.

    Reference ec_volume.go:321 SearchNeedleFromSortedIndex — file-backed
    binary search, O(log n) 16-byte reads.
    """
    count = os.path.getsize(ecx_path) // t.IDX_ENTRY_SIZE
    with open(ecx_path, "rb") as f:
        hit = _find_ecx(f, count, needle_id)
    if hit is None or t.is_tombstone(hit[2]):
        return None
    return t.stored_to_offset(hit[1]), hit[2]


def mark_deleted_in_ecx(ecx_path: str, needle_id: int) -> bool:
    """Flip the entry's size to tombstone in place (reference ec_decoder-style
    update during VolumeEcBlobDelete)."""
    count = os.path.getsize(ecx_path) // t.IDX_ENTRY_SIZE
    with open(ecx_path, "r+b") as f:
        hit = _find_ecx(f, count, needle_id)
        if hit is None:
            return False
        f.seek(hit[0] * t.IDX_ENTRY_SIZE)
        f.write(struct.pack("<QII", needle_id, hit[1], t.TOMBSTONE_SIZE))
    return True


def append_ecj(ecj_path: str, needle_id: int) -> None:
    with open(ecj_path, "ab") as f:
        f.write(struct.pack("<Q", needle_id))


def read_ecj(ecj_path: str) -> list[int]:
    if not os.path.exists(ecj_path):
        return []
    raw = np.fromfile(ecj_path, dtype="<u8")
    return [int(x) for x in raw]


def write_idx_from_ecx(ecx_path: str, ecj_path: str, idx_path: str) -> None:
    """Rebuild a .idx for decode-to-volume (reference ec_decoder.go:18)."""
    keys, offs, sizes = idx_entries_numpy(ecx_path)
    deleted = set(read_ecj(ecj_path))
    if deleted:
        mask = np.isin(keys, np.fromiter(deleted, dtype=np.uint64))
        sizes = sizes.copy()
        sizes[mask] = t.TOMBSTONE_SIZE
    write_idx_entries(idx_path, keys, offs, sizes)


def max_ecx_extent(ecx_path: str) -> int:
    """Logical .dat size implied by the highest needle end (ec_decoder.go:48)."""
    from ..storage.needle import record_size_from_header
    keys, offs, sizes = idx_entries_numpy(ecx_path)
    live = sizes != np.uint32(t.TOMBSTONE_SIZE)
    if not live.any():
        return 0
    ends = offs[live].astype(np.int64) * t.NEEDLE_PADDING
    best = 0
    for off, sz in zip(ends, sizes[live]):
        best = max(best, int(off) + record_size_from_header(int(sz)))
    return best


def write_vif(path: str, **info) -> None:
    """Atomic replace (tmp + fsync + rename): the .vif is the volume's
    source of truth for geometry/codec — a crash mid-write must leave the
    OLD sidecar, never a truncated one that fails json.load."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # the rename itself is durable only once the parent directory is fsynced
    fsync_dir(path)


def read_vif(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


# Concurrent .vif writers (the idle-close read stamp on one thread, tier
# offload/promote seals and tier moves on others) must not interleave
# read-modify-write cycles: a lost update could drop the remote_shards
# mapping after the local payloads were deleted. One lock per sidecar path
# serializes them.
_vif_locks: dict = {}
_vif_locks_guard = threading.Lock()


def _vif_lock(path: str) -> threading.Lock:
    key = os.path.abspath(path)
    with _vif_locks_guard:
        lk = _vif_locks.get(key)
        if lk is None:
            lk = _vif_locks[key] = threading.Lock()
        return lk


def update_vif(path: str, updates: "dict | None" = None,
               remove: tuple = ()) -> dict:
    """Locked read-modify-write of a .vif: merge `updates`, drop the
    `remove` keys, write atomically. Returns the resulting dict. Every
    change to an existing .vif goes through here (the first seal of a
    fresh sidecar is exclusive by construction and may write_vif)."""
    with _vif_lock(path):
        info = read_vif(path)
        info.update(updates or {})
        for k in remove:
            info.pop(k, None)
        write_vif(path, **info)
        return info


# -- offloaded-shard claims. A claim is one shard's entry of the .vif's
# `remote_shards` mapping {"spec":, "keys": {sid: key}, "sizes": {sid:
# size}}. Moving a remote-backed shard between servers moves its claim,
# never the remote payload; exactly one server must hold each claim, or the
# fleet double-counts (and a reap double-deletes) the remote object.

def remote_claims(info: dict, sids) -> "dict | None":
    """Extract the `remote_shards` sub-mapping covering exactly `sids`
    from a parsed .vif — None when no claim covers any of them."""
    rem = info.get("remote_shards") or {}
    keys = {str(s): rem["keys"][str(s)] for s in sids
            if str(s) in rem.get("keys", {})}
    if not keys:
        return None
    sizes = rem.get("sizes", {})
    return {"spec": rem.get("spec", ""), "keys": keys,
            "sizes": {k: sizes[k] for k in keys if k in sizes}}


def merge_remote_claims(path: str, claims: "dict | None") -> None:
    """Fold `claims` (a remote_shards-shaped mapping) into the .vif at
    `path` under the sidecar lock. A spec mismatch with existing claims
    is refused: one volume's offloaded shards live under one backend
    spec by construction (storage/store.py offload seal)."""
    if not claims or not claims.get("keys"):
        return
    with _vif_lock(path):
        info = read_vif(path)
        rem = info.get("remote_shards") or \
            {"spec": claims.get("spec", ""), "keys": {}, "sizes": {}}
        if rem.get("spec") and claims.get("spec") and \
                rem["spec"] != claims["spec"]:
            raise ValueError(
                f"remote claim spec {claims['spec']!r} conflicts with "
                f"sealed {rem['spec']!r} in {path}")
        rem.setdefault("keys", {}).update(claims["keys"])
        rem.setdefault("sizes", {}).update(claims.get("sizes", {}))
        info["remote_shards"] = rem
        write_vif(path, **info)


def drop_remote_claims(path: str, sids) -> list[int]:
    """Remove the claims for `sids` from the .vif (the remote objects
    themselves are untouched: a move's source-side release, not a
    delete). Drops the whole mapping when its last claim goes. Returns
    the shard ids whose claims were actually dropped."""
    dropped: list[int] = []
    with _vif_lock(path):
        info = read_vif(path)
        rem = info.get("remote_shards")
        if not rem:
            return dropped
        for s in sids:
            if rem.get("keys", {}).pop(str(s), None) is not None:
                dropped.append(int(s))
            rem.get("sizes", {}).pop(str(s), None)
        if not dropped:
            return dropped
        if rem.get("keys"):
            info["remote_shards"] = rem
        else:
            info.pop("remote_shards", None)
        write_vif(path, **info)
    return dropped
