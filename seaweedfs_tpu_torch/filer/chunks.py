"""Chunked-file model: visible-interval resolution and manifest chunks.

A file is a list of FileChunk{file_id, offset, size, modified_ts_ns}; on
overlapping ranges the newest chunk wins. Reference:
weed/filer/filechunks.go (interval resolution), interval_list.go,
filechunk_manifest.go (manifest compression of huge chunk lists).
Re-designed: resolution here is a single sweep over mtime-sorted chunks
into an ordered interval list, instead of the reference's linked list.

The port's copy of seaweedfs_tpu/filer/chunks.py, unchanged: the same views,
ETags and manifests, so a file chunked by either package reads in the other.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from dataclasses import dataclass
from typing import Callable, Iterable

from ..pb import filer_pb2 as fpb

# Chunk lists longer than this get folded into a manifest chunk
# (reference filechunk_manifest.go ManifestBatch = 10000; we fold earlier
# because metadata stores round-trip entries on every update).
MANIFEST_BATCH = 1000


@dataclass
class ChunkView:
    """One resolved read: fetch [chunk_offset, chunk_offset+size) of file_id
    and place it at logical_offset in the file."""

    file_id: str
    chunk_offset: int   # offset inside the chunk blob
    size: int
    logical_offset: int
    cipher_key: bytes = b""  # decrypt the fetched blob first when set


def total_size(chunks: Iterable[fpb.FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def etag(chunks: list[fpb.FileChunk]) -> str:
    if not chunks:
        return ""
    if len(chunks) == 1:
        return chunks[0].e_tag
    import hashlib

    h = hashlib.md5(usedforsecurity=False)  # ETag fingerprint, FIPS-safe
    for c in chunks:
        h.update(c.e_tag.encode())
    return f"{h.hexdigest()}-{len(chunks)}"


class _IntervalList:
    """Sorted, non-overlapping intervals; newer insertions overwrite."""

    def __init__(self):
        self.starts: list[int] = []
        self.items: list[tuple[int, int, fpb.FileChunk]] = []  # (start, stop, chunk)

    def insert(self, start: int, stop: int, chunk: fpb.FileChunk) -> None:
        if stop <= start:
            return
        lo = bisect_right(self.starts, start) - 1
        if lo >= 0 and self.items[lo][1] > start:
            pass  # overlaps predecessor
        else:
            lo += 1
        hi = bisect_left(self.starts, stop)
        # affected items [lo, hi) overlap [start, stop)
        replacement: list[tuple[int, int, fpb.FileChunk]] = []
        if lo < len(self.items):
            s0, e0, c0 = self.items[lo]
            if s0 < start:
                replacement.append((s0, start, c0))
        replacement.append((start, stop, chunk))
        if hi - 1 >= lo and hi - 1 < len(self.items):
            s1, e1, c1 = self.items[hi - 1]
            if e1 > stop:
                replacement.append((stop, e1, c1))
        self.items[lo:hi] = replacement
        self.starts[lo:hi] = [it[0] for it in replacement]


def resolve_chunks(chunks: Iterable[fpb.FileChunk]) -> list[tuple[int, int, fpb.FileChunk]]:
    """Visible (start, stop, chunk) intervals, ascending, newest-wins."""
    il = _IntervalList()
    for c in sorted(chunks, key=lambda c: (c.modified_ts_ns, c.file_id)):
        il.insert(c.offset, c.offset + c.size, c)
    return il.items


def read_views(chunks: Iterable[fpb.FileChunk], offset: int, size: int) -> list[ChunkView]:
    """ChunkViews covering [offset, offset+size) of the visible file."""
    stop = offset + size
    views: list[ChunkView] = []
    for s, e, c in resolve_chunks(chunks):
        if e <= offset or s >= stop:
            continue
        lo, hi = max(s, offset), min(e, stop)
        views.append(ChunkView(
            file_id=c.file_id,
            chunk_offset=lo - c.offset,
            size=hi - lo,
            logical_offset=lo,
            cipher_key=bytes(c.cipher_key)))
    return views


# -- manifest chunks --------------------------------------------------------

def separate_manifest_chunks(chunks: Iterable[fpb.FileChunk]
                             ) -> tuple[list[fpb.FileChunk], list[fpb.FileChunk]]:
    manifests, rest = [], []
    for c in chunks:
        (manifests if c.is_chunk_manifest else rest).append(c)
    return manifests, rest


def resolve_manifests(chunks: Iterable[fpb.FileChunk],
                      fetch: Callable[[str], bytes],
                      depth: int = 0) -> list[fpb.FileChunk]:
    """Expand manifest chunks into their underlying data chunks.

    fetch(file_id) -> manifest blob bytes. Nested manifests allowed to
    depth 3 (reference filechunk_manifest.go caps similarly)."""
    if depth > 3:
        raise ValueError("manifest nesting too deep")
    manifests, data = separate_manifest_chunks(chunks)
    for m in manifests:
        blob = fetch(m.file_id)
        if m.cipher_key:  # encrypted manifest blob (util/cipher.go model)
            from ..security.cipher import decrypt
            blob = decrypt(blob, m.cipher_key)
        mf = fpb.FileChunkManifest()
        mf.ParseFromString(blob)
        data.extend(resolve_manifests(mf.chunks, fetch, depth + 1))
    return data


def maybe_manifestize(chunks: list[fpb.FileChunk],
                      save: Callable[[bytes], fpb.FileChunk]
                      ) -> list[fpb.FileChunk]:
    """Fold runs of MANIFEST_BATCH non-manifest chunks into manifest chunks.

    save(blob) uploads the serialized FileChunkManifest and returns a
    FileChunk pointing at it (caller sets file_id/e_tag/size)."""
    manifests, data = separate_manifest_chunks(chunks)
    if len(data) <= MANIFEST_BATCH:
        return chunks
    data.sort(key=lambda c: c.offset)
    out = list(manifests)
    for i in range(0, len(data) - len(data) % MANIFEST_BATCH, MANIFEST_BATCH):
        batch = data[i:i + MANIFEST_BATCH]
        mf = fpb.FileChunkManifest(chunks=batch)
        blob = mf.SerializeToString()
        mc = save(blob)
        mc.is_chunk_manifest = True
        mc.offset = min(c.offset for c in batch)
        mc.size = total_size(batch) - mc.offset
        mc.modified_ts_ns = max(c.modified_ts_ns for c in batch)
        out.append(mc)
    out.extend(data[len(data) - len(data) % MANIFEST_BATCH:])
    return out
