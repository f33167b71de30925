"""Remote filer client: the FilerServer duck-type surface over gRPC + HTTP.

Reference: weed/pb/filer_pb_helpers + wdclient-based filer access — what
`weed filer.sync` / `filer.copy` / `filer.meta.tail` dial. Presents exactly
the surface the replication plane (replication/filer_sync.py, sink.py) uses
on an in-process FilerServer, so the same FilerSync/FilerSink code drives
either a local object or a remote daemon:

    fc = FilerClient("host:8888")
    fc.filer.find_entry / create_entry / delete_entry
    fc.filer.store.kv_get / kv_put
    fc.filer.meta_log.subscribe(since_ns, stop)
    fc.read_entry_bytes(entry) / fc.write_file(path, data)

Data bytes go straight to the blob cluster (AssignVolume RPC + volume HTTP),
matching the in-process server's chunking.

The port's copy of seaweedfs_tpu/client/filer_client.py: it speaks the
reference's wire, so it drives a filer of either package, and the port's
replication plane and WebDAV gateway run over it. Its differences:
`write_file` returns the created entry and records the content's md5 in
it, as FilerServer.write_file does (the reference returns None, so its
standalone S3 gateway, which reads the entry's md5 for the ETag, fails
every PutObject); `.filer.store.delete_entry` removes metadata only, as
a store's does (the reference's deletes the chunks too, so a multipart
object completed through it lost its parts' bytes); a TTL goes to the
volume side as filer_server.volume_ttl spells it, not as "<seconds>s"; an
uncached remote-mounted entry reads through to its remote, as the filer
server's read does (the reference's returns zeros of the entry's size, so
a mount or an FTP RETR over it served zeros).
"""

from __future__ import annotations

import threading
import time

from ..filer.chunks import total_size
from ..pb import filer_pb2 as fpb
from ..utils.log import logger
from ..utils.rpc import FILER_SERVICE, Stub

log = logger("filer-client")


class FilerClient:
    def __init__(self, filer_address: str, grpc_address: str = "",
                 client_name: str = "filer-client", cache_mb: int = 32,
                 cache_dir: "str | None" = None, cache_disk_mb: int = 1024):
        self.http_address = filer_address
        host, _, port = filer_address.rpartition(":")
        self.grpc_address = grpc_address or f"{host}:{int(port) + 10000}"
        self.stub = Stub(self.grpc_address, FILER_SERVICE)
        self.client_name = client_name
        conf = self.stub.call("GetFilerConfiguration",
                              fpb.GetFilerConfigurationRequest(),
                              fpb.GetFilerConfigurationResponse)
        self.chunk_size = (conf.max_mb or 4) << 20
        self.collection = conf.collection
        self.replication = conf.replication
        self.signature = conf.signature  # the filer's identity (mesh)
        self._vid_cache: dict[str, tuple[list[str], float]] = {}
        # tiered chunk cache + prefetching reader: kernel reads arrive in
        # <=128 KiB slices, each resolving a multi-MB chunk; sequential
        # readers find chunk N+1 prefetched (reference util/chunk_cache +
        # filer/reader_cache on the mount read path). cache_dir adds the
        # bounded disk tier (mount -cacheDir).
        from ..filer.chunk_cache import ChunkCache, ReaderCache
        self.chunk_cache = ChunkCache(
            mem_limit_bytes=cache_mb << 20, disk_dir=cache_dir,
            disk_limit_bytes=cache_disk_mb << 20)
        self.reader_cache = ReaderCache(self._fetch_blob_upstream,
                                        self.chunk_cache)
        self.filer = _FilerFacade(self, conf.signature)

    # -- data path -----------------------------------------------------------
    _VID_CACHE_TTL = 300.0  # vid placements churn slowly (vid_map analogue)

    def _lookup_fid(self, fid: str) -> "list[str]":
        vid = fid.split(",")[0]
        now = time.monotonic()
        hit = self._vid_cache.get(vid)
        if hit and now - hit[1] < self._VID_CACHE_TTL:
            return hit[0]
        resp = self.stub.call("LookupVolume",
                              fpb.LookupVolumeRequest(
                                  volume_or_file_ids=[fid]),
                              fpb.LookupVolumeResponse)
        locs = resp.locations_map.get(fid)
        if locs is None:  # keyed by vid for bare ids
            locs = next(iter(resp.locations_map.values()), None)
        urls = [l.public_url or l.url
                for l in (locs.locations if locs else [])]
        if urls:
            self._vid_cache[vid] = (urls, now)
        return urls

    def _fetch_blob_upstream(self, fid: str) -> bytes:
        from ..utils import failpoints, retry
        from . import http_util

        failpoints.check("filer.blob.read")
        last = None
        for attempt in range(2):
            # known-dead holders (open breakers) go last; http_util
            # itself retries transient blips with jittered backoff. The
            # last candidate attempts even through an open breaker.
            ordered = retry.order_by_breaker(self._lookup_fid(fid))
            for i, url in enumerate(ordered):
                try:
                    r = http_util.get(f"http://{url}/{fid}", timeout=30,
                                      fail_fast_open=i < len(ordered) - 1)
                    if r.status == 200:
                        return failpoints.corrupt("filer.blob.read.data",
                                                  r.content)
                    last = f"HTTP {r.status}"
                except Exception as e:  # noqa: BLE001
                    last = e
            # stale cache: refresh once and retry
            self._vid_cache.pop(fid.split(",")[0], None)
        raise IOError(f"chunk {fid} unreadable: {last}")

    def _fetch_blob(self, fid: str, upcoming: "list[str] | None" = None
                    ) -> bytes:
        return self.reader_cache.read(fid, upcoming)

    def close(self) -> None:
        """Release the prefetch pool (long-lived gateways call this on
        shutdown; short-lived CLI verbs exit the process anyway)."""
        self.reader_cache.close()

    def _fill_window(self, chunks, offset: int, size: int) -> bytes:
        """Assemble [offset, offset+size) with sequential-read prefetch
        (one shared implementation with the filer server's read path)."""
        from ..filer.chunk_cache import assemble_window
        return assemble_window(chunks, offset, size, self._fetch_blob)

    def read_entry_bytes(self, entry: fpb.Entry, offset: int = 0,
                         size: int | None = None) -> bytes:
        if entry.content:
            data = bytes(entry.content)
            end = None if size is None else offset + size
            return data[offset:end]
        if not entry.chunks and entry.extended.get("remote"):
            from ..remote import read_remote
            return read_remote(entry, offset, size)
        from ..filer.chunks import resolve_manifests
        chunks = resolve_manifests(list(entry.chunks), self._fetch_blob)
        fsize = max(total_size(chunks), entry.attributes.file_size)
        if size is None:
            size = fsize - offset
        size = max(0, min(size, fsize - offset))
        return self._fill_window(chunks, offset, size)

    def iter_entry_bytes(self, entry: fpb.Entry, window: int = 0):
        """Yield the entry's content in bounded windows (gateway streaming:
        one FTP RETR must not materialize a multi-GB file in memory).
        The window defaults to chunk_size so chunk-aligned files are
        fetched (and decrypted) once per chunk, not once per window."""
        if entry.content:
            yield bytes(entry.content)
            return
        window = window or self.chunk_size
        remote = not entry.chunks and bool(entry.extended.get("remote"))
        from ..filer.chunks import resolve_manifests
        chunks = resolve_manifests(list(entry.chunks), self._fetch_blob)
        fsize = max(total_size(chunks), entry.attributes.file_size)
        off = 0
        while off < fsize:
            size = min(window, fsize - off)
            yield self.read_entry_bytes(entry, off, size) if remote \
                else self._fill_window(chunks, off, size)
            off += size

    def _save_blob(self, data: bytes, ttl: str = "",
                   path: str = "") -> fpb.FileChunk:
        """Assign + upload ONE blob (the FUSE page-writer seam,
        FilerServer._save_blob's remote twin)."""
        return self._save_blob_full(data, ttl=ttl, path=path)[0]

    def _save_blob_full(self, data: bytes, ttl: str = "", path: str = ""
                        ) -> "tuple[fpb.FileChunk, str, str]":
        """(chunk, blob_url, jwt) — the url+jwt let a failed multi-chunk
        write delete what it already uploaded."""
        from ..client import operation
        from ..storage.types import TTL

        ttl_sec = TTL.parse(ttl).seconds if ttl else 0
        a = self.stub.call("AssignVolume",
                           fpb.AssignVolumeRequest(count=1, path=path,
                                                   ttl_sec=ttl_sec),
                           fpb.AssignVolumeResponse)
        if a.error:
            raise IOError(f"assign: {a.error}")
        target = a.public_url or a.location_url
        url = f"{target}/{a.file_id}"
        res = operation.upload(url, data,
                               gzip_if_worthwhile=False, ttl=ttl, jwt=a.auth)
        return fpb.FileChunk(file_id=a.file_id,
                             size=res.get("size", len(data)),
                             modified_ts_ns=time.time_ns(),
                             e_tag=res.get("eTag", "")), url, a.auth

    def write_file(self, path: str, data: bytes, mime: str = "",
                   ttl_sec: int = 0, mode: int = 0o644,
                   signatures: "list[int] | None" = None) -> fpb.Entry:
        """Chunked upload straight into the blob cluster + CreateEntry,
        mirroring FilerServer.write_file: returns the created entry, which
        carries the content's md5 as the server's does."""
        return self._write(path, (data,), mime, ttl_sec, mode, signatures)

    def write_file_stream(self, path: str, blocks, mime: str = "",
                          ttl_sec: int = 0, mode: int = 0o644,
                          signatures: "list[int] | None" = None) -> int:
        """write_file over an iterable of byte blocks: repacks into
        chunk_size pieces and uploads as they arrive, so a gateway upload
        (FTP STOR) holds at most one chunk in memory. Returns total bytes."""
        return self._write(path, blocks, mime, ttl_sec, mode,
                           signatures).attributes.file_size

    def _write(self, path: str, blocks, mime: str, ttl_sec: int, mode: int,
               signatures: "list[int] | None") -> fpb.Entry:
        import hashlib

        from ..filer.filer import split_path
        from ..filer.filer_server import volume_ttl

        directory, name = split_path(path)
        ttl = volume_ttl(ttl_sec)
        md5 = hashlib.md5(usedforsecurity=False)
        chunks = []
        uploaded: "list[tuple[str, str]]" = []  # (url, jwt) for rollback
        buf = bytearray()
        off = 0

        def flush(final: bool) -> None:
            nonlocal off
            while len(buf) >= self.chunk_size or (final and buf):
                piece = bytes(buf[:self.chunk_size])
                del buf[:self.chunk_size]
                c, url, jwt = self._save_blob_full(piece, ttl=ttl, path=path)
                uploaded.append((url, jwt))
                c.offset = off
                off += len(piece)
                chunks.append(c)

        try:
            for block in blocks:
                if block:
                    md5.update(block)
                    buf += block
                    flush(final=False)
            flush(final=True)
        except BaseException:
            # the source died mid-stream (e.g. an aborted FTP STOR): no
            # entry will ever reference what we uploaded, so delete it
            # now instead of leaking unreferenced needles
            from ..client import http_util
            for url, jwt in uploaded:
                try:
                    http_util.delete(url, params={"jwt": jwt} if jwt else None)
                except Exception as e:  # noqa: BLE001 - best effort
                    log.debug("orphan chunk cleanup %s failed: %s", url, e)
            raise
        entry = fpb.Entry(name=name)
        entry.chunks.extend(chunks)
        at = entry.attributes
        at.file_size = off
        at.mime = mime
        at.file_mode = mode
        at.ttl_sec = ttl_sec
        at.md5 = md5.digest()
        self.filer.create_entry(directory, entry, signatures=signatures)
        return entry


class _StoreFacade:
    """`.filer.store`: the store-level calls, remoted. Its delete_entry
    removes an entry's metadata and never its chunks, as a store's does
    (the S3 gateway's multipart completion drops the part entries whose
    chunks the object now owns); the reference's facade deletes the data
    too, so a completed multipart object through a remote filer lost its
    bytes."""

    def __init__(self, filer: "_FilerFacade"):
        self._filer = filer

    def delete_entry(self, directory: str, name: str) -> None:
        self._filer.delete_entry(directory, name, is_delete_data=False,
                                 is_recursive=False)

    def __getattr__(self, name):
        return getattr(self._filer, name)


class _FilerFacade:
    """The `.filer` attribute: entry CRUD + kv + meta_log, remoted."""

    def __init__(self, fc: FilerClient, signature: int):
        self.fc = fc
        self.signature = signature
        self.store = _StoreFacade(self)
        self.meta_log = self

    # -- entries -------------------------------------------------------------
    def find_entry(self, directory: str, name: str) -> "fpb.Entry | None":
        try:
            resp = self.fc.stub.call(
                "LookupDirectoryEntry",
                fpb.LookupDirectoryEntryRequest(directory=directory,
                                                name=name),
                fpb.LookupDirectoryEntryResponse)
            return resp.entry
        except Exception:  # noqa: BLE001 — not found aborts
            return None

    def create_entry(self, directory: str, entry: fpb.Entry,
                     o_excl: bool = False, from_other_cluster: bool = False,
                     signatures: "list[int] | None" = None) -> None:
        resp = self.fc.stub.call(
            "CreateEntry",
            fpb.CreateEntryRequest(directory=directory, entry=entry,
                                   o_excl=o_excl,
                                   is_from_other_cluster=from_other_cluster,
                                   signatures=signatures or []),
            fpb.CreateEntryResponse)
        if resp.error:
            raise IOError(resp.error)

    def update_entry(self, directory: str, entry: fpb.Entry,
                     touch_mtime: bool = True, **_kw) -> None:
        self.fc.stub.call("UpdateEntry",
                          fpb.UpdateEntryRequest(directory=directory,
                                                 entry=entry,
                                                 keep_mtime=not touch_mtime),
                          fpb.UpdateEntryResponse)

    def list_entries(self, directory: str, start_from: str = "",
                     inclusive: bool = False, limit: int = 1 << 30,
                     prefix: str = ""):
        for resp in self.fc.stub.call_stream(
                "ListEntries",
                fpb.ListEntriesRequest(directory=directory, prefix=prefix,
                                       start_from_file_name=start_from,
                                       inclusive_start_from=inclusive,
                                       limit=min(limit, 1 << 30)),
                fpb.ListEntriesResponse):
            yield resp.entry

    def rename(self, old_dir: str, old_name: str, new_dir: str,
               new_name: str = "") -> None:
        self.fc.stub.call("AtomicRenameEntry",
                          fpb.AtomicRenameEntryRequest(
                              old_directory=old_dir, old_name=old_name,
                              new_directory=new_dir,
                              new_name=new_name or old_name),
                          fpb.AtomicRenameEntryResponse)

    def link(self, old_dir: str, old_name: str, new_dir: str,
             new_name: str) -> None:
        resp = self.fc.stub.call("LinkEntry",
                                 fpb.LinkEntryRequest(
                                     old_directory=old_dir,
                                     old_name=old_name,
                                     new_directory=new_dir,
                                     new_name=new_name),
                                 fpb.LinkEntryResponse)
        if resp.error:
            tag, _, msg = resp.error.partition(":")
            exc = {"EISDIR": IsADirectoryError,
                   "EEXIST": FileExistsError}.get(tag, FileNotFoundError)
            raise exc(msg or resp.error)

    def delete_entry(self, directory: str, name: str,
                     is_delete_data: bool = True,
                     is_recursive: bool = True, **_kw) -> None:
        self.fc.stub.call("DeleteEntry",
                          fpb.DeleteEntryRequest(
                              directory=directory, name=name,
                              is_delete_data=is_delete_data,
                              is_recursive=is_recursive),
                          fpb.DeleteEntryResponse)

    # -- kv ------------------------------------------------------------------
    def kv_get(self, key: bytes) -> "bytes | None":
        resp = self.fc.stub.call("KvGet", fpb.KvGetRequest(key=key),
                                 fpb.KvGetResponse)
        return bytes(resp.value) if resp.value else None

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.fc.stub.call("KvPut", fpb.KvPutRequest(key=key, value=value),
                          fpb.KvPutResponse)

    # -- meta subscription ---------------------------------------------------
    def server_now_ns(self) -> int:
        """The FILER's clock for use as a subscribe offset — the caller's
        clock may be skewed, and events stamped between a skewed `since`
        and now would silently never be delivered."""
        conf = self.fc.stub.call("GetFilerConfiguration",
                                 fpb.GetFilerConfigurationRequest(),
                                 fpb.GetFilerConfigurationResponse)
        import time as _time
        return conf.now_ns or _time.time_ns()

    def subscribe_local(self, since_ns: int, stop: threading.Event,
                        path_prefix: str = "/"):
        """SubscribeLocalMetadata: only events originated at that filer
        (the peer-mesh feed, reference meta_aggregator.go)."""
        yield from self.subscribe(since_ns, stop, path_prefix,
                                  method="SubscribeLocalMetadata")

    def subscribe(self, since_ns: int, stop: threading.Event,
                  path_prefix: str = "/",
                  method: str = "SubscribeMetadata"):
        """SubscribeMetadata stream shaped like MetaLog.subscribe: yields
        responses with .directory / .event_notification / .ts_ns."""
        while not stop.is_set():
            try:
                for resp in self.fc.stub.call_stream(
                        method,
                        fpb.SubscribeMetadataRequest(
                            client_name=self.fc.client_name,
                            path_prefix=path_prefix, since_ns=since_ns),
                        fpb.SubscribeMetadataResponse, timeout=86400):
                    if stop.is_set():
                        return
                    if resp.ts_ns:
                        since_ns = max(since_ns, resp.ts_ns)
                    yield resp
            except Exception as e:  # noqa: BLE001 — reconnect from offset
                if stop.is_set():
                    return
                log.warning("meta subscribe to %s: %s; reconnecting",
                            self.fc.grpc_address, e)
                if stop.wait(1.0):
                    return
