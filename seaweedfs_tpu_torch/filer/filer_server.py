"""Filer daemon: HTTP namespace API + gRPC service + metadata subscription.

Reference: weed/server/filer_server.go, filer_server_handlers_write_autochunk.go:26
(autoChunk — re-designed here as a STREAMING windowed fan-out: the body
is chunked as it arrives and up to SWTPU_FILER_UPLOAD_CONC chunk
uploads ride in flight, so peak memory is O(chunk_size x conc) and a
multi-chunk PUT overlaps its per-chunk upload latency),
filer_server_handlers_read.go (range reads — served window-by-window
through the reader pool's cold-fetch fan-out, see chunk_cache.py),
filer_grpc_server.go (entry RPCs), filer_grpc_server_sub_meta.go
(SubscribeMetadata). Data chunks are stored in the blob cluster via
assign+upload; only metadata lives here.

The port's copy of seaweedfs_tpu/filer/filer_server.py. Its differences:
* The HTTP plane runs on the port's utils/fastweb, not aiohttp (the port
  has none; utils/webapp.py, the reference's aiohttp wrapper, is not
  ported: fastweb.serve_fast_app takes its place). The namespace
  catch-all reads its body as a fastweb BodyStream of at most
  fastweb.STREAM_BOUND queued bytes, so the reference's relay between the loop
  and the chunking writer (`stream_write`, :641-728) is a plain reader of
  that stream, with the reference's `observer` and `finalize` hooks; GETs larger than a chunk go out as a fastweb streamed
  Response over `read_entry_windows`, so the reference's memory bound,
  O(chunk_size x SWTPU_FILER_UPLOAD_CONC) and not the object's size,
  holds. `stream_peaks` keeps the high-water marks that show it: a PUT
  body's queued bytes and largest piece, and the chunk uploads in flight;
  a streamed GET's largest window and the most bytes its transport held
  after a write.
  Multipart forms go through fastweb.parse_multipart_single. A streamed
  GET's span and request seconds end when its head is ready; the window
  fetches after it keep their own filer.blob.read spans in the trace.
* A write with a TTL (`?ttl=`, or a path rule's `ttl`, such as the S3
  gateway's lifecycle rules) sends it to the volume side in a unit
  storage/types.TTL.parse reads: the rule's own string, else
  `volume_ttl(seconds)`. The reference sends "<seconds>s", which TTL.parse
  refuses, so each such write fails there.
* The filer does no device work and imports no torch.
"""

from __future__ import annotations

import contextvars
import hashlib
import mimetypes
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

from ..client import operation
from ..client.master_client import MasterClient
from ..pb import filer_pb2 as fpb
from ..utils.log import logger
from ..utils.rpc import FILER_SERVICE, RpcService, serve
from .chunks import etag as chunk_etag
from .chunks import maybe_manifestize, total_size
from .filer import Filer, join_path, split_path
from .store import open_store

log = logger("filer-server")

DEFAULT_CHUNK_MB = 4  # reference filer.maxMB default (command/filer.go)
INLINE_LIMIT = 0  # set >0 to inline small files into metadata


class FilerServer:
    def __init__(self, master_address: str, store_spec: str = "memory",
                 ip: str = "127.0.0.1", port: int = 8888,
                 grpc_port: int | None = None,
                 meta_log_path: str | None = None,
                 collection: str = "", replication: str = "",
                 chunk_size_mb: int = DEFAULT_CHUNK_MB,
                 encrypt_data: bool = False,
                 meta_aggregate: bool = False,
                 chunk_cache_mb: int = 64,
                 chunk_cache_dir: "str | None" = None,
                 chunk_cache_disk_mb: int = 1024,
                 metrics_gateway: str = "", metrics_interval_s: int = 15):
        self.ip, self.port = ip, port
        self.grpc_port = grpc_port or port + 10000
        self.collection, self.replication = collection, replication
        self.chunk_size = chunk_size_mb << 20
        # at-rest chunk encryption (reference filer -encryptVolumeData +
        # util/cipher.go): volume servers only ever see ciphertext
        self.encrypt_data = encrypt_data
        # register under the real service address so peers can discover
        # this filer via ListClusterNodes (reference cluster.go:104)
        self.mc = MasterClient(master_address, client_type="filer",
                               client_address=f"{ip}:{port}",
                               grpc_port=self.grpc_port)
        # peer metadata mesh (reference meta_aggregator.go): every filer
        # in the master cluster tails every other filer's LOCAL stream
        self.meta_aggregate = meta_aggregate
        self.aggregator = None
        self.filer = Filer(open_store(store_spec), meta_log_path,
                           chunk_deleter=self._delete_chunks)
        # path-prefix storage rules, hot-reloaded on conf-entry mutation
        # (reference filer_conf.go; stored IN the filer at
        # /etc/seaweedfs/filer.conf); loaded in start() once the master
        # client can resolve chunked conf entries
        from . import filer_conf
        self.conf = filer_conf.FilerConf()
        self.filer.mutation_hooks.append(self._maybe_reload_conf)
        # tiered chunk cache + prefetching reader shared by HTTP, S3 (it
        # reads through this filer), and FUSE reads (reference
        # util/chunk_cache + filer/reader_cache behind every read)
        from .chunk_cache import ChunkCache, ReaderCache
        from ..utils.env import env_int
        self.chunk_cache = ChunkCache(
            mem_limit_bytes=chunk_cache_mb << 20,
            disk_dir=chunk_cache_dir,
            disk_limit_bytes=chunk_cache_disk_mb << 20)
        # large-object data plane knobs: how many chunk uploads ride in
        # flight per filer (the write window — also the streaming-ingest
        # memory bound, O(chunk_size x conc)), how many cold fetches fan
        # out on the reader pool, and how many chunk views per streamed
        # GET window
        self.upload_conc = max(1, env_int("SWTPU_FILER_UPLOAD_CONC", 4))
        self.fetch_conc = max(1, env_int("SWTPU_FILER_FETCH_CONC", 4))
        self.read_window_views = max(1, env_int("SWTPU_FILER_READ_WINDOW",
                                                4))
        # the high-water marks of the streamed HTTP plane: a PUT body's
        # queue and upload window, a GET's windows and send buffer
        self.stream_peaks = {"queued": 0, "piece": 0, "inflight_chunks": 0,
                             "window": 0, "sent_buffered": 0}
        self.reader_cache = ReaderCache(self._fetch_blob_upstream,
                                        self.chunk_cache,
                                        workers=self.fetch_conc)
        self._upload_pool = ThreadPoolExecutor(
            max_workers=self.upload_conc,
            thread_name_prefix=f"chunk-upload-{port}")
        # streaming-ingest writers get their own pool: they block on the
        # relay queue, and parking them on the loop's default executor
        # (where the relay puts run) could starve the puts that feed them
        self._stream_pool = ThreadPoolExecutor(
            max_workers=max(4, self.upload_conc),
            thread_name_prefix=f"stream-write-{port}")
        self._stop = threading.Event()
        self._grpc = None
        self._http_thread = None
        # optional push-gateway loop; started in start(), joined in stop()
        self.metrics_gateway = metrics_gateway
        self.metrics_interval_s = metrics_interval_s
        self._metrics_push = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FilerServer":
        from ..profiling import LoopLagMonitor, acquire_sampler
        self._sampler = acquire_sampler()
        self._loop_lag = LoopLagMonitor("filer")
        self.mc.start()
        self.mc.wait_connected(10)
        from . import filer_conf
        entry = self.filer.find_entry(filer_conf.CONF_DIR,
                                      filer_conf.CONF_NAME)
        if entry is not None:
            self._maybe_reload_conf(filer_conf.CONF_DIR, None, entry)
        self._grpc = serve(f"{self.ip}:{self.grpc_port}", [self._build_service()])
        self._http_ready = threading.Event()
        self._http_error = None
        self._http_thread = threading.Thread(target=self._run_http, daemon=True,
                                             name=f"filer-http-{self.port}")
        self._http_thread.start()
        self._http_ready.wait(10)  # don't log "up" before the port is bound
        if self._http_error is not None:
            self.stop()
            raise OSError(f"filer http {self.url}: {self._http_error}")
        if self.meta_aggregate:
            # peers learn this filer's real grpc port from the master
            # registration (KeepConnectedRequest.grpc_port), so a custom
            # port no longer breaks mesh dialing
            from .meta_aggregator import MetaAggregator
            self.aggregator = MetaAggregator(self).start()
        if self.metrics_gateway:
            from ..stats import start_push_loop
            self._metrics_push = start_push_loop(
                self.metrics_gateway, f"filer-{self.url}",
                self.metrics_interval_s)
        log.info("filer %s up (grpc :%d, store %s)", self.url, self.grpc_port,
                 self.filer.store.name)
        return self

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        if self.aggregator is not None:
            self.aggregator.stop()
        if self._metrics_push is not None:
            self._metrics_push.stop()
        if self._grpc:
            self._grpc.stop(grace=0.5)
        self.reader_cache.close()  # drop prefetch workers
        self._upload_pool.shutdown(wait=False, cancel_futures=True)
        self._stream_pool.shutdown(wait=False, cancel_futures=True)
        self.mc.stop()
        self.filer.close()
        lag = getattr(self, "_loop_lag", None)
        if lag is not None:
            lag.close()
        if getattr(self, "_sampler", None) is not None:
            from ..profiling import release_sampler
            release_sampler()
            self._sampler = None

    def _delete_chunks(self, fids: list[str]) -> None:
        def work():
            try:
                operation.delete_batch(self.mc, fids)
            except Exception as e:  # noqa: BLE001
                log.warning("chunk gc: %s", e)
        threading.Thread(target=work, daemon=True).start()

    def _maybe_reload_conf(self, directory, old, new,
                           new_parent_path: str = "") -> None:
        from . import filer_conf
        # renames carry old in (directory, old.name) and new in
        # (new_parent_path or directory, new.name): react when EITHER side
        # touches the conf path
        old_hit = (old is not None and directory == filer_conf.CONF_DIR
                   and old.name == filer_conf.CONF_NAME)
        new_dir = new_parent_path or directory
        new_hit = (new is not None and new_dir == filer_conf.CONF_DIR
                   and new.name == filer_conf.CONF_NAME)
        if not (old_hit or new_hit):
            return
        try:
            raw = b""
            if new_hit:
                # the conf may be stored inline or chunked (HTTP writes
                # auto-chunk); read through either
                raw = (bytes(new.content) if new.content
                       else self.read_entry_bytes(new))
            self.conf = filer_conf.FilerConf.from_bytes(raw)
            log.info("filer.conf reloaded: %d rules", len(self.conf.rules))
        except Exception as e:  # noqa: BLE001 — bad conf keeps old rules
            log.warning("filer.conf reload failed: %s", e)

    def _storage_rule(self, path: str):
        """(collection, replication, ttl, disk_type, fsync) for a path,
        falling back to the server-wide defaults (filer_conf.go
        MatchStorageRule). fsync=True makes every chunk upload under the
        prefix durable before its ack (?fsync=true on the volume PUT)."""
        rule = self.conf.match(path) if path else None
        if rule is None:
            return self.collection, self.replication, "", "", False
        return (rule.collection or self.collection,
                rule.replication or self.replication,
                rule.ttl, rule.disk_type, rule.fsync)

    # -- chunk IO helpers ----------------------------------------------------
    def _save_blob(self, data: bytes, ttl: str = "",
                   path: str = "", queued_at: "float | None" = None
                   ) -> fpb.FileChunk:
        from .. import tracing
        from ..stats import (FILER_CHUNK_UPLOAD_SECONDS,
                             FILER_INFLIGHT_CHUNKS)
        FILER_INFLIGHT_CHUNKS.add("upload", amount=1)
        t0 = time.perf_counter()
        try:
            with tracing.start_span("filer.blob.write", component="filer",
                                    attrs={"bytes": len(data),
                                           "path": path}) as sp:
                if queued_at is not None:
                    # window-pool wait: how long the chunk sat behind the
                    # SWTPU_FILER_UPLOAD_CONC fan-out before its upload
                    # started
                    sp.set_attr("queued_s", round(t0 - queued_at, 6))
                chunk = self._save_blob_inner(data, ttl, path)
                sp.set_attr("fid", chunk.file_id)
                sp.set_attr("upload_s",
                            round(time.perf_counter() - t0, 6))
                return chunk
        finally:
            FILER_INFLIGHT_CHUNKS.add("upload", amount=-1)
            FILER_CHUNK_UPLOAD_SECONDS.observe(
                value=time.perf_counter() - t0)

    def _save_blob_inner(self, data: bytes, ttl: str,
                         path: str) -> fpb.FileChunk:
        from ..utils import failpoints, retry
        collection, replication, rule_ttl, disk, fsync = \
            self._storage_rule(path)
        cipher_key = b""
        logical = len(data)
        if self.encrypt_data:
            from ..security.cipher import encrypt
            data, cipher_key = encrypt(data)
        failpoints.check("filer.blob.write")
        import time as _time
        stop_at = _time.monotonic() + retry.WRITE_POLICY.deadline

        def assign_and_upload():
            # a failed upload retries with a FRESH assign: the first
            # target may be the transiently-dead node (filer→volume hop);
            # the enclosing envelope's wall clock bounds the assign
            # sweeps too, so nested envelopes share one budget.
            # writable_count keeps one writable volume per upload-window
            # slot so the windowed fan-out spreads across volume locks
            a = self.mc.assign(collection=collection,
                               replication=replication, ttl=ttl or rule_ttl,
                               disk_type=disk, deadline=stop_at,
                               writable_count=self.upload_conc)
            target = a.location.public_url or a.location.url
            res = operation.upload(f"{target}/{a.fid}", data,
                                   gzip_if_worthwhile=False, ttl=ttl,
                                   jwt=a.auth, fsync=fsync)
            return a, res

        a, res = retry.retry_call(assign_and_upload, op="filer.blob.write",
                                  policy=retry.WRITE_POLICY)
        # freshly written chunks are the likeliest next reads — seed the
        # MEM tier with exactly what a volume-server GET would return
        # (never the disk tier: that would double local writes on ingest)
        self.chunk_cache.put_mem(a.fid, data)
        # size stays LOGICAL (plaintext) — interval math never sees the
        # nonce/tag overhead
        return fpb.FileChunk(file_id=a.fid,
                             size=logical if cipher_key
                             else res.get("size", len(data)),
                             modified_ts_ns=time.time_ns(),
                             e_tag=res.get("eTag", ""),
                             cipher_key=cipher_key)

    def _fetch_blob_upstream(self, fid: str) -> bytes:
        from .. import tracing
        from ..utils import failpoints
        with tracing.start_span("filer.blob.read", component="filer",
                                attrs={"fid": fid}) as sp:
            t0 = time.perf_counter()
            failpoints.check("filer.blob.read")
            # operation.read carries the retry/breaker envelope; the
            # corrupt site models a bad wire so CRC-style invariants can
            # be drilled
            data = failpoints.corrupt("filer.blob.read.data",
                                      operation.read(self.mc, fid))
            sp.set_attr("bytes", len(data))
            sp.set_attr("fetch_s", round(time.perf_counter() - t0, 6))
            return data

    def _fetch_blob(self, fid: str, upcoming: "list[str] | None" = None
                    ) -> bytes:
        return self.reader_cache.read(fid, upcoming)

    def read_entry_bytes(self, entry: fpb.Entry, offset: int = 0,
                         size: int | None = None) -> bytes:
        return b"".join(self.read_entry_windows(entry, offset, size))

    def read_entry_windows(self, entry: fpb.Entry, offset: int = 0,
                           size: int | None = None):
        """Yield [offset, offset+size) of the entry window-by-window:
        each window's cold chunks fan out CONCURRENTLY on the reader
        pool and the next window prefetches while the caller writes the
        current one out, so a 1 GB GET never materializes 1 GB.
        read_entry_bytes is the one-buffer join of this generator, so
        the buffered and streamed paths cannot diverge."""
        if entry.content:
            data = bytes(entry.content)
            yield data[offset:offset + size if size is not None else None]
            return
        if not entry.chunks and entry.extended.get("remote"):
            # uncached remote-mounted entry: stream straight from the
            # remote store (reference filer read_remote.go), one chunk_size
            # window at a time, as FilerClient.iter_entry_bytes does
            from ..remote import read_remote
            end = entry.attributes.file_size
            if size is not None:
                end = min(end, offset + size)
            while offset < end:
                n = min(self.chunk_size, end - offset)
                yield read_remote(entry, offset, n)
                offset += n
            return
        chunks = self.filer.data_chunks(entry, self._fetch_blob)
        fsize = max(total_size(chunks), entry.attributes.file_size)
        if size is None:
            size = fsize - offset
        size = max(0, min(size, fsize - offset))
        from .chunk_cache import iter_windows
        yield from iter_windows(chunks, offset, size, self._fetch_blob,
                                fetch_many=self.reader_cache.read_many,
                                prefetch=self.reader_cache.prefetch,
                                window_views=self.read_window_views)

    def _save_chunks_windowed(self, pieces, ttl: str,
                              path: str) -> list[fpb.FileChunk]:
        """Upload (offset, bytes) pieces with up to SWTPU_FILER_UPLOAD_CONC
        in flight on the shared pool. Pieces are pulled lazily — a slot
        must free before the next piece is drawn, so a streaming source
        is back-pressured and peak memory stays O(chunk_size x conc).
        The first hard failure (each upload already carries the
        per-chunk retry/breaker envelope) cancels the window, deletes
        every chunk that landed, and surfaces the error; no orphan
        needles outlive a failed write. Returns chunks in offset order —
        byte-identical metadata to the old serial loop."""
        chunks: list[fpb.FileChunk] = []
        inflight: dict = {}  # future -> offset
        it = iter(pieces)
        try:
            while True:
                while len(inflight) < self.upload_conc:
                    nxt = next(it, None)
                    if nxt is None:
                        break
                    off, piece = nxt
                    ctx = contextvars.copy_context()
                    fut = self._upload_pool.submit(
                        ctx.run, self._save_blob, piece, ttl, path,
                        time.perf_counter())
                    inflight[fut] = off
                    peaks = self.stream_peaks
                    peaks["inflight_chunks"] = max(
                        peaks["inflight_chunks"], len(inflight))
                if not inflight:
                    break
                done, _ = wait(inflight, return_when=FIRST_COMPLETED)
                for fut in done:
                    off = inflight.pop(fut)
                    c = fut.result()
                    c.offset = off
                    chunks.append(c)
        except BaseException:
            # reap the window: a cancelled-pending future never uploaded;
            # an in-flight one may still land — wait, then delete all
            for fut in inflight:
                fut.cancel()
            if inflight:
                wait(list(inflight))
            landed = [c.file_id for c in chunks]
            for fut in inflight:
                if not fut.cancelled() and fut.exception() is None:
                    landed.append(fut.result().file_id)
            if landed:
                self._delete_chunks(landed)
            raise
        chunks.sort(key=lambda c: c.offset)
        return chunks

    def write_file(self, path: str, data: bytes, mime: str = "",
                   ttl_sec: int = 0, mode: int = 0o644,
                   signatures: list[int] | None = None) -> fpb.Entry:
        """Auto-chunking write (reference doPostAutoChunk), chunk uploads
        fanned out on the write window. `signatures` carries replication
        origins for sync loop prevention."""
        return self.write_file_stream(path, (data,), mime=mime,
                                      ttl_sec=ttl_sec, mode=mode,
                                      signatures=signatures)

    def write_file_stream(self, path: str, blocks, mime: str = "",
                          ttl_sec: int = 0, mode: int = 0o644,
                          signatures: list[int] | None = None) -> fpb.Entry:
        """Streaming auto-chunking write: `blocks` is an iterable of byte
        pieces (any sizes — repacked into chunk_size chunks as they
        arrive), uploaded through the windowed fan-out so peak memory is
        O(chunk_size x SWTPU_FILER_UPLOAD_CONC), not O(object). The md5
        fingerprint / ETag / chunk list are byte-identical to the
        buffered write_file (which is now a one-block call of this)."""
        directory, name = split_path(path)
        collection, replication, rule_ttl, _disk, _fsync = \
            self._storage_rule(path)
        ttl = volume_ttl(ttl_sec)
        if not ttl_sec and rule_ttl:
            # a path rule's ttl applies to entry expiry AND needle ttl;
            # the rule's own string goes to the volume side, which parses
            # it (the reference sends "<seconds>s", which TTL.parse
            # refuses, so every write under a TTL rule failed)
            from ..storage.types import TTL
            ttl_sec = TTL.parse(rule_ttl).seconds
            ttl = rule_ttl
        md5 = hashlib.md5(usedforsecurity=False)  # content fingerprint
        total = 0

        def chunked():
            nonlocal total
            buf = bytearray()
            off = 0
            for block in blocks:
                if not block:
                    continue
                md5.update(block)
                total += len(block)
                buf += block
                while len(buf) >= self.chunk_size:
                    piece = bytes(buf[:self.chunk_size])
                    del buf[:self.chunk_size]
                    yield off, piece
                    off += len(piece)
            if buf:
                yield off, bytes(buf)

        chunks = self._save_chunks_windowed(chunked(), ttl, path)
        data_fids = [c.file_id for c in chunks if c.file_id]
        try:
            chunks = maybe_manifestize(
                chunks, lambda d: self._save_blob(d, path=path))
            entry = fpb.Entry(name=name)
            entry.chunks.extend(chunks)
            a = entry.attributes
            a.file_size = total
            a.mime = mime or mimetypes.guess_type(name)[0] or ""
            a.file_mode = mode
            a.ttl_sec = ttl_sec
            a.md5 = md5.digest()
            a.collection, a.replication = collection, replication
            self.filer.create_entry(directory, entry, signatures=signatures)
        except BaseException:
            # the window landed but the object never became visible
            # (manifest upload or entry create failed): the no-orphan
            # guarantee covers this tail too — every DATA fid plus any
            # manifest blob that got saved (post-manifestize `chunks`
            # no longer lists the folded data fids, so keep both sets)
            landed = set(data_fids)
            landed.update(c.file_id for c in chunks if c.file_id)
            if landed:
                self._delete_chunks(sorted(landed))
            raise
        return entry

    # -- HTTP ---------------------------------------------------------------
    def _run_http(self) -> None:
        """The HTTP plane on utils/fastweb (the reference serves it through
        aiohttp): the namespace catch-all reads its body as a BodyStream
        and streams large GETs; the status, metrics and debug routes are
        exact paths, reserved for every method."""
        import asyncio

        from .. import tracing
        from ..stats import FILER_REQUEST_COUNTER, FILER_REQUEST_SECONDS
        from ..utils import fastweb
        from ..utils.fastweb import json_response

        async def handle(req: fastweb.Request):
            kind = req.method.lower()
            resp = None
            t0 = time.perf_counter()
            # server span continues the caller's trace; the blob-IO
            # child spans (filer.blob.write/read) land under it through
            # the executor hops (contextvars travel with them)
            with tracing.start_span(
                    f"filer.{kind}", component="filer",
                    child_of=tracing.extract(req.headers),
                    attrs={"path": req.path, "server": self.url}) as sp:
                with FILER_REQUEST_SECONDS.time(kind):
                    try:
                        if req.method in ("POST", "PUT"):
                            resp = await self._h_write(req)
                        elif req.method in ("GET", "HEAD"):
                            resp = await self._h_read(req)
                        elif req.method == "DELETE":
                            resp = await self._h_delete(req)
                        else:
                            resp = json_response(
                                {"error": "method not allowed"}, status=405)
                    except FileNotFoundError as e:
                        resp = json_response({"error": str(e)}, status=404)
                    except FileExistsError as e:
                        resp = json_response({"error": str(e)}, status=409)
                    except OSError as e:
                        resp = json_response({"error": str(e)}, status=409)
                    except Exception as e:  # noqa: BLE001
                        log.error("filer http: %r", e)
                        sp.set_error(e)
                        resp = json_response({"error": str(e)}, status=500)
                sp.set_attr("status", resp.status)
                # slow/errored requests land in the flight ring (no
                # stage split here — the filer's envelope is one stage)
                from ..profiling import record_flight
                record_flight(f"filer.{kind}", time.perf_counter() - t0,
                              status=resp.status, path=req.path,
                              node=self.url)
            FILER_REQUEST_COUNTER.inc(kind)
            return resp

        def status(req):
            return json_response({"version": "swtpu-filer",
                                  "master": self.mc.leader,
                                  "chunk_cache": self.chunk_cache.stats()})

        def metrics(req):
            from ..stats import scrape_payload
            body, ctype = scrape_payload(req.headers.get("Accept", ""))
            return fastweb.Response(body.encode(), content_type=ctype)

        def offloaded(handler):
            # store I/O and captures run off the loop, with the caller's
            # context, so they cannot stall the filer's other requests
            import contextvars

            async def h(req):
                ctx = contextvars.copy_context()
                return await asyncio.get_running_loop().run_in_executor(
                    None, ctx.run, handler, req)
            return h

        def status_ui(req):
            # human status UI (reference weed/server/filer_ui)
            from ..utils.ui import render_page
            rows = [[e.name + ("/" if e.is_directory else ""),
                     e.attributes.file_size, len(e.chunks)]
                    for e in self.filer.store.list_entries("/", limit=200)]
            mesh = (", ".join(self.aggregator.peers)
                    if self.aggregator is not None else "off")
            page = render_page(
                f"swtpu filer {self.url}",
                {"Master": self.mc.leader, "Store": self.filer.store.name,
                 "gRPC port": self.grpc_port,
                 "Chunk size": f"{self.chunk_size >> 20} MB",
                 "Mesh peers": mesh or "(none yet)",
                 "Signature": self.filer.signature},
                [("Root entries (first 200)",
                  ["name", "size", "chunks"], rows)])
            return fastweb.html_response(page)

        def get_only(handler):
            def h(req):
                if req.method != "GET":
                    return json_response({"error": "method not allowed"},
                                         status=405)
                return handler(dict(req.query))
            return h

        def debug_traces(q):
            return json_response(tracing.debug_traces_payload(q))

        def debug_events(q):
            from ..ops import events
            return json_response(events.debug_events_payload(q))

        def debug_locks(q):
            from ..utils import locktrack
            return json_response(locktrack.debug_locks_payload(q))

        def debug_profile(q):
            # shared /debug/profile contract (profiling package); the
            # filer has no guard plane — its gate is the method check all
            # four daemons share
            from .. import profiling as prof
            code, ctype, body = prof.handle_profile_query(q)
            return fastweb.Response(body.encode(), status=code,
                                    content_type=ctype.split(";")[0])

        def debug_flight(q):
            from .. import profiling as prof
            code, payload = prof.debug_flight_payload(q)
            return json_response(payload, status=code)

        app = fastweb.FastApp()
        app.route("/__status__", status)
        app.route("/__ui__", offloaded(status_ui))
        app.route("/__metrics__", metrics)
        # CPU by thread class, counted at each scrape of /__metrics__
        from ..profiling import THREAD_CPU
        THREAD_CPU.install()
        # exact debug routes win over the namespace catch-all for EVERY
        # method (a POST must not fall through and create a file no read
        # could reach): /debug/* is reserved, like /__status__
        app.route("/debug/traces", offloaded(get_only(debug_traces)))
        app.route("/debug/events", offloaded(get_only(debug_events)))
        app.route("/debug/locks", get_only(debug_locks))
        app.route("/debug/profile", offloaded(get_only(debug_profile)))
        app.route("/debug/flight", get_only(debug_flight))
        app.default(handle, stream_body=True)
        try:
            fastweb.serve_fast_app(
                app, self.ip, self.port, self._stop, logger=log,
                on_loop=getattr(self, "_loop_lag", None)
                and self._loop_lag.attach, ready=self._http_ready)
        except BaseException as e:  # noqa: BLE001 — start() reports it
            self._http_error = e
            self._http_ready.set()

    @staticmethod
    def _req_path(req) -> str:
        # fastweb hands the path percent-decoded already
        return req.path.rstrip("/") or "/"

    async def stream_write(self, stream, path: str, mime: str = "",
                           ttl_sec: int = 0, observer=None, finalize=None):
        """Write a streamed request body (a fastweb BodyStream) through
        write_file_stream on a worker thread, which reads the body's
        pieces as they arrive. Memory stays O(stream bound + chunk_size x
        conc) for any body size: the protocol pauses the socket while the
        body's queue is full, and the upload window pulls pieces only as
        slots free. A client that drops mid-body ends the pieces with an
        error, which aborts the write and deletes the chunks that landed
        (write_file_stream's no-orphan guarantee); nothing is published.
        `observer(piece)` sees every piece as it arrives (e.g. an
        incremental sha256); `finalize()` runs after the last piece and
        BEFORE the entry is committed — raising there aborts the write the
        same way."""
        import asyncio

        loop = asyncio.get_running_loop()
        ctx = contextvars.copy_context()

        def pieces():
            for piece in stream.blocking_iter(loop):
                if observer is not None:
                    observer(piece)
                yield piece
            if finalize is not None:
                finalize()

        try:
            return await loop.run_in_executor(
                self._stream_pool, ctx.run, self.write_file_stream, path,
                pieces(), mime, ttl_sec)
        finally:
            peaks = self.stream_peaks
            peaks["queued"] = max(peaks["queued"], stream.max_queued)
            peaks["piece"] = max(peaks["piece"], stream.max_piece)

    async def _h_write(self, req):
        import asyncio

        from ..utils import fastweb

        path = self._req_path(req)
        is_dir_target = req.path.endswith("/") and path != "/"
        mime = ""
        ttl_sec = _parse_ttl_sec(req.query.get("ttl", ""))
        ct = _content_type(req.headers.get("content-type"))
        if ct.startswith("multipart/"):
            # a form upload is held whole, as the reference's part.read()
            # holds it: the first part is the file
            body = await req.stream.read_all()
            data, filename, mime, _ = fastweb.parse_multipart_single(
                body, req.headers.get("content-type", ""))
            if filename and (is_dir_target or path == "/"):
                path = join_path(path, filename)
            entry = await asyncio.to_thread(self.write_file, path, data,
                                            mime, ttl_sec)
        else:
            if ct and ct not in ("application/octet-stream",):
                mime = ct
            # streaming ingest: the body is chunked AS IT ARRIVES and the
            # chunks fan out on the upload window
            entry = await self.stream_write(req.stream, path, mime, ttl_sec)
        return fastweb.json_response(
            {"name": entry.name, "size": entry.attributes.file_size},
            status=201)

    async def _h_read(self, req):
        import asyncio

        from ..utils import fastweb

        path = self._req_path(req)
        directory, name = split_path(path)
        entry = self.filer.find_entry(directory, name)
        if entry is None:
            raise FileNotFoundError(path)
        if entry.is_directory:
            limit = int(req.query.get("limit", "1000"))
            last = req.query.get("lastFileName", "")
            entries = list(self.filer.list_entries(path, start_from=last,
                                                   limit=limit))
            return fastweb.json_response({
                "Path": path,
                "Entries": [_entry_json(path, e) for e in entries],
                "Limit": limit,
                "LastFileName": entries[-1].name if entries else "",
            })
        fsize = entry.attributes.file_size or total_size(entry.chunks)
        ctype = entry.attributes.mime or "application/octet-stream"
        headers = {"Accept-Ranges": "bytes"}
        if entry.attributes.md5:
            headers["ETag"] = f'"{entry.attributes.md5.hex()}"'
        elif entry.chunks:
            headers["ETag"] = f'"{chunk_etag(list(entry.chunks))}"'
        start, stop = _http_range(req.headers.get("range"))
        offset = start or 0
        if offset < 0:  # suffix range "bytes=-N": last N bytes
            offset = max(0, fsize + offset)
            stop = fsize
        else:
            stop = stop if stop is not None else fsize
        stop = min(stop, fsize)
        status = 200 if (offset == 0 and stop >= fsize) else 206
        if status == 206:
            headers["Content-Range"] = f"bytes {offset}-{stop - 1}/{fsize}"
        if req.method == "HEAD":
            return fastweb.Response(iter(()), status=200, content_type=ctype,
                                    headers=headers, content_length=fsize)
        length = stop - offset
        if length <= self.chunk_size or \
                not (entry.chunks or entry.extended.get("remote")):
            # small/inline reads: one buffer, one write
            data = await asyncio.to_thread(self.read_entry_bytes, entry,
                                           offset, length)
            return fastweb.Response(data, status=status, content_type=ctype,
                                    headers=headers)
        # large objects stream window-by-window: each window's cold chunks
        # fan out on the reader pool while the previous one is on the wire
        return self.stream_entry(entry, offset, length, status, ctype,
                                 headers)

    def stream_entry(self, entry, offset: int, length: int, status: int,
                     ctype: str, headers: dict):
        """A streamed Response over read_entry_windows. fastweb pulls each
        window on a worker thread after the handler returns; the windows
        are read under the request's context, so their filer.blob.read
        spans stay in its trace. A failed window closes the connection:
        the client sees a body shorter than its Content-Length."""
        from ..utils import fastweb

        ctx = contextvars.copy_context()
        it = self.read_entry_windows(entry, offset, length)

        def windows():
            try:
                while True:
                    win = ctx.run(next, it, None)
                    if win is None:
                        return
                    yield win
            finally:
                it.close()
                peaks = self.stream_peaks
                peaks["window"] = max(peaks["window"], resp.max_piece)
                peaks["sent_buffered"] = max(peaks["sent_buffered"],
                                             resp.max_buffered)

        resp = fastweb.Response(windows(), status=status, content_type=ctype,
                                headers=headers, content_length=length)
        return resp

    async def _h_delete(self, req):
        import asyncio

        from ..utils import fastweb

        path = self._req_path(req)
        directory, name = split_path(path)
        recursive = req.query.get("recursive") == "true"
        await asyncio.to_thread(self.filer.delete_entry, directory, name,
                                True, recursive)
        return fastweb.Response(b"", status=204)

    # -- gRPC ---------------------------------------------------------------
    def _build_service(self) -> RpcService:
        svc = RpcService(FILER_SERVICE)
        f = self.filer

        @svc.unary("LookupDirectoryEntry", fpb.LookupDirectoryEntryRequest,
                   fpb.LookupDirectoryEntryResponse)
        def lookup(req, ctx):
            e = f.find_entry(req.directory, req.name)
            resp = fpb.LookupDirectoryEntryResponse()
            if e is None:
                ctx.abort(5, f"{join_path(req.directory, req.name)} not found")
            resp.entry.CopyFrom(e)
            return resp

        @svc.unary_stream("ListEntries", fpb.ListEntriesRequest,
                          fpb.ListEntriesResponse)
        def list_entries(req, ctx):
            for e in f.list_entries(req.directory, req.start_from_file_name,
                                    req.inclusive_start_from,
                                    req.limit or 2**31, req.prefix):
                yield fpb.ListEntriesResponse(entry=e)

        @svc.unary("CreateEntry", fpb.CreateEntryRequest,
                   fpb.CreateEntryResponse)
        def create(req, ctx):
            try:
                f.create_entry(req.directory, req.entry, o_excl=req.o_excl,
                               from_other_cluster=req.is_from_other_cluster,
                               signatures=list(req.signatures))
                return fpb.CreateEntryResponse()
            except (FileExistsError, OSError) as e:
                return fpb.CreateEntryResponse(error=str(e))

        @svc.unary("UpdateEntry", fpb.UpdateEntryRequest,
                   fpb.UpdateEntryResponse)
        def update(req, ctx):
            f.update_entry(req.directory, req.entry,
                           from_other_cluster=req.is_from_other_cluster,
                           touch_mtime=not req.keep_mtime)
            return fpb.UpdateEntryResponse()

        @svc.unary("AppendToEntry", fpb.AppendToEntryRequest,
                   fpb.AppendToEntryResponse)
        def append(req, ctx):
            f.append_chunks(req.directory, req.entry_name, list(req.chunks))
            return fpb.AppendToEntryResponse()

        @svc.unary("DeleteEntry", fpb.DeleteEntryRequest,
                   fpb.DeleteEntryResponse)
        def delete(req, ctx):
            try:
                f.delete_entry(req.directory, req.name,
                               is_delete_data=req.is_delete_data,
                               is_recursive=req.is_recursive,
                               from_other_cluster=req.is_from_other_cluster)
                return fpb.DeleteEntryResponse()
            except OSError as e:
                if req.ignore_recursive_error:
                    return fpb.DeleteEntryResponse()
                return fpb.DeleteEntryResponse(error=str(e))

        @svc.unary("AtomicRenameEntry", fpb.AtomicRenameEntryRequest,
                   fpb.AtomicRenameEntryResponse)
        def rename(req, ctx):
            f.rename(req.old_directory, req.old_name,
                     req.new_directory, req.new_name)
            return fpb.AtomicRenameEntryResponse()

        @svc.unary("LinkEntry", fpb.LinkEntryRequest, fpb.LinkEntryResponse)
        def link(req, ctx):
            # errno-tagged error strings so the remote client can surface
            # the right POSIX error instead of collapsing all to ENOENT
            try:
                f.link(req.old_directory, req.old_name,
                       req.new_directory, req.new_name)
                return fpb.LinkEntryResponse()
            except FileNotFoundError as e:
                return fpb.LinkEntryResponse(error=f"ENOENT:{e}")
            except IsADirectoryError as e:
                return fpb.LinkEntryResponse(error=f"EISDIR:{e}")
            except FileExistsError as e:
                return fpb.LinkEntryResponse(error=f"EEXIST:{e}")

        @svc.unary("AssignVolume", fpb.AssignVolumeRequest,
                   fpb.AssignVolumeResponse)
        def assign(req, ctx):
            try:
                collection, replication, rule_ttl, disk, _fsync = \
                    self._storage_rule(req.path)
                collection = req.collection or collection
                replication = req.replication or replication
                a = self.mc.assign(count=req.count or 1,
                                   collection=collection,
                                   replication=replication,
                                   ttl=(volume_ttl(req.ttl_sec)
                                        if req.ttl_sec else rule_ttl),
                                   disk_type=req.disk_type or disk)
                return fpb.AssignVolumeResponse(
                    file_id=a.fid, location_url=a.location.url,
                    public_url=a.location.public_url, count=a.count,
                    collection=collection, replication=replication,
                    auth=a.auth)
            except Exception as e:  # noqa: BLE001
                return fpb.AssignVolumeResponse(error=str(e))

        @svc.unary("LookupVolume", fpb.LookupVolumeRequest,
                   fpb.LookupVolumeResponse)
        def lookup_volume(req, ctx):
            resp = fpb.LookupVolumeResponse()
            for vid_str in req.volume_or_file_ids:
                vid = int(vid_str.split(",")[0])
                locs = fpb.Locations()
                for l in self.mc.lookup(vid):
                    locs.locations.add(url=l["url"],
                                       public_url=l["public_url"],
                                       grpc_port=l["grpc_port"])
                resp.locations_map[vid_str].CopyFrom(locs)
            return resp

        @svc.unary("GetFilerConfiguration",
                   fpb.GetFilerConfigurationRequest,
                   fpb.GetFilerConfigurationResponse)
        def get_configuration(req, ctx):
            import time as _time
            return fpb.GetFilerConfigurationResponse(
                masters=self.mc.masters, collection=self.collection,
                replication=self.replication,
                max_mb=self.chunk_size >> 20,
                signature=f.signature, now_ns=_time.time_ns())

        @svc.unary("KvGet", fpb.KvGetRequest, fpb.KvGetResponse)
        def kv_get(req, ctx):
            v = f.store.kv_get(bytes(req.key))
            return fpb.KvGetResponse(value=v or b"",
                                     error="" if v is not None else "not found")

        @svc.unary("KvPut", fpb.KvPutRequest, fpb.KvPutResponse)
        def kv_put(req, ctx):
            f.store.kv_put(bytes(req.key), bytes(req.value))
            return fpb.KvPutResponse()

        @svc.unary("Statistics", fpb.StatisticsRequest, fpb.StatisticsResponse)
        def statistics(req, ctx):
            return fpb.StatisticsResponse()

        @svc.unary_stream("SubscribeMetadata", fpb.SubscribeMetadataRequest,
                          fpb.SubscribeMetadataResponse)
        def subscribe(req, ctx):
            stop = threading.Event()
            ctx.add_callback(stop.set)
            for resp in f.meta_log.subscribe(req.since_ns, stop):
                if req.path_prefix and not _under_prefix(resp.directory,
                                                         req.path_prefix):
                    continue
                if req.signature and req.signature in \
                        resp.event_notification.signatures:
                    continue  # skip events this subscriber itself caused
                yield resp

        @svc.unary("Ping", fpb.PingRequest, fpb.PingResponse)
        def ping(req, ctx):
            import time as _time
            now = _time.time_ns()
            return fpb.PingResponse(start_time_ns=now, remote_time_ns=now,
                                    stop_time_ns=_time.time_ns())

        @svc.unary("PurgeMetaLog", fpb.PurgeMetaLogRequest,
                   fpb.PurgeMetaLogResponse)
        def purge_meta_log(req, ctx):
            """shell fs.log.purge (reference command_fs_log_purge.go)."""
            return fpb.PurgeMetaLogResponse(
                purged=f.meta_log.purge(req.before_ns))

        @svc.unary_stream("SubscribeLocalMetadata",
                          fpb.SubscribeMetadataRequest,
                          fpb.SubscribeMetadataResponse)
        def subscribe_local(req, ctx):
            """Reference SubscribeLocalMetadata (filer.proto): only events
            that ORIGINATED at this filer — i.e. NOT relayed from a mesh
            peer. Mesh-relayed events carry a known peer filer's
            signature; externally-signed local writes (filer.sync imports
            from another cluster, which tag the source cluster's
            signature) still count as local and must propagate through
            the mesh."""
            stop = threading.Event()
            ctx.add_callback(stop.set)
            for resp in f.meta_log.subscribe(req.since_ns, stop):
                if req.path_prefix and not _under_prefix(resp.directory,
                                                         req.path_prefix):
                    continue
                sigs = set(resp.event_notification.signatures)
                peer_sigs = (set(self.aggregator.peer_signatures)
                             if self.aggregator is not None else set())
                if sigs & peer_sigs:
                    continue  # relayed from a mesh peer: never re-relay
                yield resp

        return svc


def _under_prefix(directory: str, prefix: str) -> bool:
    """True iff directory lies on the subscribed subtree path, respecting
    '/' boundaries (so /data does not match /database)."""
    p = prefix.rstrip("/") or "/"
    if directory == p or p == "/":
        return True
    return directory.startswith(p + "/") or p.startswith(directory.rstrip("/") + "/")


def _entry_json(directory: str, e: fpb.Entry) -> dict:
    return {
        "FullPath": join_path(directory, e.name),
        "IsDirectory": e.is_directory,
        "FileSize": e.attributes.file_size,
        "Mtime": e.attributes.mtime,
        "Crtime": e.attributes.crtime,
        "Mime": e.attributes.mime,
        "Mode": e.attributes.file_mode,
        "TtlSec": e.attributes.ttl_sec,
        "chunkCount": len(e.chunks),
    }


def _content_type(raw: "str | None") -> str:
    """A request's media type without parameters, lower-cased, as aiohttp's
    `request.content_type` gives it: application/octet-stream when the
    header is absent or malformed."""
    if raw is None:
        return "application/octet-stream"
    import email.message
    m = email.message.Message()
    m.set_default_type("application/octet-stream")
    m["Content-Type"] = raw
    return m.get_content_type()


def _http_range(raw: "str | None") -> "tuple[int | None, int | None]":
    """A Range header as aiohttp's `request.http_range` parses it, as
    (start, stop) of a slice: `bytes=a-b` -> (a, b + 1), `bytes=a-` ->
    (a, None), `bytes=-n` -> (-n, None); no header -> (None, None). A
    malformed one raises ValueError (a 500, as in the reference)."""
    if raw is None:
        return None, None
    import re
    m = re.findall(r"^bytes=(\d*)-(\d*)$", raw)
    if not m:
        raise ValueError("range not in acceptable format")
    start_s, end_s = m[0]
    end = int(end_s) if end_s else None
    start = int(start_s) if start_s else None
    if start is None and end is not None:
        start, end = -end, None
    if start is not None and end is not None:
        end += 1
        if start >= end:
            raise ValueError("start cannot be after end")
    if start is None and end is None:
        raise ValueError("No start or end of range specified")
    return start, end


_TTL_UNITS = (("y", 31536000), ("M", 2592000), ("w", 604800),
              ("d", 86400), ("h", 3600), ("m", 60))


def volume_ttl(ttl_sec: int) -> str:
    """A TTL of `ttl_sec` seconds as the volume side's TTL.parse reads it:
    a count of at most 255 (the needle's one-byte count) in the largest
    unit that divides it, else rounded up to the smallest unit that fits
    (the volume side counts no seconds: 90 s keeps a needle 2 minutes).
    "" for no TTL. The reference sends "<seconds>s", which TTL.parse
    refuses (ROADMAP Queue 3: a filer write with a TTL failed)."""
    if ttl_sec <= 0:
        return ""
    for suffix, unit in _TTL_UNITS:
        if ttl_sec % unit == 0 and ttl_sec // unit <= 255:
            return f"{ttl_sec // unit}{suffix}"
    for suffix, unit in reversed(_TTL_UNITS):
        count = -(-ttl_sec // unit)
        if count <= 255:
            return f"{count}{suffix}"
    return "255y"


def _parse_ttl_sec(s: str) -> int:
    if not s:
        return 0
    units = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800,
             "M": 2592000, "y": 31536000}
    if s[-1] in units:
        return int(s[:-1]) * units[s[-1]]
    return int(s)
