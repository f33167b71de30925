"""Client verbs: assign+upload+read+delete against the cluster.

Reference: weed/operation/{assign_file_id,upload_content,submit,delete_content}.go.
Sync HTTP over the keep-alive pool in http_util (the reference's Go
http.Client reuses connections the same way; `requests` cost ~1 ms of
client CPU per call, which dominated the small-file data plane).

The port's copy of seaweedfs_tpu/client/operation.py, with its imports
rewired to the port's tracing, storage, utils, stats, pb and client
modules. Requests go out through the port's http_util, which also sends
the calling flow's QoS class as the `x-swtpu-qos` header. Nothing else
differs: fids, frames, retries and the read fallbacks are the reference's.
"""

from __future__ import annotations

import gzip as _gzip
import time
from dataclasses import dataclass

from .. import tracing
from ..storage.types import file_id, parse_file_id
from ..utils import failpoints, retry
from ..utils.env import env_int
from . import http_util
from .master_client import FidLeaseAllocator, MasterClient

# Per-frame packing caps for submit_batch: enough needles to amortize
# the PUT protocol to noise, small enough that one frame stays far
# under the volume server's 256 MB body cap and a retry re-sends
# megabytes, not the whole batch.
BULK_MAX_FRAME_NEEDLES = env_int("SWTPU_BULK_FRAME_NEEDLES", 1024)
BULK_MAX_FRAME_BYTES = env_int("SWTPU_BULK_FRAME_BYTES", 8 << 20)
# Keys per bulk-GET frame (read_batch): response frames are bounded by
# the needles themselves, so the cap only bounds the per-frame blast
# radius of a retry.
BULK_READ_FRAME_NEEDLES = env_int("SWTPU_BULK_READ_NEEDLES", 1024)


@dataclass
class UploadResult:
    fid: str
    url: str
    size: int
    e_tag: str = ""
    name: str = ""


def upload(url: str, data: bytes, name: str = "", mime: str = "",
           gzip_if_worthwhile: bool = True, ttl: str = "",
           jwt: str = "", fsync: bool = False) -> dict:
    """PUT one blob to a volume server (reference upload_content.go:151).
    `jwt` is the single-fid write token the master minted on Assign;
    `fsync` asks the volume server to fsync before acking (reference
    UploadOption.Fsync — a filer path rule's fsync flag lands here)."""
    with tracing.start_span("client.upload", component="client",
                            attrs={"url": url, "bytes": len(data)}):
        return _upload(url, data, name=name, mime=mime,
                       gzip_if_worthwhile=gzip_if_worthwhile, ttl=ttl,
                       jwt=jwt, fsync=fsync)


def _upload(url: str, data: bytes, name: str = "", mime: str = "",
            gzip_if_worthwhile: bool = True, ttl: str = "",
            jwt: str = "", fsync: bool = False) -> dict:
    failpoints.check("client.upload")
    body = data
    gzipped = False
    compressible = (mime.startswith("text/") or name.endswith((".txt", ".json",
                    ".html", ".css", ".js", ".csv", ".xml", ".log")))
    if gzip_if_worthwhile and compressible and len(data) > 128:
        gz = _gzip.compress(data, 6)
        if len(gz) < len(data) * 0.9:
            body = gz
            gzipped = True
    params = {"ttl": ttl} if ttl else {}
    if jwt:
        params["jwt"] = jwt
    if fsync:
        params["fsync"] = "true"
    if name:
        part_headers = {"Content-Encoding": "gzip"} if gzipped else {}
        mp_body, ctype = http_util.multipart_body(
            "file", name, body, mime or "application/octet-stream",
            part_headers)
        r = http_util.post(f"http://{url}", body=mp_body,
                           headers={"Content-Type": ctype}, params=params)
    else:
        headers = {"Content-Type": mime or "application/octet-stream"}
        if gzipped:
            headers["Content-Encoding"] = "gzip"
        r = http_util.post(f"http://{url}", body=body, headers=headers,
                           params=params)
    if not r.ok:
        raise RuntimeError(f"upload to {url}: HTTP {r.status} "
                           f"{r.content[:200]!r}")
    return r.json()


def submit(mc: MasterClient, data: bytes, name: str = "", mime: str = "",
           collection: str = "", replication: str = "", ttl: str = "",
           retries: int = 3) -> UploadResult:
    """Assign a fid then upload (reference submit.go:58). Each retry
    gets a FRESH assign (the previous target may be the dead node), with
    full-jitter backoff and an overall deadline via the shared
    fault-tolerance envelope (utils/retry.py)."""

    stop_at = time.monotonic() + retry.WRITE_POLICY.deadline

    def attempt() -> UploadResult:
        # the enclosing envelope's wall clock bounds the inner assign
        # sweeps too — nested envelopes share one budget
        a = mc.assign(collection=collection, replication=replication,
                      ttl=ttl, deadline=stop_at)
        target = a.location.public_url or a.location.url
        tracing.add_event("assigned", fid=a.fid, target=target)
        res = upload(f"{target}/{a.fid}", data, name=name, mime=mime,
                     ttl=ttl, jwt=a.auth)
        return UploadResult(fid=a.fid, url=target,
                            size=res.get("size", len(data)),
                            e_tag=res.get("eTag", ""),
                            name=res.get("name", name))

    with tracing.start_span("client.submit", component="client",
                            attrs={"bytes": len(data), "name": name,
                                   "collection": collection}) as sp:
        try:
            result = retry.retry_call(
                attempt, op="client.submit",
                policy=retry.WRITE_POLICY.with_(max_attempts=retries))
            sp.set_attr("fid", result.fid)
            return result
        except Exception as e:
            raise RuntimeError(f"submit failed after {retries} tries: {e}") \
                from e


def submit_batch(mc: MasterClient, payloads: "list[bytes]",
                 collection: str = "", replication: str = "", ttl: str = "",
                 allocator: "FidLeaseAllocator | None" = None,
                 retries: int = 3) -> "list[UploadResult]":
    """Bulk ingest: lease fid ranges and pack many needles per PUT.

    Where submit() pays one master assign + one HTTP PUT per needle,
    this path takes fids from a FidLeaseAllocator (one assign per
    SWTPU_FID_LEASE_COUNT keys) and ships each contiguous run as ONE
    framed /bulk request over the keep-alive pool — the control plane
    amortizes to ~1/N of the per-needle cost and the volume server
    appends the whole frame under a single lock + fsync.

    A failed frame retries with FRESH fids (the attempted range may
    have partially landed on some replica — reusing it could alias two
    payloads under one fid); the failing lease is discarded so the
    retry re-leases against live topology. The retry budget is
    PER FRAME — `failures` resets and the deadline re-arms on every
    frame success — so a batch that streams for minutes survives
    unrelated transient hiccups; only `retries` consecutive frame
    failures (or one frame exceeding the write deadline) raise.
    Needles acked before a raise are durable but unreported, like any
    partially-failed batch API.
    """
    if not payloads:
        return []
    if allocator is not None:
        # placement/expiry come from the allocator's leases — an
        # explicit arg that CONTRADICTS it would be silently ignored
        # (needles land without the requested redundancy/ttl), so
        # conflicts are errors and blanks inherit the allocator's
        for name, ours, theirs in (("collection", collection,
                                    allocator.collection),
                                   ("replication", replication,
                                    allocator.replication),
                                   ("ttl", ttl, allocator.ttl)):
            if ours and ours != theirs:
                raise ValueError(
                    f"submit_batch {name}={ours!r} conflicts with the "
                    f"allocator's {name}={theirs!r} — leases are placed "
                    f"with the allocator's settings")
        ttl = ttl or allocator.ttl
    alloc = allocator or FidLeaseAllocator(
        mc, collection=collection, replication=replication, ttl=ttl)
    results: "list[UploadResult]" = []
    pol = retry.WRITE_POLICY
    stop_at = time.monotonic() + pol.deadline
    frames = 0
    failures = 0
    with tracing.start_span(
            "client.submit_batch", component="client",
            attrs={"needles": len(payloads),
                   "bytes": sum(len(p) for p in payloads),
                   "collection": collection}) as sp:
        idx = 0
        while idx < len(payloads):
            failpoints.check("client.bulk.submit")
            # frame sizing: cap by needle count AND payload bytes so one
            # frame never balloons past the server's body limit (at
            # least one needle always ships, however large)
            want, budget = 0, BULK_MAX_FRAME_BYTES
            for p in payloads[idx:idx + BULK_MAX_FRAME_NEEDLES]:
                if want and len(p) > budget:
                    break
                budget -= len(p)
                want += 1
            lease, start, got = alloc.take(want)
            chunk = payloads[idx:idx + got]
            from ..storage import bulk as bulk_frame
            frame = bulk_frame.pack_frame(
                lease.vid,
                [(start + i, lease.cookie, data, 0)
                 for i, data in enumerate(chunk)])
            target = lease.public_url or lease.url
            params: dict = {"vid": lease.vid}
            if ttl:
                params["ttl"] = ttl
            if lease.auth:
                params["jwt"] = lease.auth
            try:
                r = http_util.request("PUT", f"http://{target}/bulk",
                                      body=frame, params=params)
                if not r.ok:
                    raise RuntimeError(f"bulk put to {target}: HTTP "
                                       f"{r.status} {r.content[:200]!r}")
            except Exception as e:  # noqa: BLE001
                alloc.discard(lease)
                failures += 1
                delay = pol.backoff(failures)
                if (failures >= retries
                        or time.monotonic() + delay > stop_at
                        or not retry.BUDGET.withdraw()):
                    sp.set_error(e)
                    raise RuntimeError(
                        f"submit_batch failed after {failures} tries at "
                        f"needle {idx}/{len(payloads)}: {e}") from e
                from ..stats import RETRY_ATTEMPTS
                RETRY_ATTEMPTS.inc("client.submit_batch")
                tracing.add_event("retry", op="client.submit_batch",
                                  attempt=failures, target=target,
                                  delay_ms=round(delay * 1e3, 2),
                                  error=str(e)[:200])
                time.sleep(delay)
                continue
            etags = r.json().get("eTags", [])
            results.extend(
                UploadResult(fid=file_id(lease.vid, start + i, lease.cookie),
                             url=target, size=len(data),
                             e_tag=etags[i] if i < len(etags) else "")
                for i, data in enumerate(chunk))
            idx += got
            frames += 1
            failures = 0  # per-frame budget: a landed frame clears it
            stop_at = time.monotonic() + pol.deadline
        sp.set_attr("frames", frames)
        sp.set_attr("leases", alloc.leases_taken)
    return results


def read(mc: MasterClient, fid: str, jwt: str = "") -> bytes:
    """Fetch a blob by fid, trying each replica (wdclient vid_map round-robin).

    A 404 or connection failure may just mean the cached location is stale
    (volume moved/evacuated), so one refreshed-lookup retry pass runs before
    giving up (LookupFileIdWithFallback masterclient.go:59).
    Pass `jwt` (a read-key token) when the cluster read-gates volumes."""
    with tracing.start_span("client.read", component="client",
                            attrs={"fid": fid}):
        return _read(mc, fid, jwt=jwt)


def _read(mc: MasterClient, fid: str, jwt: str = "") -> bytes:
    failpoints.check("client.read")
    vid, _, _ = parse_file_id(fid)
    last_err: Exception | None = None
    params = {"jwt": jwt} if jwt else None
    all_404 = False
    urls: list[str] = []

    def _netloc(u: str) -> str:
        rest = u.split("://", 1)[-1]
        return rest.split("/", 1)[0]

    for attempt in range(2):
        saw_404 = saw_other_err = False
        try:
            urls = mc.lookup_file_id(fid)
        except KeyError as e:
            last_err = e
            urls = []
        # replicas with open breakers go last: a known-dead holder should
        # cost us nothing while a healthy replica can serve the read
        # (http_util records the per-peer outcomes). Only the LAST
        # candidate attempts through an open breaker — earlier ones fail
        # fast and move on, but the read always keeps one real attempt.
        ordered = retry.order_by_breaker(urls, key=_netloc)
        for i, url in enumerate(ordered):
            try:
                r = http_util.get(url, params=params,
                                  fail_fast_open=i < len(ordered) - 1)
                # a volume server in read_mode=redirect answers 301/302
                # with the holder's URL (volume_server _read_remote)
                hops = 0
                while r.status in (301, 302, 307, 308) and hops < 3:
                    loc = r.headers.get("Location")
                    if not loc:
                        break
                    r = http_util.get(loc)
                    hops += 1
                if r.status == 404:
                    saw_404 = True
                    continue
                if r.status >= 300:
                    raise RuntimeError(f"HTTP {r.status} from {url}")
                return r.content
            except retry.BreakerOpenError as e:
                # a SKIP, not evidence about the file: the healthy
                # replicas' 404s stay authoritative (a circuit-open
                # holder diverging from its replica set is the smaller
                # risk than 5xx-ing definitively-deleted files forever)
                last_err = e
            except Exception as e:  # noqa: BLE001
                saw_other_err = True
                last_err = e
        all_404 = bool(urls) and saw_404 and not saw_other_err
        if attempt == 0:
            try:
                fresh = mc.refresh_lookup(vid)
            except KeyError as e:
                last_err = e
                break  # master says the volume is gone: authoritative
            except Exception as e:  # noqa: BLE001
                # refresh itself failed (master outage): the 404s were
                # never re-validated, so report retryable, not not-found
                last_err = e
                all_404 = False
                break
            if all_404 and set(
                    MasterClient.location_urls(fresh, fid)) == set(urls):
                # same replica set re-answered 404 — authoritative
                # not-found; skip the redundant second sweep
                raise KeyError(fid)
    if all_404 or isinstance(last_err, KeyError):
        raise KeyError(fid) if all_404 else last_err
    raise RuntimeError(f"read {fid} failed: {last_err}")


def read_batch(mc: MasterClient, fids: "list[str]", jwt: str = "",
               ) -> "list[bytes | None]":
    """Bulk GET: fetch many blobs with one framed /bulk-read round-trip
    per (vid, frame) instead of one HTTP GET per fid — the read-side
    mirror of submit_batch. Fids are grouped by vid client-side and
    each group ships as "SWBR" request frames (storage/bulk.py) of up
    to SWTPU_BULK_READ_NEEDLES keys; the volume server resolves a whole
    frame in one index pass and streams the needles back in a single
    length-prefixed response.

    Returns payload bytes per fid, aligned with the input (None = not
    found / deleted — per-needle statuses ride the frame, so misses
    don't fail the batch). Transport failures AND per-needle
    READ_ERROR statuses (bad sector, crc mismatch on one holder) retry
    across replica holders breaker-ordered, with one refreshed-lookup
    pass when a holder 404s the volume (moved/evacuated) — the same
    fallback discipline as read(); an error that persists on every
    holder raises instead of masquerading as not-found. Needles the
    server's per-frame byte budget couldn't carry (READ_OVERFLOW) are
    transparently re-fetched per-needle. Gzip-flagged needles are
    decompressed so the result matches read() byte-for-byte.

    `jwt` scope: read tokens are per-fid, and the volume server admits
    a frame only if the token covers EVERY fid in it — on clusters with
    read signing enabled, bulk reads are for whitelisted callers (or
    single-fid frames); per-fid-token clients use read()."""
    if not fids:
        return []
    results: "list[bytes | None]" = [None] * len(fids)
    by_vid: "dict[int, list[tuple[int, int, int]]]" = {}
    for i, fid in enumerate(fids):
        vid, key, cookie = parse_file_id(fid)
        by_vid.setdefault(vid, []).append((i, key, cookie))
    with tracing.start_span("client.read_batch", component="client",
                            attrs={"needles": len(fids),
                                   "vids": len(by_vid)}) as sp:
        frames = 0
        for vid, items in by_vid.items():
            for at in range(0, len(items), BULK_READ_FRAME_NEEDLES):
                _read_one_frame(mc, vid,
                                items[at:at + BULK_READ_FRAME_NEEDLES],
                                results, jwt)
                frames += 1
        sp.set_attr("frames", frames)
    return results


def _read_one_frame(mc: MasterClient, vid: int,
                    items: "list[tuple[int, int, int]]",
                    results: "list[bytes | None]", jwt: str) -> None:
    """One bulk-read frame against vid's replica set: healthy holders
    first (breaker ordering), a refreshed lookup when every holder
    404s/fails (stale location after a move), per-needle statuses
    decoded into `results`."""
    from ..storage import bulk as bulk_frame

    failpoints.check("client.bulk.read")
    frame = bulk_frame.pack_read_request(vid, [(k, c) for _, k, c in items])
    params: dict = {"vid": vid}
    if jwt:
        params["jwt"] = jwt
    last_err: "Exception | None" = None
    for attempt in range(2):
        try:
            locs = mc.lookup(vid) if attempt == 0 else mc.refresh_lookup(vid)
        except KeyError:
            raise  # master says the volume is gone: authoritative
        urls = [loc["public_url"] or loc["url"] for loc in locs]
        for i, url in enumerate(retry.order_by_breaker(urls)):
            try:
                r = http_util.request(
                    "POST", f"http://{url}/bulk-read", body=frame,
                    params=params, fail_fast_open=i < len(urls) - 1)
                if r.status == 404:
                    # this holder no longer serves the vid — try the
                    # next, then a refreshed lookup
                    last_err = RuntimeError(f"HTTP 404 from {url}")
                    continue
                if not r.ok:
                    raise RuntimeError(f"bulk read from {url}: HTTP "
                                       f"{r.status} {r.content[:200]!r}")
                rvid, res = bulk_frame.unpack_read_response(r.content)
                if rvid != vid or len(res) != len(items):
                    raise RuntimeError(
                        f"bulk read from {url}: frame mismatch "
                        f"(vid {rvid}, {len(res)} results)")
                errored = []
                overflow = []
                for (idx, key, _cookie), rr in zip(items, res):
                    if rr.key != key:
                        raise RuntimeError(
                            f"bulk read from {url}: result for "
                            f"{rr.key:x}, wanted {key:x}")
                    if rr.status == bulk_frame.READ_OK:
                        data = bytes(rr.data)
                        if rr.flags & 0x01:
                            data = _gzip.decompress(data)
                        results[idx] = data
                    elif rr.status == bulk_frame.READ_OVERFLOW:
                        overflow.append((idx, key, _cookie))
                    elif rr.status == bulk_frame.READ_ERROR:
                        errored.append(key)
                    else:
                        results[idx] = None  # definitive not-found
                if errored:
                    # an IO/crc failure on THIS holder is not evidence
                    # about the needle — another replica may hold intact
                    # bytes; retry the frame there instead of reporting
                    # corruption as "deleted"
                    last_err = RuntimeError(
                        f"bulk read from {url}: {len(errored)} needle "
                        f"errors (e.g. {errored[0]:x})")
                    continue
                for idx, key, cookie in overflow:
                    # the server's frame byte-budget couldn't carry it:
                    # fetch the large needle through the per-needle path
                    # (which also resolves existence — an overflow slot
                    # the server didn't probe may turn out deleted)
                    try:
                        results[idx] = _read(mc, file_id(vid, key, cookie),
                                             jwt=jwt)
                    except KeyError:
                        results[idx] = None
                return
            except retry.BreakerOpenError as e:
                last_err = e  # a skip, not evidence about the holders
            except Exception as e:  # noqa: BLE001
                last_err = e
    raise RuntimeError(f"bulk read vid {vid} failed: {last_err}")


def delete(mc: MasterClient, fid: str) -> bool:
    with tracing.start_span("client.delete", component="client",
                            attrs={"fid": fid}):
        jwt = mc.lookup_file_id_jwt(fid)
        params = {"jwt": jwt} if jwt else None
        ok = False
        for url in mc.lookup_file_id(fid):
            r = http_util.delete(url, params=params)
            ok = ok or r.status in (200, 202)
            break  # server fans out to replicas itself
        return ok


def delete_batch(mc: MasterClient, fids: list[str]) -> int:
    """Group by volume and use the BatchDelete gRPC (filer chunk GC path)."""
    from ..pb import volume_server_pb2 as vpb
    from ..utils.rpc import Stub, VOLUME_SERVICE

    by_server: dict[str, list[str]] = {}
    for fid in fids:
        vid, _, _ = parse_file_id(fid)
        locs = mc.lookup(vid)
        if locs:
            grpc_addr = _grpc_addr(locs[0])
            by_server.setdefault(grpc_addr, []).append(fid)
    deleted = 0
    for addr, group in by_server.items():
        stub = Stub(addr, VOLUME_SERVICE)
        resp = stub.call("BatchDelete", vpb.BatchDeleteRequest(file_ids=group),
                         vpb.BatchDeleteResponse)
        deleted += sum(1 for r in resp.results if r.status == 202)
    return deleted


def query(mc: MasterClient, fids: list[str], *, field: str = "",
          op: str = "", value: str = "", projections: list[str] | None = None,
          input_format: str = "json", csv_has_header: bool = False,
          output_format: str = "json") -> bytes:
    """S3-Select-lite scan of blobs on their volume servers
    (reference volume Query RPC, weed/server/volume_grpc_query.go)."""
    from ..pb import volume_server_pb2 as vpb
    from ..utils.rpc import Stub, VOLUME_SERVICE

    out = bytearray()
    by_server: dict[str, list[str]] = {}
    for fid in fids:
        vid, _, _ = parse_file_id(fid)
        locs = mc.lookup(vid)
        if not locs:
            raise KeyError(f"volume {vid} not found")
        by_server.setdefault(_grpc_addr(locs[0]), []).append(fid)
    for addr, group in by_server.items():
        req = vpb.QueryRequest(from_file_ids=group)
        req.filter.field, req.filter.operand, req.filter.value = field, op, value
        req.projections.extend(projections or [])
        req.input_serialization.format = input_format
        req.input_serialization.csv_has_header = csv_has_header
        req.output_serialization.format = output_format
        stub = Stub(addr, VOLUME_SERVICE)
        for stripe in stub.call_stream("Query", req, vpb.QueriedStripe):
            out.extend(stripe.records)
    return bytes(out)


def _grpc_addr(loc: dict) -> str:
    host = loc["url"].rsplit(":", 1)[0]
    return f"{host}:{loc['grpc_port']}"
