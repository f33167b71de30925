"""S3 gateway: AWS-compatible REST API over the filer namespace.

Reference: weed/s3api (14,018 LoC — SURVEY.md §2.6): s3api_server.go:109
(router), s3api_object_handlers_put.go, filer_multipart.go (multipart
completes by concatenating part chunk lists), s3api_object_tagging.go,
s3api_bucket_handlers.go. Buckets map to filer dirs /buckets/<bucket>,
object keys to paths beneath. Multipart completion is zero-copy: the final
entry references the parts' chunks with rebased offsets.

The port's copy of seaweedfs_tpu/s3/s3_server.py. Its differences:
* The HTTP plane runs on the port's utils/fastweb, not aiohttp (the port
  has none), as the port's filer does. The bucket/key catch-all reads its
  body as a fastweb BodyStream (`app.default(..., stream_body=True)`); the
  operator routes (/debug/*, /metrics, /__metrics__) are exact routes,
  reserved for every method. A handler that does not consume the body
  drains it before the answer, so a keep-alive client always reads its
  status. `_S3Request` shows a fastweb Request to the handlers as the
  reference's aiohttp request: the decoded path, the query (a dict:
  `?uploads` and `?acl` come in as ""), case-insensitive headers (a plain
  dict: a repeated header keeps its last value), `content_type` and
  `http_range` as aiohttp parses them, and the per-request identity.
* A streamed PutObject/UploadPart hands the BodyStream to the port's
  FilerServer.stream_write with the reference's `observer` (the
  incremental sha256) and `finalize` (the digest check, before the entry
  commits). A large GET goes out as a fastweb streamed Response over
  FilerServer.stream_entry (`read_entry_windows`); a HEAD states the
  object's length with no body, as aiohttp's does.
* The object and bucket handlers, which call the filer synchronously, run
  on a worker thread (with the request's context) rather than on the
  loop; the QoS admission and the streamed PUT stay on the loop.
* A request line's raw non-ASCII bytes reach the handlers latin-1
  decoded (fastweb's head parser), where aiohttp decodes them as UTF-8;
  clients percent-encode keys, and those decode alike.
* The gateway does no device work and imports no torch.
"""

from __future__ import annotations

import asyncio
import hashlib
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from ..filer.chunks import total_size
from ..filer.filer import join_path, split_path
from ..pb import filer_pb2 as fpb
from ..utils import fastweb
from ..utils.log import logger
from .auth import (ACTION_LIST, ACTION_READ, ACTION_TAGGING, ACTION_WRITE,
                   IdentityAccessManagement, S3Error)

log = logger("s3")

BUCKETS_DIR = "/buckets"


def _parse_multipart_form(body: bytes, content_type: str
                          ) -> "tuple[dict, str, bytes]":
    """(fields, file_name, file_bytes) from a multipart/form-data body."""
    import email.parser
    import email.policy

    parser = email.parser.BytesParser(policy=email.policy.HTTP)
    msg = parser.parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    fields: dict = {}
    file_name, file_bytes = "", b""
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        lower = name.lower()
        if lower == "file":
            file_name = part.get_filename() or ""
            file_bytes = part.get_payload(decode=True) or b""
            ctype = part.get_content_type()
            if ctype and ctype != "text/plain":
                fields.setdefault("Content-Type", ctype)
        else:
            payload = part.get_payload(decode=True) or b""
            # AWS matches policy/x-amz-* form fields case-insensitively
            key_name = (lower if lower.startswith("x-amz")
                        or lower in ("policy", "key", "bucket",
                                     "success_action_status",
                                     "content-type") else name)
            fields[key_name] = payload.decode("utf-8", errors="replace")
    return fields, file_name, file_bytes
UPLOADS_DIR = ".uploads"  # hidden per-bucket multipart staging dir
TAG_PREFIX = "x-amz-tag-"
HIGH = "\U0010FFFF"

ErrNoSuchBucket = lambda b: S3Error("NoSuchBucket",  # noqa: E731
                                    f"The specified bucket does not exist: {b}", 404)
ErrNoSuchKey = lambda k: S3Error("NoSuchKey",  # noqa: E731
                                 f"The specified key does not exist: {k}", 404)
ErrBucketNotEmpty = lambda b: S3Error(  # noqa: E731
    "BucketNotEmpty", "The bucket you tried to delete is not empty", 409)
ErrNoSuchUpload = lambda u: S3Error(  # noqa: E731
    "NoSuchUpload", f"The specified upload does not exist: {u}", 404)


class S3Gateway:
    def __init__(self, filer_server, ip: str = "127.0.0.1", port: int = 8333,
                 iam_config: dict | None = None,
                 circuit_breaker: dict | None = None,
                 qos_policy: "dict | str | None" = None,
                 allowed_origins: str = "*"):
        from ..qos import QosScheduler
        from .circuit_breaker import CircuitBreaker
        self.fs = filer_server  # in-process FilerServer
        self.ip, self.port = ip, port
        self.iam = IdentityAccessManagement(iam_config)
        self.breaker = CircuitBreaker(circuit_breaker)
        # multi-tenant QoS (qos/): tenant = the request's access key
        # (falling back to the bucket for anonymous traffic), classes
        # from the verb. The breaker's in-flight count/byte caps and
        # the scheduler's rate/fairness decisions fold into ONE
        # admission path in _route, both answering 503 SlowDown +
        # Retry-After. Policy doc hot-reloads from the filer at
        # /etc/qos/policy.json (standalone gateway) or via load().
        self.qos = QosScheduler(name=f"s3-{port}")
        if isinstance(qos_policy, str) and qos_policy:
            self.qos.attach_file(qos_policy)
        elif qos_policy:
            self.qos.load(qos_policy)
        self.allowed_origins = allowed_origins
        self._stop = threading.Event()
        self._http_thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> "S3Gateway":
        from ..profiling import LoopLagMonitor, acquire_sampler
        self._sampler = acquire_sampler()
        self._loop_lag = LoopLagMonitor("s3")
        self._http_ready = threading.Event()
        self._http_error = None
        self._http_thread = threading.Thread(target=self._run_http, daemon=True,
                                             name=f"s3-http-{self.port}")
        self._http_thread.start()
        self._http_ready.wait(10)  # port bound before start() returns
        if self._http_error is not None:
            self.stop()
            raise OSError(f"s3 http {self.url}: {self._http_error}")
        log.info("s3 gateway %s up (auth %s)", self.url,
                 "on" if self.iam.enabled else "off")
        return self

    def stop(self) -> None:
        self._stop.set()
        self.qos.close()
        lag = getattr(self, "_loop_lag", None)
        if lag is not None:
            lag.close()
        if getattr(self, "_sampler", None) is not None:
            from ..profiling import release_sampler
            release_sampler()
            self._sampler = None
        if self._http_thread is not None and \
                self._http_thread is not threading.current_thread():
            self._http_thread.join(5)

    # -- HTTP plumbing -------------------------------------------------------
    def _run_http(self) -> None:
        from .. import tracing
        from ..stats import S3_REQUEST_COUNTER, S3_REQUEST_SECONDS

        async def dispatch(req: fastweb.Request):
            import time as _time
            request = _S3Request(req)
            kind = request.method.lower()
            resp = None
            t0 = _time.perf_counter()
            # server span continues the caller's trace; the in-process
            # filer + blob-IO child spans land under it
            with tracing.start_span(
                    f"s3.{kind}", component="s3",
                    child_of=tracing.extract(request.headers),
                    attrs={"path": request.path}) as sp:
                with S3_REQUEST_SECONDS.time(kind):
                    try:
                        if request.method == "OPTIONS":
                            resp = self._cors_preflight(request)
                        else:
                            resp = await self._route(request)
                    except S3Error as e:
                        sp.add_event("s3_error", code=e.code)
                        resp = _error_response(e, request.path)
                    except FileNotFoundError as e:
                        resp = _error_response(
                            S3Error("NoSuchKey", str(e), 404), request.path)
                    except Exception as e:  # noqa: BLE001
                        log.error("s3 http: %r", e)
                        sp.set_error(e)
                        resp = _error_response(
                            S3Error("InternalError", str(e), 500),
                            request.path)
                    await _drain_body(req)
                sp.set_attr("status", resp.status)
                # slow/errored requests land in the flight ring (single
                # stage — the S3 envelope has no wire-level split)
                from ..profiling import record_flight
                record_flight(f"s3.{kind}", _time.perf_counter() - t0,
                              status=resp.status, path=request.path,
                              node=self.url)
            # Label by bucket only for successful requests — failed probes
            # (scanners, typos) would otherwise mint unbounded label sets.
            bucket = (request.path.lstrip("/").split("/", 1)[0]
                      if resp.status < 400 else "")
            S3_REQUEST_COUNTER.inc(kind, str(resp.status), bucket)
            self._apply_cors(request, resp)
            return resp

        def _operator_gate(request):
            """The S3 plane is tenant-facing: with IAM on, spans (fids,
            paths, peer addresses) and metrics (per-bucket traffic
            labels) are operator data — demand a SigV4-signed request
            (deliberately NOT the legacy V2 scheme the object handlers
            still accept). Unsigned or V2-only scrapers belong on the
            filer/master/volume ports, which serve the same process
            registry. Returns an error response, or None to proceed."""
            if request.method == "OPTIONS":
                return self._cors_preflight(request)
            if request.method != "GET":
                return fastweb.json_response({"error": "method not allowed"},
                                             status=405)
            if not self.iam.enabled:
                return None
            try:
                headers = {k.lower(): v
                           for k, v in request.headers.items()}
                self.iam.authenticate(
                    request.method, request.path, dict(request.query),
                    headers,
                    headers.get("x-amz-content-sha256",
                                "UNSIGNED-PAYLOAD"))
            except S3Error as e:
                return _error_response(e, request.path)
            return None

        def gated(handler):
            """An exact operator route: the gate, then `handler(query)` on
            a worker thread (captures and dumps cannot stall the loop)."""
            async def h(req):
                request = _S3Request(req)
                denied = _operator_gate(request)
                if denied is not None:
                    return denied
                return await asyncio.to_thread(handler, request)
            return h

        def debug_traces(request):
            return fastweb.json_response(
                tracing.debug_traces_payload(dict(request.query)))

        def debug_events(request):
            from ..ops import events
            return fastweb.json_response(
                events.debug_events_payload(dict(request.query)))

        def debug_locks(request):
            from ..utils import locktrack
            return fastweb.json_response(
                locktrack.debug_locks_payload(dict(request.query)))

        def debug_qos(request):
            # live scheduler dump, operator-gated like the other
            # /debug surfaces (per-tenant counters are operator data).
            # Retunes land via the /etc/qos/policy.json watcher (or
            # qos.load() for the embedded gateway), not this endpoint —
            # the gate is deliberately GET-only.
            return fastweb.json_response(self.qos.debug_payload())

        def debug_profile(request):
            # shared /debug/profile contract (profiling package):
            # validated/clamped seconds, continuous/summary modes, hz
            # retune — operator-gated like /debug/traces (stacks leak
            # paths and peer addresses)
            from .. import profiling as prof
            code, ctype, body = prof.handle_profile_query(
                dict(request.query))
            return fastweb.Response(body.encode(), status=code,
                                    content_type=ctype.split(";")[0])

        def debug_flight(request):
            from .. import profiling as prof
            code, payload = prof.debug_flight_payload(dict(request.query))
            return fastweb.json_response(payload, status=code)

        def metrics(request):
            from ..stats import scrape_payload
            body, ctype = scrape_payload(request.headers.get("Accept", ""))
            return fastweb.Response(body.encode(), content_type=ctype)

        app = fastweb.FastApp()
        # exact routes win over the bucket/key catch-all and claim
        # EVERY method (a GET-only route would let PUT/POST fall
        # through to the object handlers and mint entries no read
        # can ever reach): these paths are fully reserved
        app.route("/debug/traces", gated(debug_traces))
        app.route("/debug/events", gated(debug_events))
        app.route("/debug/locks", gated(debug_locks))
        app.route("/debug/qos", gated(debug_qos))
        app.route("/debug/profile", gated(debug_profile))
        app.route("/debug/flight", gated(debug_flight))
        app.route("/metrics", gated(metrics))
        # CPU by thread class, counted at each scrape of /metrics
        from ..profiling import THREAD_CPU
        THREAD_CPU.install()
        # alias matching the filer's reserved-namespace spelling so
        # the fleet telemetry collector can scrape either daemon
        # kind at /__metrics__ without knowing which it hit
        app.route("/__metrics__", gated(metrics))
        app.default(dispatch, stream_body=True)
        try:
            fastweb.serve_fast_app(
                app, self.ip, self.port, self._stop, logger=log,
                on_loop=getattr(self, "_loop_lag", None)
                and self._loop_lag.attach, ready=self._http_ready)
        except BaseException as e:  # noqa: BLE001 — start() reports it
            self._http_error = e
            self._http_ready.set()

    # CORS (reference s3api_server.go cors.AllowAll-style middleware)
    def _cors_preflight(self, request):
        return _response(status=200, headers={
            "Access-Control-Allow-Origin": self.allowed_origins,
            "Access-Control-Allow-Methods":
                "GET, PUT, POST, DELETE, HEAD, OPTIONS",
            "Access-Control-Allow-Headers":
                request.headers.get("Access-Control-Request-Headers")
                or "Authorization, Content-Type, x-amz-date, "
                   "x-amz-content-sha256, *",
            "Access-Control-Expose-Headers": "*",
            "Access-Control-Max-Age": "86400",
        })

    def _apply_cors(self, request, resp) -> None:
        if request.headers.get("Origin") and self.allowed_origins:
            if resp.headers is None:
                resp.headers = {}
            resp.headers.setdefault("Access-Control-Allow-Origin",
                                    self.allowed_origins)
            resp.headers.setdefault("Access-Control-Expose-Headers", "*")

    @staticmethod
    def _classify_action(method: str, q: dict, bucket: str, key: str) -> str:
        if not bucket or (method in ("GET", "HEAD") and not key):
            return ACTION_LIST
        if "tagging" in q:
            return ACTION_TAGGING
        if method in ("GET", "HEAD"):
            return ACTION_READ
        return ACTION_WRITE

    def _stream_put_ok(self, request, bucket: str, key: str,
                       q: dict) -> bool:
        """True when this PUT can stream through the filer's chunked
        fan-out instead of buffering the whole body: a plain object/part
        upload, large enough to span chunks, whose auth scheme can be
        verified from headers (SigV4's signature covers the DECLARED
        x-amz-content-sha256; the body digest is checked incrementally
        and a mismatch aborts before the entry commits). aws-chunked
        framing and V2 Content-MD5 still need the buffered decoder."""
        if request.method != "PUT" or not bucket or not key \
                or key.endswith("/"):
            return False
        if not hasattr(self.fs, "stream_write"):  # remote-filer gateway
            return False
        if request.headers.get("x-amz-copy-source"):
            return False
        if any(k in q for k in ("acl", "tagging", "retention",
                                "legal-hold")):
            return False
        from .chunked import STREAMING_PAYLOAD, STREAMING_UNSIGNED
        sha = request.headers.get("x-amz-content-sha256", "")
        if sha in (STREAMING_PAYLOAD, STREAMING_UNSIGNED) or \
                "aws-chunked" in request.headers.get("content-encoding", ""):
            return False
        auth_hdr = request.headers.get("Authorization", "")
        if auth_hdr.startswith("AWS ") or (
                "Signature" in q and "AWSAccessKeyId" in q):
            return False  # legacy V2: Content-MD5 precheck needs the body
        try:
            length = int(request.headers.get("Content-Length", ""))
        except ValueError:
            return False
        return length > getattr(self.fs, "chunk_size", 4 << 20)

    @staticmethod
    def _qos_tenant(request, bucket: str) -> str:
        """Tenant identity at the gateway: the request's ACCESS KEY,
        parsed cheaply from whichever auth form it arrived in (SigV4
        Credential scope, presigned X-Amz-Credential, legacy V2 header
        or query). Verification happens later in _authorize — for
        throttle accounting a forged key id only picks whose bucket the
        forger drains. Anonymous traffic falls back to the bucket name
        (the owner's resource is what it competes for)."""
        auth = request.headers.get("Authorization", "")
        if "Credential=" in auth:  # AWS4-HMAC-SHA256 ... Credential=AK/...
            return auth.split("Credential=", 1)[1].split("/", 1)[0]
        if auth.startswith("AWS "):  # V2: "AWS AKID:signature"
            return auth[4:].split(":", 1)[0]
        q = request.query
        cred = q.get("X-Amz-Credential", "")
        if cred:
            return urllib.parse.unquote(cred).split("/", 1)[0]
        if q.get("AWSAccessKeyId"):
            return q["AWSAccessKeyId"]
        return bucket or "anonymous"

    async def _route(self, request):
        from .. import qos as qos_mod
        path = urllib.parse.unquote(request.path)
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        q = dict(request.query)
        action = self._classify_action(request.method, q, bucket, key)
        try:
            nbytes = int(request.headers.get("Content-Length") or 0)
        except ValueError:
            nbytes = 0
        # ONE admission decision: the QoS scheduler's rate/fairness/
        # priority verdict, then the breaker's in-flight count+byte
        # caps. Either refusal is a 503 SlowDown + Retry-After.
        grant = None
        if self.qos.enabled:
            is_read = request.method in ("GET", "HEAD")
            klass = qos_mod.class_from_headers(
                request.headers,
                qos_mod.CLASS_INTERACTIVE if is_read
                else qos_mod.CLASS_INGEST)
            try:
                grant = await self.qos.admit(
                    self._qos_tenant(request, bucket), klass, cost=nbytes)
            except qos_mod.QosShed as e:
                from .circuit_breaker import ErrTooManyRequests
                raise ErrTooManyRequests(
                    int(e.retry_after_header)) from None
        try:
            with self.breaker.acquire(action, bucket, nbytes):
                resp = await self._route_admitted(request, bucket, key, q,
                                                  action)
                if grant is not None and request.method == "GET":
                    body = resp.body
                    if isinstance(body, (bytes, bytearray)) and body:
                        grant.charge(len(body))
                    else:
                        # streamed large-object GETs carry no .body —
                        # charge the declared length, or the biggest
                        # reads would be exactly the ones that bypass
                        # every byte-rate limit
                        length = getattr(resp, "content_length", None)
                        if length:
                            grant.charge(int(length))
                return resp
        finally:
            if grant is not None:
                grant.release()

    async def _route_admitted(self, request, bucket, key, q, action):
        if self._stream_put_ok(request, bucket, key, q):
            self._authorize(request, bucket, key, q, None, action)
            return await self._put_streaming(request, bucket, key, q)
        body = await request.read()
        # authorization and the handlers (which call the filer
        # synchronously) run off the loop
        return await asyncio.to_thread(self._route_sync, request, bucket,
                                       key, q, body, action)

    def _route_sync(self, request, bucket, key, q, body, action):
        # browser post-policy uploads carry their signature IN the
        # form; post_policy_upload authorizes from the policy fields
        is_post_policy = (request.method == "POST" and bucket and not key
                          and "delete" not in q
                          and request.content_type.startswith(
                              "multipart/form-data"))
        if not is_post_policy:
            seed_ctx = self._authorize(request, bucket, key, q, body,
                                       action)
            body = self._maybe_decode_chunked(request, body, seed_ctx)

        if not bucket:
            return self.list_buckets()
        if not key:
            return self._route_bucket(request, bucket, q, body)
        return self._route_object(request, bucket, key, q, body)

    def _maybe_decode_chunked(self, request, body, seed_ctx):
        """Strip + verify aws-chunked framing on streaming-signed uploads
        (reference chunked_reader_v4.go)."""
        from .chunked import (STREAMING_PAYLOAD, STREAMING_UNSIGNED,
                              decode_chunked_payload)
        sha = request.headers.get("x-amz-content-sha256", "")
        enc = request.headers.get("content-encoding", "")
        if sha == STREAMING_PAYLOAD:
            decoded = decode_chunked_payload(body, seed_ctx)
        elif sha == STREAMING_UNSIGNED or "aws-chunked" in enc:
            decoded = decode_chunked_payload(body, None)
        else:
            return body
        declared = request.headers.get("x-amz-decoded-content-length")
        if declared is not None and declared.isdigit() and \
                int(declared) != len(decoded):
            raise S3Error("IncompleteBody",
                          "You did not provide the number of bytes specified "
                          "by the Content-Length HTTP header.", 400)
        return decoded

    def _authorize(self, request, bucket, key, q, body, action):
        """Returns the streaming SeedContext for chunk verification when the
        request is streaming-signed, else None."""
        if not self.iam.enabled:
            return None
        from .chunked import STREAMING_PAYLOAD, STREAMING_UNSIGNED
        payload_hash = request.headers.get("x-amz-content-sha256",
                                           "UNSIGNED-PAYLOAD")
        headers = {k.lower(): v for k, v in request.headers.items()}
        seed_ctx = None
        auth_hdr = headers.get("authorization", "")
        if auth_hdr.startswith("AWS ") or (
                "Signature" in q and "AWSAccessKeyId" in q):
            # legacy signature V2 clients (reference auth_signature_v2.go)
            from . import auth as auth_mod
            path = urllib.parse.unquote(request.path)
            if auth_hdr.startswith("AWS "):
                md5_hdr = headers.get("content-md5", "")
                if md5_hdr:
                    import base64
                    actual = base64.b64encode(
                        hashlib.md5(body,
                                    usedforsecurity=False).digest()).decode()
                    if actual != md5_hdr:
                        raise S3Error("BadDigest",
                                      "The Content-MD5 you specified did "
                                      "not match what we received.", 400)
                ident = auth_mod.verify_v2_header(
                    self.iam, request.method, path, dict(request.query),
                    headers)
            else:
                ident = auth_mod.verify_v2_presigned(
                    self.iam, request.method, path, dict(request.query),
                    headers)
            from .auth import ErrAccessDenied
            if not ident.allows(action, bucket):
                raise ErrAccessDenied()
            request["s3_identity"] = ident
            return None
        if payload_hash == STREAMING_PAYLOAD:
            ident, seed_ctx = self.iam.authenticate_streaming(
                request.method, urllib.parse.unquote(request.path),
                dict(request.query), headers)
        else:
            if payload_hash not in ("UNSIGNED-PAYLOAD", STREAMING_UNSIGNED) \
                    and body is not None:
                # body=None = streaming PUT: the digest is verified
                # incrementally by _put_streaming before the entry commits
                actual = hashlib.sha256(body).hexdigest()
                if actual != payload_hash:
                    raise S3Error("XAmzContentSHA256Mismatch",
                                  "The provided 'x-amz-content-sha256' header "
                                  "does not match what was computed.", 400)
            ident = self.iam.authenticate(request.method,
                                          urllib.parse.unquote(request.path),
                                          dict(request.query), headers,
                                          payload_hash)
        from .auth import ErrAccessDenied

        if not ident.allows(action, bucket):
            raise ErrAccessDenied()
        request["s3_identity"] = ident
        return seed_ctx

    def _route_bucket(self, request, bucket, q, body):
        m = request.method
        if m == "PUT":
            if "acl" in q:
                return self.put_acl(bucket, "", request, body)
            if "lifecycle" in q:
                return self.put_bucket_lifecycle(bucket, body)
            if "policy" in q:
                # reference parity: PutBucketPolicyHandler -> NotImplemented
                # (s3api_bucket_skip_handlers.go:35)
                raise S3Error("NotImplemented",
                              "Bucket policies are not implemented.", 501)
            if "versioning" in q:
                raise S3Error("NotImplemented",  # skip_handlers.go:47
                              "Versioning cannot be enabled.", 501)
            if "object-lock" in q:
                # bucket-level subresource; acknowledged no-op like the
                # reference's PutObjectLockConfigurationHandler (204)
                return _response(status=204)
            return self.put_bucket(bucket, acl=self._canned_acl(request))
        if m == "HEAD":
            return self.head_bucket(bucket)
        if m == "DELETE":
            if "lifecycle" in q:
                return self.delete_bucket_lifecycle(bucket)
            if "policy" in q:  # skip_handlers.go:41 returns 204
                return _response(status=204)
            return self.delete_bucket(bucket)
        if m == "POST" and "delete" in q:
            return self.delete_multiple_objects(bucket, body)
        if m == "POST" and request.content_type.startswith(
                "multipart/form-data"):
            return self.post_policy_upload(request, bucket, body)
        if m == "GET":
            if "acl" in q:
                return self.get_acl(bucket, "")
            if "lifecycle" in q:
                return self.get_bucket_lifecycle(bucket)
            if "policy" in q:  # skip_handlers.go:29
                raise S3Error("NoSuchBucketPolicy",
                              "The bucket policy does not exist", 404)
            if "versioning" in q:
                return self.get_bucket_versioning(bucket)
            if "object-lock" in q:
                raise S3Error("ObjectLockConfigurationNotFoundError",
                              "Object Lock configuration does not exist "
                              "for this bucket", 404)
            if "uploads" in q:
                return self.list_multipart_uploads(bucket, q)
            return self.list_objects(bucket, q)
        raise S3Error("MethodNotAllowed", "Method not allowed.", 405)

    def _route_object(self, request, bucket, key, q, body):
        m = request.method
        if m == "PUT":
            if "partNumber" in q and "uploadId" in q:
                src = request.headers.get("x-amz-copy-source")
                if src:
                    return self.upload_part_copy(
                        bucket, key, q, src,
                        request.headers.get("x-amz-copy-source-range", ""),
                        request)
                return self.upload_part(bucket, key, q, body)
            if "acl" in q:
                return self.put_acl(bucket, key, request, body)
            if "tagging" in q:
                return self.put_object_tagging(bucket, key, body)
            if "retention" in q or "legal-hold" in q:
                # reference parity: PutObjectRetention/LegalHold are
                # acknowledged no-ops (object_handlers_skip.go:25-37)
                return _response(status=204)
            src = request.headers.get("x-amz-copy-source")
            if src:
                return self.copy_object(bucket, key, src,
                                        acl=self._canned_acl(request),
                                        request=request)
            return self.put_object(bucket, key, body,
                                   request.content_type or "",
                                   acl=self._canned_acl(request),
                                   meta=_user_meta(request.headers))
        if m == "POST":
            if "uploads" in q:
                return self.initiate_multipart(
                    bucket, key, acl=self._canned_acl(request),
                    meta=_user_meta(request.headers))
            if "uploadId" in q:
                return self.complete_multipart(bucket, key, q["uploadId"], body)
        if m in ("GET", "HEAD"):
            if "acl" in q:
                return self.get_acl(bucket, key)
            if "tagging" in q:
                return self.get_object_tagging(bucket, key)
            if "retention" in q or "legal-hold" in q:
                # never set (the PUTs are no-ops): answer not-found, not
                # the object body
                raise S3Error("NoSuchObjectLockConfiguration",
                              "The specified object does not have an "
                              "ObjectLock configuration", 404)
            if "uploadId" in q:
                return self.list_parts(bucket, key, q)
            return self.get_object(bucket, key, request)
        if m == "DELETE":
            if "uploadId" in q:
                return self.abort_multipart(bucket, key, q["uploadId"])
            if "tagging" in q:
                return self.delete_object_tagging(bucket, key)
            return self.delete_object(bucket, key)
        raise S3Error("MethodNotAllowed", "Method not allowed.", 405)

    # -- buckets -------------------------------------------------------------
    # -- bucket lifecycle (reference s3api_bucket_handlers.go:300-470:
    # expiration rules map onto filer.conf TTL path rules; transitions
    # and date-based expiry are NotImplemented there too) ------------------
    def _read_filer_conf(self):
        from ..filer.filer_conf import CONF_DIR, CONF_NAME, FilerConf
        entry = self.fs.filer.find_entry(CONF_DIR, CONF_NAME)
        raw = self.fs.read_entry_bytes(entry) if entry is not None else b""
        return FilerConf.from_bytes(raw)

    def _save_filer_conf(self, conf) -> None:
        from ..filer.filer_conf import CONF_PATH
        self.fs.write_file(CONF_PATH, conf.to_bytes(),
                           mime="application/json")

    def put_bucket_lifecycle(self, bucket, body):
        from ..filer.filer_conf import PathRule
        self._require_bucket(bucket)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML", "Invalid lifecycle XML.", 400)
        ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
        conf = self._read_filer_conf()
        # S3 semantics: PUT REPLACES the whole lifecycle configuration —
        # strip the TTLs a previous PUT installed before applying the new
        # rules (a PUT that only drops a rule must not be a no-op)
        changed = self._strip_lifecycle_ttls(conf, bucket)
        for rule in root.iter(f"{ns}Rule"):
            if (rule.findtext(f"{ns}Status") or "").strip() != "Enabled":
                continue
            prefix = (rule.findtext(f"{ns}Filter/{ns}Prefix")
                      or rule.findtext(f"{ns}Prefix") or "").strip()
            exp = rule.find(f"{ns}Expiration")
            try:
                days = int(exp.findtext(f"{ns}Days") or 0) \
                    if exp is not None else 0
            except ValueError:
                raise S3Error("MalformedXML", "Invalid expiration days.",
                              400)
            if exp is not None and exp.find(f"{ns}Date") is not None or \
                    rule.find(f"{ns}Transition") is not None:
                raise S3Error("NotImplemented",
                              "Only Days-based expiration is supported.",
                              501)
            if days <= 0:
                continue
            lp = f"{BUCKETS_DIR}/{bucket}/{prefix}"
            # merge into any admin-set rule for the prefix: the lifecycle
            # owns only the TTL, never replication/collection/disk_type
            import dataclasses
            existing = next((r for r in conf.rules
                             if r.location_prefix == lp), None)
            conf.upsert(dataclasses.replace(existing, ttl=f"{days}d",
                                            from_lifecycle=True)
                        if existing is not None
                        else PathRule(location_prefix=lp, ttl=f"{days}d",
                                      from_lifecycle=True))
            changed = True
        if changed:
            self._save_filer_conf(conf)
        return _response(status=200)

    def get_bucket_lifecycle(self, bucket):
        self._require_bucket(bucket)
        conf = self._read_filer_conf()
        prefix = f"{BUCKETS_DIR}/{bucket}/"
        rules = [(r.location_prefix[len(prefix):], r.ttl)
                 for r in conf.rules
                 if r.location_prefix.startswith(prefix)
                 and r.ttl.endswith("d")]
        if not rules:
            raise S3Error("NoSuchLifecycleConfiguration",
                          "The lifecycle configuration does not exist.", 404)
        root = ET.Element("LifecycleConfiguration")
        for i, (p, ttl) in enumerate(sorted(rules)):
            rule = ET.SubElement(root, "Rule")
            ET.SubElement(rule, "ID").text = f"rule-{i + 1}"
            f = ET.SubElement(rule, "Filter")
            ET.SubElement(f, "Prefix").text = p
            ET.SubElement(rule, "Status").text = "Enabled"
            exp = ET.SubElement(rule, "Expiration")
            ET.SubElement(exp, "Days").text = ttl[:-1]
        return _xml_response(root)

    def _strip_lifecycle_ttls(self, conf, bucket: str) -> bool:
        """Remove the TTLs lifecycle PUTs own under the bucket — only rules
        carrying the from_lifecycle marker; TTLs an admin set via
        fs.configure survive, and rules an admin enriched with
        replication/collection/disk_type survive TTL-less. Returns whether
        anything changed."""
        import dataclasses
        prefix = f"{BUCKETS_DIR}/{bucket}/"
        changed = False
        # NOTE upgrade path: rules persisted by pre-marker builds carry no
        # from_lifecycle flag and are treated as admin-owned — remove them
        # once with `fs.configure -locationPrefix ... -ttl ""` if they came
        # from an old lifecycle PUT. Guessing here would re-open the bug
        # where DeleteBucketLifecycle strips TTLs an admin set.
        for r in list(conf.rules):
            if not (r.location_prefix.startswith(prefix)
                    and r.from_lifecycle and r.ttl.endswith("d")):
                continue
            stripped = dataclasses.replace(r, ttl="", from_lifecycle=False)
            if any(getattr(stripped, k) not in ("", False, 0)
                   for k in ("collection", "replication", "disk_type",
                             "fsync", "volume_growth_count")):
                conf.upsert(stripped)
            else:
                conf.delete(r.location_prefix)
            changed = True
        return changed

    def delete_bucket_lifecycle(self, bucket):
        self._require_bucket(bucket)
        conf = self._read_filer_conf()
        if self._strip_lifecycle_ttls(conf, bucket):
            self._save_filer_conf(conf)
        return _response(status=204)

    def get_bucket_versioning(self, bucket):
        """Reference GetBucketVersioningHandler: always Suspended
        (s3api_bucket_handlers.go:651)."""
        self._require_bucket(bucket)
        root = ET.Element("VersioningConfiguration")
        ET.SubElement(root, "Status").text = "Suspended"
        return _xml_response(root)

    def _bucket_dir(self, bucket: str) -> str:
        return f"{BUCKETS_DIR}/{bucket}"

    def _require_bucket(self, bucket: str) -> None:
        if self.fs.filer.find_entry(BUCKETS_DIR, bucket) is None:
            raise ErrNoSuchBucket(bucket)

    def list_buckets(self):
        root = ET.Element("ListAllMyBucketsResult")
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "swtpu"
        buckets = ET.SubElement(root, "Buckets")
        for e in self.fs.filer.list_entries(BUCKETS_DIR):
            if not e.is_directory:
                continue
            b = ET.SubElement(buckets, "Bucket")
            ET.SubElement(b, "Name").text = e.name
            ET.SubElement(b, "CreationDate").text = _iso(e.attributes.crtime)
        return _xml_response(root)

    def put_bucket(self, bucket, acl: str | None = None):
        existing = self.fs.filer.find_entry(BUCKETS_DIR, bucket)
        if existing is None:
            e = fpb.Entry(name=bucket, is_directory=True)
            e.attributes.file_mode = 0o40755
            if acl:
                e.extended["acl"] = acl.encode()
            self.fs.filer.create_entry(BUCKETS_DIR, e)
        elif acl:
            self._store_acl(BUCKETS_DIR, existing, acl)
        return _response(status=200, headers={"Location": f"/{bucket}"})

    def head_bucket(self, bucket):
        self._require_bucket(bucket)
        return _response(status=200)

    def delete_bucket(self, bucket):
        self._require_bucket(bucket)
        for e in self.fs.filer.list_entries(self._bucket_dir(bucket), limit=2):
            if e.name != UPLOADS_DIR:
                raise ErrBucketNotEmpty(bucket)
        self.fs.filer.delete_entry(BUCKETS_DIR, bucket, is_recursive=True)
        return _response(status=204)

    # -- objects -------------------------------------------------------------
    def _object_path(self, bucket: str, key: str) -> str:
        return f"{self._bucket_dir(bucket)}/{key}"

    def _check_quota(self, bucket: str) -> None:
        """s3.bucket.quota.check marks over-quota buckets read-only in the
        bucket entry's extended attrs (reference s3_bucket_quota)."""
        e = self.fs.filer.find_entry(BUCKETS_DIR, bucket)
        if e is not None and e.extended.get("quota_readonly") == b"1":
            raise S3Error("QuotaExceeded",
                          "bucket is over its configured quota", 403)

    def post_policy_upload(self, request, bucket, body):
        """Browser form upload (reference post-policy handling in
        s3api_object_handlers_postpolicy.go)."""
        from . import auth as auth_mod

        # full header WITH the boundary param (aiohttp's .content_type
        # strips parameters)
        fields, file_name, file_bytes = _parse_multipart_form(
            body, request.headers.get("Content-Type", ""))
        fields["bucket"] = bucket  # policy {"bucket": ...} condition input
        if self.iam.enabled:
            ident = auth_mod.verify_post_policy(self.iam, fields)
            from .auth import ErrAccessDenied
            if not ident.allows(ACTION_WRITE, bucket):
                raise ErrAccessDenied()
        key = fields.get("key", "")
        if not key:
            raise S3Error("InvalidArgument", "missing key field", 400)
        key = key.replace("${filename}", file_name or "file")
        self._require_bucket(bucket)
        self._check_quota(bucket)
        acl = self._validate_canned(fields.get("acl"))
        entry = self.fs.write_file(self._object_path(bucket, key), file_bytes,
                                   mime=fields.get("Content-Type", ""))
        attrs = {k.lower(): v.encode() for k, v in fields.items()
                 if k.lower().startswith("x-amz-meta-")}
        if acl:
            attrs["acl"] = acl.encode()
        d, _n = split_path(self._object_path(bucket, key))
        self._merge_extended(d, entry, attrs)
        try:
            status = int(fields.get("success_action_status", "204"))
        except ValueError:
            status = 204  # AWS ignores junk values the same way
        if status not in (200, 201, 204):
            status = 204
        return _response(status=status)

    _CANNED_ACLS = ("private", "public-read", "public-read-write",
                    "authenticated-read", "bucket-owner-read",
                    "bucket-owner-full-control")

    def _validate_canned(self, canned: str | None) -> str | None:
        if canned is not None and canned not in self._CANNED_ACLS:
            raise S3Error("InvalidArgument",
                          f"unsupported ACL {canned!r}", 400)
        return canned

    def _canned_acl(self, request) -> str | None:
        return self._validate_canned(request.headers.get("x-amz-acl"))

    def _acl_entry(self, bucket, key):
        self._require_bucket(bucket)
        if key:
            return self._find_object(bucket, key)
        return BUCKETS_DIR, bucket, self.fs.filer.find_entry(
            BUCKETS_DIR, bucket)

    def _merge_extended(self, d: str, e: fpb.Entry,
                        attrs: "dict[str, bytes]") -> None:
        """Merge extended attributes (acl, x-amz-meta-*, tags) in ONE
        metadata-only update: no mtime bump (Last-Modified must not move
        for an ACL/metadata change) and no chunk GC."""
        if not attrs:
            return
        upd = fpb.Entry()
        upd.CopyFrom(e)
        for k, v in attrs.items():
            upd.extended[k] = v
        self.fs.filer.update_entry(d, upd, gc_chunks=False,
                                   touch_mtime=False)
        e.CopyFrom(upd)

    def _store_acl(self, d: str, e: fpb.Entry, canned: str) -> None:
        self._merge_extended(d, e, {"acl": canned.encode()})

    def put_acl(self, bucket, key, request, body):
        """Canned ACLs via the x-amz-acl header (reference
        s3api_object_handlers_acl.go). Explicit grant-XML bodies are not
        interpreted — they fail loudly rather than silently mis-apply."""
        canned = self._canned_acl(request)
        if canned is None:
            if body:
                raise S3Error(
                    "NotImplemented",
                    "AccessControlPolicy grant bodies are not supported; "
                    "use the x-amz-acl canned header.", 501)
            raise S3Error("InvalidArgument", "missing x-amz-acl header", 400)
        d, _n, e = self._acl_entry(bucket, key)
        self._store_acl(d, e, canned)
        return _response(status=200)

    _ALL_USERS = "http://acs.amazonaws.com/groups/global/AllUsers"
    _AUTH_USERS = "http://acs.amazonaws.com/groups/global/AuthenticatedUsers"
    _XSI = "http://www.w3.org/2001/XMLSchema-instance"

    def get_acl(self, bucket, key):
        _d, _n, e = self._acl_entry(bucket, key)
        canned = (e.extended.get("acl") or b"private").decode()
        root = ET.Element("AccessControlPolicy")
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "owner"
        acl = ET.SubElement(root, "AccessControlList")

        def grant(perm: str, group_uri: str | None = None,
                  user_id: str = "owner"):
            g = ET.SubElement(acl, "Grant")
            gt = ET.SubElement(g, "Grantee", {"xmlns:xsi": self._XSI})
            if group_uri:
                gt.set("xsi:type", "Group")
                ET.SubElement(gt, "URI").text = group_uri
            else:
                gt.set("xsi:type", "CanonicalUser")
                ET.SubElement(gt, "ID").text = user_id
            ET.SubElement(g, "Permission").text = perm

        grant("FULL_CONTROL")
        if canned.startswith("public-read"):
            grant("READ", self._ALL_USERS)
        if canned == "public-read-write":
            grant("WRITE", self._ALL_USERS)
        elif canned == "authenticated-read":
            grant("READ", self._AUTH_USERS)
        elif canned == "bucket-owner-read":
            grant("READ", user_id="bucket-owner")
        elif canned == "bucket-owner-full-control":
            grant("FULL_CONTROL", user_id="bucket-owner")
        return _xml_response(root)

    def put_object(self, bucket, key, body, mime, acl: str | None = None,
                   meta: "dict[str, str] | None" = None):
        self._require_bucket(bucket)
        self._check_quota(bucket)
        attrs = {k.lower(): v.encode() for k, v in (meta or {}).items()}
        if acl:
            attrs["acl"] = acl.encode()
        if key.endswith("/"):  # directory object
            d, n = split_path(self._object_path(bucket, key))
            e = fpb.Entry(name=n, is_directory=True)
            e.attributes.file_mode = 0o40755
            for k, v in attrs.items():
                e.extended[k] = v
            existing = self.fs.filer.find_entry(d, n)
            if existing is None:
                self.fs.filer.create_entry(d, e)
            else:
                self._merge_extended(d, existing, attrs)
            return _response(status=200, headers={"ETag": '"d41d8cd98f00b204e9800998ecf8427e"'})
        entry = self.fs.write_file(self._object_path(bucket, key), body,
                                   mime=mime)
        d, _n = split_path(self._object_path(bucket, key))
        self._merge_extended(d, entry, attrs)
        return _response(status=200,
                            headers={"ETag": f'"{entry.attributes.md5.hex()}"'})

    async def _put_streaming(self, request, bucket, key, q):
        """Large-object PutObject/UploadPart: the body is chunked AS IT
        ARRIVES and fanned out on the filer's upload window, so a
        multi-GB PUT holds O(chunk_size x concurrency) — never the whole
        object. A signed payload's sha256 is computed incrementally;
        a mismatch aborts BEFORE the entry is committed and the landed
        chunks are deleted (no partial object is ever visible)."""
        self._require_bucket(bucket)
        self._check_quota(bucket)
        sha = request.headers.get("x-amz-content-sha256", "")
        hasher = (hashlib.sha256()
                  if sha and sha != "UNSIGNED-PAYLOAD" else None)

        def finalize():
            if hasher is not None and hasher.hexdigest() != sha:
                raise S3Error(
                    "XAmzContentSHA256Mismatch",
                    "The provided 'x-amz-content-sha256' header does not "
                    "match what was computed.", 400)

        observer = hasher.update if hasher is not None else None
        if "partNumber" in q and "uploadId" in q:
            upload_id = q["uploadId"]
            self._find_upload(bucket, upload_id)
            part = int(q["partNumber"])
            path = f"{self._upload_dir(bucket, upload_id)}/{part:05d}.part"
            entry = await self.fs.stream_write(
                request.stream, path, observer=observer, finalize=finalize)
            return _response(status=200, headers={
                "ETag": f'"{entry.attributes.md5.hex()}"'})
        acl = self._canned_acl(request)
        attrs = {k.lower(): v.encode()
                 for k, v in _user_meta(request.headers).items()}
        if acl:
            attrs["acl"] = acl.encode()
        path = self._object_path(bucket, key)
        entry = await self.fs.stream_write(
            request.stream, path, mime=request.content_type or "",
            observer=observer, finalize=finalize)
        d, _n = split_path(path)
        self._merge_extended(d, entry, attrs)
        return _response(status=200, headers={
            "ETag": f'"{entry.attributes.md5.hex()}"'})

    def _resolve_copy_source(self, src: str, request):
        """(src_bucket, src_key, entry) for an x-amz-copy-source value.
        Enforces READ on the SOURCE bucket — without this, write access
        to one bucket would exfiltrate objects from any other."""
        src = urllib.parse.unquote(src)
        src = src[src.startswith("/") and 1 or 0:]
        sb, _, sk = src.partition("/")
        ident = request.get("s3_identity") if request is not None else None
        if self.iam.enabled and ident is not None \
                and not ident.allows(ACTION_READ, sb):
            from .auth import ErrAccessDenied
            raise ErrAccessDenied()
        d, n = split_path(self._object_path(sb, sk))
        entry = self.fs.filer.find_entry(d, n)
        if entry is None:
            raise ErrNoSuchKey(sk)
        return sb, sk, entry

    def _can_copy_by_reference(self, entry) -> bool:
        """Server-side copy moves zero object bytes when the source is a
        plain chunked entry and the backing filer supports shared-chunk
        refcounts (the in-process FilerServer; a remote-filer gateway
        falls back to data copy)."""
        return bool(entry.chunks) and not entry.content \
            and hasattr(getattr(self.fs, "filer", None), "adopt_chunks")

    def _create_cloned_entry(self, dst_path: str, chunks, file_size: int,
                             md5_digest: bytes, mime: str,
                             extended: "dict[str, bytes]",
                             adopted: "list[str]") -> fpb.Entry:
        """Create an entry over an already-cloned chunk list: bump the
        shared-chunk refcounts FIRST (a crash between the two leaks a
        count — harmless — instead of double-freeing a live chunk), roll
        them back if the create fails."""
        d, n = split_path(dst_path)
        new = fpb.Entry(name=n)
        for c in chunks:
            nc = new.chunks.add()
            nc.CopyFrom(c)
        a = new.attributes
        a.file_size = file_size
        a.mime = mime
        a.file_mode = 0o644
        a.md5 = md5_digest
        for k, v in extended.items():
            new.extended[k] = v
        adopted = [f for f in adopted if f]
        if adopted:
            self.fs.filer.adopt_chunks(adopted)
        try:
            self.fs.filer.create_entry(d, new)
        except BaseException:
            if adopted:
                self.fs.filer.release_chunks(adopted)
            raise
        return new

    def _verify_copy_source_alive(self, sb: str, sk: str,
                                  dst_path: str) -> None:
        """Close the copy/delete race: the refcounts were adopted, so if
        the source entry STILL exists, any later delete observes them
        and spares the shared blobs (the filer deletes the entry before
        releasing chunks). If it's gone, a delete may have released —
        and possibly freed — the blobs before our adoption: undo the
        clone and answer NoSuchKey like a copy that lost the race
        outright."""
        sd, sn = split_path(self._object_path(sb, sk))
        if self.fs.filer.find_entry(sd, sn) is not None:
            return
        dd, dn = split_path(dst_path)
        try:
            # the clone's own data-delete consumes the adopted counts in
            # EITHER interleaving: if the source's release beat the
            # adoption (blobs already freed) it just zeroes the stray
            # counts; if the adoption won, it drops the last reference
            # and frees the now-unreferenced blobs
            self.fs.filer.delete_entry(dd, dn, is_delete_data=True)
        except Exception as e:  # noqa: BLE001 — undo is best-effort
            log.warning("copy-race cleanup of %s: %s", dst_path, e)
        raise ErrNoSuchKey(sk)

    def _clone_chunk_range(self, entry, lo: int, size: int,
                           dst_path: str):
        """(chunks, adopted_fids) covering [lo, lo+size) of the source.
        Visible intervals that span a chunk's WHOLE blob clone by
        reference with rebased offsets; sub-chunk head/tail slices (and
        partially-overwritten chunks) fall back to data copy — a
        FileChunk cannot address a mid-blob range. Manifest chunks are
        resolved first: their nested offsets are absolute and cannot be
        rebased wholesale."""
        from ..filer.chunks import resolve_chunks
        chunks = self.fs.filer.data_chunks(entry, self.fs._fetch_blob)
        out: "list[fpb.FileChunk]" = []
        adopted: "list[str]" = []
        hi = lo + size
        try:
            for s, e, c in resolve_chunks(chunks):
                if e <= lo or s >= hi:
                    continue
                if s >= lo and e <= hi and s == c.offset \
                        and e == c.offset + c.size:
                    nc = fpb.FileChunk()
                    nc.CopyFrom(c)
                    nc.offset = s - lo
                    out.append(nc)
                    adopted.append(c.file_id)
                else:
                    ov_lo, ov_hi = max(s, lo), min(e, hi)
                    data = self.fs.read_entry_bytes(entry, ov_lo,
                                                    ov_hi - ov_lo)
                    nc = self.fs._save_blob(data, path=dst_path)
                    nc.offset = ov_lo - lo
                    out.append(nc)
        except BaseException:
            self._drop_copied_slices(out, adopted)
            raise
        return out, adopted

    def _drop_copied_slices(self, chunks, adopted: "list[str]") -> None:
        """Delete the DATA-COPIED slice blobs of a failed clone (the
        by-reference fids roll back via refcounts; slices are brand-new
        needles nothing else references)."""
        shared = set(adopted)
        copied = [c.file_id for c in chunks
                  if c.file_id and c.file_id not in shared]
        if copied:
            try:
                self.fs.filer.chunk_deleter(copied)
            except Exception as e:  # noqa: BLE001 — cleanup best-effort
                log.warning("slice cleanup %s: %s", copied, e)

    def copy_object(self, bucket, key, src, acl: str | None = None,
                    request=None):
        self._check_quota(bucket)
        self._require_bucket(bucket)
        sb, sk, entry = self._resolve_copy_source(src, request)
        hdrs = request.headers if request is not None else {}
        directive = (hdrs.get("x-amz-metadata-directive") or "COPY").upper()
        if directive not in ("COPY", "REPLACE"):
            raise S3Error("InvalidArgument",
                          "Unknown metadata directive.", 400)
        if sb == bucket and sk == key and directive == "COPY":
            # s3tests test_object_copy_to_itself: illegal without
            # changing metadata (REPLACE)
            raise S3Error(
                "InvalidRequest",
                "This copy request is illegal because it is trying to "
                "copy an object to itself without changing the object's "
                "metadata, storage class, website redirect location or "
                "encryption attributes.", 400)
        # x-amz-copy-source-if-* (s3tests test_copy_object_ifmatch_good /
        # ifnonematch_failed / ...): all failures answer 412
        cond = _check_preconditions(hdrs, _entry_etag(entry),
                                    entry.attributes.mtime,
                                    prefix="x-amz-copy-source-")
        if cond is not None:
            raise S3Error("PreconditionFailed",
                          "At least one of the pre-conditions you "
                          "specified did not hold", 412)
        if directive == "REPLACE":
            mime = (hdrs.get("Content-Type") or hdrs.get("content-type")
                    or entry.attributes.mime)
            attrs = {k: v.encode() for k, v in _user_meta(hdrs).items()}
        else:  # COPY: source metadata AND tags travel with the object
            mime = entry.attributes.mime
            attrs = {k: bytes(v) for k, v in entry.extended.items()
                     if k.startswith(("x-amz-meta-", TAG_PREFIX))}
        if acl:
            attrs["acl"] = acl.encode()
        dst_path = self._object_path(bucket, key)
        if self._can_copy_by_reference(entry):
            # zero-copy: clone the chunk list (offsets unchanged for a
            # whole-object copy, so manifest chunks clone too) and bump
            # the shared-chunk refcounts — deleting the source later
            # must not GC the copy's data
            if entry.extended.get("s3-etag"):
                attrs = dict(attrs)
                attrs["s3-etag"] = bytes(entry.extended["s3-etag"])
            same = sb == bucket and sk == key
            new = self._create_cloned_entry(
                dst_path, list(entry.chunks),
                entry.attributes.file_size or total_size(entry.chunks),
                bytes(entry.attributes.md5), mime, attrs,
                # copy-onto-itself replaces the entry: the GC's
                # keep-set already protects the shared fids, a bump
                # here would leak them forever
                [] if same else [c.file_id for c in entry.chunks])
            if not same:
                self._verify_copy_source_alive(sb, sk, dst_path)
        else:
            data = self.fs.read_entry_bytes(entry)
            new = self.fs.write_file(dst_path, data, mime=mime)
            dd, _n = split_path(dst_path)
            self._merge_extended(dd, new, attrs)
        root = ET.Element("CopyObjectResult")
        ET.SubElement(root, "ETag").text = f'"{_entry_etag(new)}"'
        ET.SubElement(root, "LastModified").text = _iso(new.attributes.mtime)
        return _xml_response(root)

    def get_object(self, bucket, key, request):
        self._require_bucket(bucket)
        d, n = split_path(self._object_path(bucket, key))
        entry = self.fs.filer.find_entry(d, n)
        if entry is not None and entry.is_directory and key.endswith("/"):
            dir_headers = {"ETag": '"d41d8cd98f00b204e9800998ecf8427e"',
                           "Content-Type": "application/octet-stream"}
            for k, v in entry.extended.items():
                if k.startswith("x-amz-meta-"):
                    dir_headers[k] = v.decode()
            return _response(  # directory object: empty body
                status=200, headers=dir_headers)
        if entry is None or entry.is_directory:
            raise ErrNoSuchKey(key)
        fsize = entry.attributes.file_size or total_size(entry.chunks)
        etag = _entry_etag(entry)
        # conditional GET/HEAD (s3tests test_get_object_ifmatch_* /
        # ifnonematch / ifmodifiedsince / ifunmodifiedsince)
        cond = _check_preconditions(request.headers, etag,
                                    entry.attributes.mtime)
        if cond == 304:
            return _response(status=304, headers={
                "ETag": f'"{etag}"',
                "Last-Modified": _http_date(entry.attributes.mtime)})
        if cond == 412:
            raise S3Error("PreconditionFailed",
                          "At least one of the pre-conditions you "
                          "specified did not hold", 412)
        headers = {"ETag": f'"{etag}"', "Accept-Ranges": "bytes",
                   "Last-Modified": _http_date(entry.attributes.mtime),
                   "Content-Type": entry.attributes.mime or
                   "application/octet-stream"}
        for k, v in entry.extended.items():
            if k.startswith("x-amz-meta-"):
                headers[k] = v.decode()
        # response header overrides (s3tests test_object_response_headers:
        # GetObject response-* query params rewrite the reply headers) —
        # honored only on authenticated (signed) requests; real S3 answers
        # InvalidRequest when an anonymous GET carries any response-*
        # parameter, and an unsigned request here never gets an identity
        wanted = [(qparam, hname, request.query[qparam])
                  for qparam, hname in
                  (("response-content-type", "Content-Type"),
                   ("response-content-language", "Content-Language"),
                   ("response-expires", "Expires"),
                   ("response-cache-control", "Cache-Control"),
                   ("response-content-disposition", "Content-Disposition"),
                   ("response-content-encoding", "Content-Encoding"))
                  if request.query.get(qparam)]
        if wanted:
            if request.get("s3_identity") is None:
                raise S3Error(
                    "InvalidRequest",
                    "Request specific response headers cannot be used "
                    "for anonymous GET requests.", 400)
            for _qparam, hname, v in wanted:
                headers[hname] = v
        rng = request.http_range
        has_range = rng.start is not None or rng.stop is not None
        offset = rng.start or 0
        if offset < 0:
            offset, stop = max(0, fsize + offset), fsize
        else:
            stop = min(rng.stop if rng.stop is not None else fsize, fsize)
        if (offset > 0 and offset >= fsize) or (has_range and fsize == 0):
            # any Range on an empty object is unsatisfiable (s3tests
            # test_ranged_request_empty_object expects 416)
            raise S3Error("InvalidRange",
                          "The requested range is not satisfiable", 416)
        status = 200 if (offset == 0 and stop >= fsize) else 206
        if status == 206:
            headers["Content-Range"] = f"bytes {offset}-{stop - 1}/{fsize}"
        ctype = headers.pop("Content-Type")
        if request.method == "HEAD":
            # the object's length and no body, as aiohttp answers a HEAD
            return fastweb.Response(iter(()), status=200, content_type=ctype,
                                    headers=headers, content_length=fsize)
        length = stop - offset
        if not hasattr(self.fs, "stream_entry") or not entry.chunks \
                or length <= getattr(self.fs, "chunk_size", 4 << 20):
            data = self.fs.read_entry_bytes(entry, offset, length)
            return fastweb.Response(data, status=status, content_type=ctype,
                                    headers=headers)
        # large objects stream window-by-window through the filer's read
        # fan-out: a 1 GB GET never materializes 1 GB in the gateway
        return self.fs.stream_entry(entry, offset, length, status, ctype,
                                    headers)

    def delete_object(self, bucket, key):
        self._require_bucket(bucket)
        d, n = split_path(self._object_path(bucket, key))
        try:
            self.fs.filer.delete_entry(d, n, is_delete_data=True,
                                       is_recursive=True)
        except FileNotFoundError:
            pass
        return _response(status=204)

    def delete_multiple_objects(self, bucket, body):
        self._require_bucket(bucket)
        req = ET.fromstring(body)
        ns = _ns(req)
        quiet = (req.findtext(f"{ns}Quiet") or "false") == "true"
        root = ET.Element("DeleteResult")
        for obj in req.findall(f"{ns}Object"):
            key = obj.findtext(f"{ns}Key") or ""
            d, n = split_path(self._object_path(bucket, key))
            try:
                self.fs.filer.delete_entry(d, n, is_delete_data=True,
                                           is_recursive=True)
                if not quiet:
                    deleted = ET.SubElement(root, "Deleted")
                    ET.SubElement(deleted, "Key").text = key
            except Exception as e:  # noqa: BLE001
                err = ET.SubElement(root, "Error")
                ET.SubElement(err, "Key").text = key
                ET.SubElement(err, "Message").text = str(e)
        return _xml_response(root)

    # -- listing -------------------------------------------------------------
    def _level_entries(self, directory: str, hide_uploads: bool):
        """Entries of one dir sorted by S3 *key* order: a subtree's keys all
        start with '<name>/', so ordering siblings by name+'/' for dirs and
        name for files yields global lexicographic key order (e.g. file
        'b.txt' sorts before dir 'b' because 'b.txt' < 'b/')."""
        entries = [e for e in self.fs.filer.list_entries(directory)
                   if not (hide_uploads and e.name == UPLOADS_DIR)]
        entries.sort(key=lambda e: e.name + "/" if e.is_directory else e.name)
        return entries

    def _walk_keys(self, base: str, rel: str, marker: str, prefix: str):
        """Yield (key, entry) recursively in lexicographic key order,
        pruning subtrees outside prefix/marker and skipping the multipart
        staging dir."""
        directory = join_path(base, rel.rstrip("/")) if rel else base
        for e in self._level_entries(directory, hide_uploads=not rel):
            key = f"{rel}{e.name}"
            if e.is_directory:
                sub = key + "/"
                if marker >= sub + HIGH:
                    continue  # entire subtree <= marker
                if not (prefix.startswith(sub) or sub.startswith(prefix)):
                    continue  # subtree cannot contain prefix keys
                yield from self._walk_keys(base, sub, marker, prefix)
            elif key > marker and key.startswith(prefix):
                yield key, e
            elif key > prefix + HIGH:
                return  # past the prefix range entirely

    def list_objects(self, bucket, q):
        self._require_bucket(bucket)
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", "1000"))
        v2 = q.get("list-type") == "2"
        marker = q.get("continuation-token", "") if v2 else q.get("marker", "")
        if v2 and not marker:
            # a continuation token always wins over start-after (s3tests
            # test_bucket_listv2_both_continuationtoken_startafter)
            marker = q.get("start-after", "")
        base = self._bucket_dir(bucket)

        contents: list[tuple[str, fpb.Entry]] = []
        prefixes: list[str] = []
        truncated = False
        if max_keys <= 0:
            # s3tests test_bucket_listv2_maxkeys_zero: empty result,
            # NOT truncated
            return self._list_response(bucket, q, prefix, delimiter, 0,
                                       v2, [], [], False)
        if delimiter and delimiter != "/":
            # generic delimiter (s3tests test_bucket_listv2_delimiter_alt):
            # flatten the recursive walk, roll keys up at the first
            # delimiter occurrence after the prefix
            seen_p: set[str] = set()
            # marker pruning is safe: a rollup is a prefix of its key, so
            # any key <= marker would be dropped by the checks below anyway
            for key, e in self._walk_keys(base, "", marker, prefix):
                idx = key.find(delimiter, len(prefix))
                rollup = key[:idx + len(delimiter)] if idx >= 0 else None
                if rollup is not None:
                    if rollup in seen_p or rollup <= marker:
                        continue
                    if len(contents) + len(prefixes) >= max_keys:
                        truncated = True
                        break
                    seen_p.add(rollup)
                    prefixes.append(rollup)
                else:
                    if key <= marker:
                        continue
                    if len(contents) + len(prefixes) >= max_keys:
                        truncated = True
                        break
                    contents.append((key, e))
            return self._list_response(bucket, q, prefix, delimiter,
                                       max_keys, v2, contents, prefixes,
                                       truncated)
        if delimiter:
            # list the dir named by the prefix; subdirs become CommonPrefixes
            pdir, pname = prefix.rpartition("/")[0], prefix.rpartition("/")[2]
            directory = join_path(base, pdir)
            rel = f"{pdir}/" if pdir else ""
            seen = 0
            for e in self._level_entries(directory, hide_uploads=not rel):
                if pname and not e.name.startswith(pname):
                    continue
                key = f"{rel}{e.name}"
                ck = key + "/" if e.is_directory else key
                if ck <= marker:  # a dir's ck <= any marker inside its subtree
                    continue
                if seen >= max_keys:
                    truncated = True
                    break
                if e.is_directory:
                    prefixes.append(ck)
                else:
                    contents.append((key, e))
                seen += 1
        else:
            for key, e in self._walk_keys(base, "", marker, prefix):
                if len(contents) >= max_keys:
                    truncated = True
                    break
                contents.append((key, e))
        return self._list_response(bucket, q, prefix, delimiter, max_keys,
                                   v2, contents, prefixes, truncated)

    def _list_response(self, bucket, q, prefix, delimiter, max_keys, v2,
                       contents, prefixes, truncated):
        # s3tests test_bucket_listv2_encoding_basic: encoding-type=url
        # percent-encodes keys/prefixes in the XML
        url_encode = q.get("encoding-type") == "url"

        def enc(s: str) -> str:
            return urllib.parse.quote(s, safe="/") if url_encode else s

        root = ET.Element("ListBucketResult",
                          xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
        ET.SubElement(root, "Name").text = bucket
        ET.SubElement(root, "Prefix").text = enc(prefix)
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        ET.SubElement(root, "IsTruncated").text = "true" if truncated else "false"
        if url_encode:
            ET.SubElement(root, "EncodingType").text = "url"
        if delimiter:
            ET.SubElement(root, "Delimiter").text = enc(delimiter)
        last = ""
        for key, e in contents:
            c = ET.SubElement(root, "Contents")
            ET.SubElement(c, "Key").text = enc(key)
            ET.SubElement(c, "LastModified").text = _iso(e.attributes.mtime)
            ET.SubElement(c, "ETag").text = f'"{_entry_etag(e)}"'
            ET.SubElement(c, "Size").text = str(e.attributes.file_size)
            ET.SubElement(c, "StorageClass").text = "STANDARD"
            last = max(last, key)
        for p in prefixes:
            cp = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(cp, "Prefix").text = enc(p)
            last = max(last, p)
        if v2:
            ET.SubElement(root, "KeyCount").text = \
                str(len(contents) + len(prefixes))
            if truncated:
                # v2 tokens are OPAQUE: SDKs echo them back verbatim
                # without decoding, and list_objects consumes the raw
                # key — so no encoding here even under encoding-type=url
                ET.SubElement(root, "NextContinuationToken").text = last
        elif truncated:
            # v1 NextMarker is a key-valued element: clients DECODE it
            # under encoding-type=url before resending, so encode it like
            # Key/Prefix or the resumed listing skips keys
            ET.SubElement(root, "NextMarker").text = enc(last)
        return _xml_response(root)

    # -- multipart -----------------------------------------------------------
    def _upload_dir(self, bucket: str, upload_id: str) -> str:
        return f"{self._bucket_dir(bucket)}/{UPLOADS_DIR}/{upload_id}"

    def initiate_multipart(self, bucket, key, acl: str | None = None,
                           meta: "dict[str, str] | None" = None):
        self._require_bucket(bucket)
        upload_id = uuid.uuid4().hex
        d, n = split_path(self._upload_dir(bucket, upload_id))
        e = fpb.Entry(name=n, is_directory=True)
        e.extended["key"] = key.encode()
        if acl:
            e.extended["acl"] = acl.encode()
        # x-amz-meta-* from CreateMultipartUpload rides the upload dir and
        # lands on the final object at complete time (boto3's transfer
        # manager sends metadata here, never on the parts)
        for k, v in (meta or {}).items():
            e.extended[k.lower()] = v.encode()
        self.fs.filer.create_entry(d, e)
        root = ET.Element("InitiateMultipartUploadResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        return _xml_response(root)

    def _find_upload(self, bucket, upload_id) -> fpb.Entry:
        d, n = split_path(self._upload_dir(bucket, upload_id))
        e = self.fs.filer.find_entry(d, n)
        if e is None:
            raise ErrNoSuchUpload(upload_id)
        return e

    def upload_part(self, bucket, key, q, body):
        self._check_quota(bucket)
        self._require_bucket(bucket)
        upload_id = q["uploadId"]
        self._find_upload(bucket, upload_id)
        part = int(q["partNumber"])
        path = f"{self._upload_dir(bucket, upload_id)}/{part:05d}.part"
        entry = self.fs.write_file(path, body)
        return _response(status=200,
                            headers={"ETag": f'"{entry.attributes.md5.hex()}"'})

    def upload_part_copy(self, bucket, key, q, src, src_range: str,
                         request=None):
        """UploadPartCopy (reference CopyObjectPartHandler,
        s3api_server.go:165): the part's bytes come from an existing
        object, optionally a byte range. Copy is by FileChunk REFERENCE
        at chunk granularity — whole chunks inside the range clone with
        rebased offsets and a refcount bump, only sub-chunk head/tail
        slices move bytes; a part copy out of a huge object moves (at
        most) two chunks of data through the gateway."""
        self._check_quota(bucket)
        self._require_bucket(bucket)
        upload_id = q["uploadId"]
        self._find_upload(bucket, upload_id)
        _sb, _sk, entry = self._resolve_copy_source(src, request)
        size = entry.attributes.file_size or total_size(entry.chunks)
        lo, plen = 0, size
        if src_range:
            m = src_range.removeprefix("bytes=")
            lo_s, _, hi_s = m.partition("-")
            try:
                lo, hi = int(lo_s), int(hi_s)
            except ValueError:
                raise S3Error("InvalidRange",
                              "The requested range is not satisfiable",
                              416)
            if lo > hi or hi >= size:
                raise S3Error("InvalidRange",
                              "The requested range is not satisfiable",
                              416)
            plen = hi - lo + 1
        part = int(q["partNumber"])
        path = f"{self._upload_dir(bucket, upload_id)}/{part:05d}.part"
        if not self._can_copy_by_reference(entry):
            data = self.fs.read_entry_bytes(entry, lo, plen)
            new = self.fs.write_file(path, data)
        else:
            whole = lo == 0 and plen == size
            if whole and not any(c.is_chunk_manifest
                                 for c in entry.chunks):
                chunks = list(entry.chunks)
                adopted = [c.file_id for c in entry.chunks]
            else:
                # complete_multipart rebases part-chunk offsets, which a
                # manifest chunk cannot survive (nested offsets are
                # absolute) — resolve through the range cloner instead
                chunks, adopted = self._clone_chunk_range(entry, lo, plen,
                                                          path)
            if whole and entry.attributes.md5:
                digest = bytes(entry.attributes.md5)
            else:
                # the part's bytes never pass through the gateway, so no
                # content md5 exists; a deterministic surrogate keeps the
                # CopyPartResult ETag, the stored part entry, and the
                # complete-time ETag check mutually consistent
                digest = hashlib.md5(
                    f"{_entry_etag(entry)}:{lo}:{plen}".encode(),
                    usedforsecurity=False).digest()
            try:
                new = self._create_cloned_entry(path, chunks, plen,
                                                digest, "", {}, adopted)
            except BaseException:
                # adopted fids rolled back inside; the data-copied
                # slices are ours to delete
                self._drop_copied_slices(chunks, adopted)
                raise
            if adopted:
                self._verify_copy_source_alive(_sb, _sk, path)
        root = ET.Element("CopyPartResult")
        ET.SubElement(root, "ETag").text = f'"{new.attributes.md5.hex()}"'
        ET.SubElement(root, "LastModified").text = _iso(new.attributes.mtime)
        return _xml_response(root)

    def complete_multipart(self, bucket, key, upload_id, body):
        self._check_quota(bucket)
        self._require_bucket(bucket)
        upload = self._find_upload(bucket, upload_id)
        updir = self._upload_dir(bucket, upload_id)
        req = ET.fromstring(body) if body else None
        wanted: list[int] | None = None
        wanted_etags: dict[int, str] = {}
        if req is not None:
            ns = _ns(req)
            wanted = []
            for p in req.findall(f"{ns}Part"):
                num = int(p.findtext(f"{ns}PartNumber") or "0")
                wanted.append(num)
                et = (p.findtext(f"{ns}ETag") or "").strip().strip('"')
                if et:
                    wanted_etags[num] = et
            if not wanted:
                # s3tests test_multipart_upload_empty
                raise S3Error("MalformedXML",
                              "You must specify at least one part.", 400)
        parts = {int(e.name.split(".")[0]): e
                 for e in self.fs.filer.list_entries(updir)
                 if e.name.endswith(".part")}
        order = sorted(parts) if wanted is None else wanted
        if any(b <= a for a, b in zip(order, order[1:])):
            raise S3Error("InvalidPartOrder",
                          "The list of parts was not in ascending order.", 400)
        if any(p not in parts for p in order):
            raise S3Error("InvalidPart", "One or more of the specified parts "
                          "could not be found.", 400)
        for num, et in wanted_etags.items():
            # s3tests test_multipart_upload_incorrect_etag
            if parts[num].attributes.md5.hex() != et:
                raise S3Error(
                    "InvalidPart", "One or more of the specified parts "
                    "could not be found. The part may not have been "
                    "uploaded, or the specified entity tag may not match "
                    "the part's entity tag.", 400)
        # zero-copy concat: rebase each part's chunks onto the final offset
        final = fpb.Entry()
        offset = 0
        md5s = hashlib.md5(usedforsecurity=False)  # multipart ETag
        for p in order:
            pe = parts[p]
            md5s.update(pe.attributes.md5)
            for c in pe.chunks:
                nc = final.chunks.add()
                nc.CopyFrom(c)
                nc.offset = offset + c.offset
            offset += pe.attributes.file_size
        d, n = split_path(self._object_path(bucket, key))
        final.name = n
        final.attributes.file_size = offset
        final.attributes.mime = "application/octet-stream"
        etag = f"{md5s.hexdigest()}-{len(order)}"
        final.extended["s3-etag"] = etag.encode()
        if upload.extended.get("acl"):
            final.extended["acl"] = upload.extended["acl"]
        for k, v in upload.extended.items():
            # user metadata staged at initiate time lands on the object
            if k.startswith("x-amz-meta-"):
                final.extended[k] = v
        self.fs.filer.create_entry(d, final)
        # drop staging metadata but never the chunks (now owned by `final`)
        pdir, pname = split_path(updir)
        for pe in list(self.fs.filer.list_entries(updir)):
            self.fs.filer.store.delete_entry(updir, pe.name)
        self.fs.filer.store.delete_entry(pdir, pname)
        root = ET.Element("CompleteMultipartUploadResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "ETag").text = f'"{etag}"'
        return _xml_response(root)

    def abort_multipart(self, bucket, key, upload_id):
        self._require_bucket(bucket)
        # s3tests test_abort_multipart_upload_not_found: unknown id -> 404
        self._find_upload(bucket, upload_id)
        d, n = split_path(self._upload_dir(bucket, upload_id))
        self.fs.filer.delete_entry(d, n, is_delete_data=True,
                                   is_recursive=True)
        return _response(status=204)

    def list_multipart_uploads(self, bucket, q):
        self._require_bucket(bucket)
        root = ET.Element("ListMultipartUploadsResult")
        ET.SubElement(root, "Bucket").text = bucket
        updir = f"{self._bucket_dir(bucket)}/{UPLOADS_DIR}"
        for e in self.fs.filer.list_entries(updir):
            u = ET.SubElement(root, "Upload")
            ET.SubElement(u, "Key").text = e.extended.get("key", b"").decode()
            ET.SubElement(u, "UploadId").text = e.name
            ET.SubElement(u, "Initiated").text = _iso(e.attributes.crtime)
        return _xml_response(root)

    def list_parts(self, bucket, key, q):
        self._require_bucket(bucket)
        upload_id = q["uploadId"]
        self._find_upload(bucket, upload_id)
        root = ET.Element("ListPartsResult")
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "UploadId").text = upload_id
        updir = self._upload_dir(bucket, upload_id)
        for e in self.fs.filer.list_entries(updir):
            if not e.name.endswith(".part"):
                continue
            p = ET.SubElement(root, "Part")
            ET.SubElement(p, "PartNumber").text = str(int(e.name.split(".")[0]))
            ET.SubElement(p, "ETag").text = f'"{e.attributes.md5.hex()}"'
            ET.SubElement(p, "Size").text = str(e.attributes.file_size)
            ET.SubElement(p, "LastModified").text = _iso(e.attributes.mtime)
        return _xml_response(root)

    # -- tagging -------------------------------------------------------------
    def _find_object(self, bucket, key) -> tuple[str, str, fpb.Entry]:
        d, n = split_path(self._object_path(bucket, key))
        e = self.fs.filer.find_entry(d, n)
        if e is None:
            raise ErrNoSuchKey(key)
        return d, n, e

    def put_object_tagging(self, bucket, key, body):
        self._require_bucket(bucket)
        d, n, e = self._find_object(bucket, key)
        req = ET.fromstring(body)
        ns = _ns(req)
        for k in [k for k in e.extended if k.startswith(TAG_PREFIX)]:
            del e.extended[k]
        for tag in req.iter(f"{ns}Tag"):
            tk = tag.findtext(f"{ns}Key") or ""
            tv = tag.findtext(f"{ns}Value") or ""
            e.extended[TAG_PREFIX + tk] = tv.encode()
        self.fs.filer.update_entry(d, e)  # publishes a meta-log event
        return _response(status=200)

    def get_object_tagging(self, bucket, key):
        self._require_bucket(bucket)
        _, _, e = self._find_object(bucket, key)
        root = ET.Element("Tagging")
        tags = ET.SubElement(root, "TagSet")
        for k, v in sorted(e.extended.items()):
            if k.startswith(TAG_PREFIX):
                t = ET.SubElement(tags, "Tag")
                ET.SubElement(t, "Key").text = k[len(TAG_PREFIX):]
                ET.SubElement(t, "Value").text = v.decode()
        return _xml_response(root)

    def delete_object_tagging(self, bucket, key):
        self._require_bucket(bucket)
        d, n, e = self._find_object(bucket, key)
        for k in [k for k in e.extended if k.startswith(TAG_PREFIX)]:
            del e.extended[k]
        self.fs.filer.update_entry(d, e)  # publishes a meta-log event
        return _response(status=204)


# -- helpers -----------------------------------------------------------------

def _user_meta(headers) -> "dict[str, str]":
    """x-amz-meta-* user metadata from request headers (case folded)."""
    return {k.lower(): v for k, v in headers.items()
            if k.lower().startswith("x-amz-meta-")}


def _parse_http_date(value: str) -> "int | None":
    import email.utils
    try:
        return int(email.utils.parsedate_to_datetime(value).timestamp())
    except (TypeError, ValueError):
        return None


def _check_preconditions(headers, etag: str, mtime: int,
                         prefix: str = "") -> "int | None":
    """RFC 7232 / S3 conditional semantics -> None (proceed), 304, or 412.

    prefix='' evaluates GET/HEAD If-* headers; 'x-amz-copy-source-if-'
    style prefixes evaluate CopyObject's source conditions (which answer
    412 instead of 304 for the not-modified cases, per S3)."""
    def h(name):
        # aiohttp headers are case-insensitive; internal callers pass {}.
        # Present-but-empty must stay distinct from absent.
        return headers.get(prefix + name)

    def etag_matches(spec: str) -> bool:
        cands = [c.strip().strip('"') for c in spec.split(",")]
        return "*" in spec or etag in cands

    if_match = h("if-match")
    if if_match is not None and not etag_matches(if_match):
        return 412
    if_unmod = h("if-unmodified-since")
    if if_unmod is not None and if_match is None:
        ts = _parse_http_date(if_unmod)
        if ts is not None and mtime > ts:
            return 412
    if_none = h("if-none-match")
    if if_none is not None and etag_matches(if_none):
        return 412 if prefix else 304
    if_mod = h("if-modified-since")
    if if_mod is not None and if_none is None:
        ts = _parse_http_date(if_mod)
        if ts is not None and mtime <= ts:
            return 412 if prefix else 304
    return None


def _entry_etag(e: fpb.Entry) -> str:
    s3etag = e.extended.get("s3-etag")
    if s3etag:
        return s3etag.decode()
    return e.attributes.md5.hex() if e.attributes.md5 else ""


def _iso(ts: int) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts or 0))


def _http_date(ts: int) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts or 0))


def _ns(elem: ET.Element) -> str:
    return elem.tag.split("}")[0] + "}" if "}" in elem.tag else ""


def _xml_response(root: ET.Element, status: int = 200):
    body = b'<?xml version="1.0" encoding="UTF-8"?>\n' + ET.tostring(root)
    return _response(body=body, status=status,
                     content_type="application/xml")


def _error_response(e: S3Error, resource: str):
    root = ET.Element("Error")
    ET.SubElement(root, "Code").text = e.code
    ET.SubElement(root, "Message").text = e.message
    ET.SubElement(root, "Resource").text = resource
    resp = _xml_response(root, e.status)
    if e.status == 503:
        # SlowDown answers carry Retry-After (the qos scheduler's
        # bucket ETA when admission refused; 1s for plain breaker
        # trips) so SDK backoff has a server-provided hint
        resp.headers["Retry-After"] = str(
            getattr(e, "retry_after_s", None) or 1)
    return resp


def _response(body=b"", status: int = 200, headers: "dict | None" = None,
              content_type: str = "application/octet-stream"):
    """A fastweb Response as the reference's `web.Response(...)`: a
    Content-Type in `headers` becomes the response's content type."""
    headers = dict(headers or {})
    ctype = headers.pop("Content-Type", None) or content_type
    return fastweb.Response(body, status=status, content_type=ctype,
                            headers=headers)


async def _drain_body(req) -> None:
    """Read what is left of a streamed request body (a handler that
    answered early, such as a 403 or NoSuchBucket, left it unread), so the
    client reads its answer on a connection that stays usable."""
    stream = req.stream
    if stream.complete:
        return
    try:
        async for _piece in stream:
            pass
    except (ConnectionError, OSError):
        pass  # the client went away: fastweb closes the connection


class _S3Request:
    """A fastweb Request seen as the reference's aiohttp request: the
    decoded path, the query as a dict, case-insensitive headers,
    `content_type` and `http_range` as aiohttp parses them, the body
    (`read()` or the `stream`), and per-request values (`request[k]`)."""

    __slots__ = ("_req", "_vars")

    def __init__(self, req):
        self._req = req
        self._vars: dict = {}

    @property
    def method(self) -> str:
        return self._req.method

    @property
    def path(self) -> str:
        return self._req.path

    @property
    def headers(self):
        return self._req.headers

    @property
    def query(self) -> dict:
        return self._req.query

    @property
    def stream(self):
        return self._req.stream

    @property
    def content_type(self) -> str:
        from ..filer.filer_server import _content_type
        return _content_type(self._req.headers.get("content-type"))

    @property
    def http_range(self) -> slice:
        from ..filer.filer_server import _http_range
        start, stop = _http_range(self._req.headers.get("range"))
        return slice(start, stop)

    async def read(self) -> bytes:
        return await self._req.stream.read_all()

    def get(self, key, default=None):
        return self._vars.get(key, default)

    def __setitem__(self, key, value) -> None:
        self._vars[key] = value
