"""Lean keep-alive HTTP client for the cluster data plane.

`requests` costs ~1 ms of client CPU per call (session plumbing, cookie
jars, urllib3 pooling) and stdlib `http.client` still ~90 us; on a loopback
cluster both dwarf the server's own work. This is a minimal HTTP/1.1 client
on raw sockets — one persistent connection per (thread, host), flat
request-bytes assembly, buffered-reader response parse (~15 us/round-trip).
It plays the role the reference's shared Go `http.Client` transport does
(reference: weed/util/http/http_global_client_util.go).

All cluster-internal callers (operation.py, master_client assigns,
bench_tool) share it via the module-level request()/get()/post() helpers.

The port's copy of the JAX package's client/http_util.py, with the QoS
class of the calling flow on every request as the `x-swtpu-qos` header.
One addition: `send()` is one round trip without the envelope, for callers
that run their own (the volume server's replica fan-out and proxy read,
which the JAX package makes with aiohttp, a package the port does not use).
"""

from __future__ import annotations

import socket
import threading
import time
import urllib.parse
import uuid


from .. import tracing
from ..utils import failpoints, retry
from ..utils.env import env_float, env_int
from ..utils.fastweb import Headers  # shared case-insensitive header dict

# Keep-alive pool hygiene: without caps a long-lived bulk-ingest client
# pins one socket per (thread, host) forever — stale after a volume
# server restart (first request eats a reconnect) and unbounded across
# wide topologies. Age/idle limits recycle sockets proactively; the
# per-thread connection cap evicts the least-recently-used host.
POOL_MAX_IDLE_S = env_float("SWTPU_HTTP_POOL_IDLE_S", 60.0)
POOL_MAX_AGE_S = env_float("SWTPU_HTTP_POOL_MAX_AGE_S", 600.0)
POOL_MAX_CONNS = max(1, env_int("SWTPU_HTTP_POOL_CONNS", 32))


class Response:
    __slots__ = ("status", "headers", "content")

    def __init__(self, status: int, headers: Headers, content: bytes):
        self.status = status
        self.headers = headers
        self.content = content

    def json(self):
        import json
        return json.loads(self.content) if self.content else {}

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


class _Conn:
    __slots__ = ("sock", "rfile", "used", "created", "last_used")

    def __init__(self, netloc: str, timeout: float):
        host, _, port = netloc.rpartition(":")
        self.sock = socket.create_connection((host or netloc,
                                              int(port) if port else 80),
                                             timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb", buffering=1 << 16)
        self.used = 0  # requests served; >0 = reused pool connection
        self.created = self.last_used = time.monotonic()

    def close(self) -> None:
        try:
            self.rfile.close()
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (discarding a dead socket)
            pass
        try:
            self.sock.close()
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (discarding a dead socket)
            pass


_local = threading.local()


def _conn(netloc: str, timeout: float) -> _Conn:
    pool = getattr(_local, "pool", None)
    if pool is None:
        pool = _local.pool = {}
    now = time.monotonic()
    c = pool.get(netloc)
    if c is not None and (now - c.created > POOL_MAX_AGE_S
                          or now - c.last_used > POOL_MAX_IDLE_S):
        # proactive recycle: an aged/idle socket is likely half-dead
        # (server restarted, LB idle-closed) — paying a fresh dial here
        # beats a send-then-_Stale round trip on the next request
        pool.pop(netloc, None)
        c.close()
        c = None
    if c is None:
        c = _Conn(netloc, timeout)
        pool[netloc] = c
        while len(pool) > POOL_MAX_CONNS:
            # cap the per-thread pool: evict least-recently-used OTHER
            # hosts so wide-topology clients don't hoard sockets (loop:
            # a lowered cap must shrink an over-full pool, not trail it)
            victim = min((k for k in pool if k != netloc),
                         key=lambda k: pool[k].last_used)
            pool.pop(victim).close()
    else:
        c.sock.settimeout(timeout)
        try:
            from ..stats import HTTP_POOL_REUSE
            HTTP_POOL_REUSE.inc()
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break IO)
            pass
    c.last_used = now
    return c


def _drop(netloc: str) -> None:
    pool = getattr(_local, "pool", None)
    if pool is not None:
        c = pool.pop(netloc, None)
        if c is not None:
            c.close()


class _Stale(Exception):
    """Server closed a kept-alive connection between requests."""


def _read_response(c: _Conn, method: str) -> tuple[Response, bool]:
    """Parse one response; returns (response, keep_alive). 1xx interim
    responses (e.g. 100 Continue) are consumed and the NEXT response is
    returned — surfacing an interim as final would leave the real
    response unread on the kept-alive socket, desynchronizing the pool."""
    while True:
        resp, keep = _read_one_response(c, method)
        if not 100 <= resp.status < 200:
            return resp, keep


def _read_one_response(c: _Conn, method: str) -> tuple[Response, bool]:
    rf = c.rfile
    line = rf.readline(8192)
    if not line:
        raise _Stale("connection closed")
    parts = line.split(None, 2)
    if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
        raise OSError(f"malformed status line: {line[:80]!r}")
    try:
        status = int(parts[1])
    except ValueError:
        raise OSError(f"malformed status line: {line[:80]!r}") from None
    version_11 = parts[0].endswith(b"1.1")
    headers = Headers()
    while True:
        ln = rf.readline(8192)
        if ln in (b"\r\n", b"\n", b""):
            break
        k, _, v = ln.partition(b":")
        headers[k.strip().lower().decode("latin1")] = \
            v.strip().decode("latin1")
    conn_tok = headers.get("connection", "").lower()
    keep = (version_11 and conn_tok != "close") or conn_tok == "keep-alive"
    if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
        return Response(status, headers, b""), keep
    te = headers.get("transfer-encoding", "")
    if "chunked" in te.lower():
        chunks = []
        while True:
            size_line = rf.readline(8192)
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise OSError(f"bad chunk size {size_line[:40]!r}") from None
            if size == 0:
                while True:  # trailers until blank line
                    t = rf.readline(8192)
                    if t in (b"\r\n", b"\n", b""):
                        break
                break
            data = rf.read(size + 2)  # chunk + CRLF
            if len(data) < size + 2:
                raise OSError("truncated chunk")
            chunks.append(data[:size])
        return Response(status, headers, b"".join(chunks)), keep
    cl = headers.get("content-length")
    if cl is not None:
        try:
            n = int(cl)
        except ValueError:
            raise OSError(f"bad content-length {cl!r}") from None
        body = rf.read(n) if n else b""
        if len(body) < n:
            raise OSError("truncated response body")
        return Response(status, headers, body), keep
    # no framing: read to EOF, connection is done
    body = rf.read()
    return Response(status, headers, body), False


def _split(url: str, params: dict | None) -> tuple[str, str]:
    """(netloc, path with the query) of a URL and extra query params."""
    if "://" in url:
        _, rest = url.split("://", 1)
    else:
        rest = url
    slash = rest.find("/")
    netloc, path = (rest, "/") if slash < 0 else (rest[:slash], rest[slash:])
    if params:
        sep = "&" if "?" in path else "?"
        path = path + sep + urllib.parse.urlencode(params)
    return netloc, path


def _request_bytes(method: str, netloc: str, path: str, body: bytes,
                   headers: dict | None) -> bytes:
    head = f"{method} {path} HTTP/1.1\r\nHost: {netloc}\r\n"
    if headers:
        for k, v in headers.items():
            head += f"{k}: {v}\r\n"
    # trace-context propagation: a sampled active span rides every hop as
    # a W3C traceparent header; unsampled/absent adds NOTHING to the wire
    traceparent = tracing.injectable()
    if traceparent:
        head += f"{tracing.TRACEPARENT_HEADER}: {traceparent}\r\n"
    # QoS class tag: a maintenance-tagged flow stays maintenance-class
    # across the hop (the serving node's admission reads it)
    from .. import qos as _qos
    qos_class = _qos.injectable()
    if qos_class:
        head += f"{_qos.QOS_HEADER}: {qos_class}\r\n"
    if body or method in ("POST", "PUT"):
        head += f"Content-Length: {len(body)}\r\n"
    return head.encode("latin1") + b"\r\n" + body


def request(method: str, url: str, body: bytes | None = None,
            headers: dict | None = None, params: dict | None = None,
            timeout: float = 60.0, max_attempts: int | None = None,
            policy: "retry.RetryPolicy | None" = None,
            fail_fast_open: bool = False) -> Response:
    """One logical HTTP round-trip with the shared fault-tolerance
    envelope (utils/retry.py): per-peer circuit breaker, bounded
    attempts with full-jitter exponential backoff, an overall deadline
    on top of the per-attempt socket `timeout`, and the process retry
    budget.

    A stale keep-alive connection (server closed it between requests)
    gets one transparent immediate reconnect — that's a liveness race,
    not peer trouble, so it costs neither backoff nor breaker credit.
    The blind retry on other socket errors is restricted to idempotent
    methods and to failures BEFORE the request was fully sent: a
    slow-but-alive server may have already EXECUTED a POST/PUT whose
    response timed out, and re-sending would duplicate the mutation
    (duplicate assigns leak file keys) — those errors surface to the
    caller immediately.
    """
    netloc, path = _split(url, params)
    req_bytes = _request_bytes(method, netloc, path, body or b"", headers)
    idempotent = method in ("GET", "HEAD", "DELETE", "OPTIONS")
    pol = policy or retry.DEFAULT_POLICY
    attempts = max_attempts or pol.max_attempts
    deadline = time.monotonic() + pol.deadline
    br = retry.breaker(netloc)
    attempt = 0
    stale_retried = False
    last_err: Exception | None = None
    while True:
        attempt += 1
        if not br.allow() and fail_fast_open:
            # `fail_fast_open` is for replica-iterating callers that still
            # hold ANOTHER candidate: they move on instead of burning a
            # connect timeout here. The default attempts anyway — an open
            # breaker must cost latency, never availability, when this
            # netloc is the only way to serve the request.
            tracing.add_event("breaker_open", peer=netloc,
                              state=br.state)
            raise retry.BreakerOpenError(netloc, br.remaining_cooldown())
        sent = False
        reused = False
        try:
            # flaky-wire site: a fault here is pre-send, safe for any
            # method to retry (chaos schedules arm it with pct:P)
            failpoints.check("http.request")
            c = _conn(netloc, timeout)
            reused = c.used > 0
            c.used += 1
            c.sock.sendall(req_bytes)
            sent = True
            resp, keep = _read_response(c, method)
            if not keep:
                _drop(netloc)
            br.record_success()
            retry.BUDGET.deposit()
            return resp
        except _Stale:
            _drop(netloc)
            # On a REUSED connection this is the idle keep-alive close
            # race (the server closed before seeing the request): any
            # method retries immediately and for free. On a FRESH
            # connection the server accepted the request and closed
            # without a response — a mutation may have executed, so the
            # idempotency guard applies like any read-phase failure.
            if reused and not stale_retried:
                stale_retried = True
                attempt -= 1  # the free reconnect, not a real retry
                continue
            last_err = OSError(f"connection to {netloc} closed")
            br.record_failure()
            if sent and not reused and not idempotent:
                raise last_err from None
        except failpoints.FailpointError as e:
            last_err = e
            br.record_failure()
        except (ConnectionError, BrokenPipeError, socket.timeout, OSError) as e:
            _drop(netloc)
            br.record_failure()
            last_err = e
            # send-phase failure: the request never went out whole, any
            # method retries. Read-phase failure after a full send: the
            # server may have EXECUTED the mutation — only idempotent
            # methods retry blindly.
            if sent and not idempotent:
                raise
        if attempt >= attempts:
            raise last_err
        delay = pol.backoff(attempt)
        if time.monotonic() + delay > deadline:
            raise last_err  # the envelope is spent: fail now, not later
        if not retry.BUDGET.withdraw():
            raise last_err
        try:
            from ..stats import RETRY_ATTEMPTS
            RETRY_ATTEMPTS.inc(f"http.{method}")
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break IO)
            pass
        tracing.add_event("retry", op=f"http.{method}", peer=netloc,
                          attempt=attempt, breaker=br.state,
                          delay_ms=round(delay * 1e3, 2),
                          error=str(last_err)[:200])
        time.sleep(delay)


def send(method: str, url: str, body: bytes = b"",
         headers: dict | None = None, timeout: float = 60.0) -> Response:
    """One round trip on the pooled connection, with no envelope: no
    breaker accounting, no retry, no backoff, no failpoint. A stale
    kept-alive connection still gets its one free reconnect (a liveness
    race, not a failed attempt). For callers that run their own envelope
    around each attempt."""
    netloc, path = _split(url, None)
    req_bytes = _request_bytes(method, netloc, path, body or b"", headers)
    stale_retried = False
    while True:
        c = _conn(netloc, timeout)
        reused = c.used > 0
        c.used += 1
        try:
            c.sock.sendall(req_bytes)
            resp, keep = _read_response(c, method)
        except _Stale:
            _drop(netloc)
            if reused and not stale_retried:
                stale_retried = True
                continue
            raise OSError(f"connection to {netloc} closed") from None
        except OSError:
            _drop(netloc)
            raise
        if not keep:
            _drop(netloc)
        return resp


def get(url: str, params: dict | None = None, timeout: float = 60.0,
        headers: dict | None = None, max_attempts: int | None = None,
        fail_fast_open: bool = False) -> Response:
    return request("GET", url, params=params, timeout=timeout,
                   headers=headers, max_attempts=max_attempts,
                   fail_fast_open=fail_fast_open)


def post(url: str, body: bytes = b"", headers: dict | None = None,
         params: dict | None = None, timeout: float = 60.0) -> Response:
    return request("POST", url, body=body, headers=headers, params=params,
                   timeout=timeout)


def delete(url: str, params: dict | None = None,
           timeout: float = 30.0) -> Response:
    return request("DELETE", url, params=params, timeout=timeout)


def multipart_body(field: str, filename: str, data: bytes, mime: str,
                   extra_part_headers: dict | None = None) -> tuple[bytes, str]:
    """(body, content_type) for a single-file multipart/form-data POST."""
    boundary = uuid.uuid4().hex
    head = (f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="{field}"; '
            f'filename="{filename}"\r\n'
            f"Content-Type: {mime}\r\n")
    for k, v in (extra_part_headers or {}).items():
        head += f"{k}: {v}\r\n"
    body = (head.encode() + b"\r\n" + data
            + f"\r\n--{boundary}--\r\n".encode())
    return body, f"multipart/form-data; boundary={boundary}"
