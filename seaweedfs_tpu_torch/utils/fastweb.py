"""Hand-rolled asyncio HTTP/1.1 server for the hot data plane (the port's
copy of the JAX package's utils/fastweb.py; standard library only; at stop
it also closes open keep-alive connections, so the serving thread ends).

aiohttp spends ~200 us of CPU per request in stream/response plumbing —
acceptable for the filer/S3 control surfaces, fatal for the volume data
plane where the whole small-file budget is a few hundred us (the reference
serves this path with Go's net/http at ~20 us/req,
weed/server/volume_server_handlers.go). This is a minimal HTTP/1.1
implementation directly on asyncio.Protocol: flat bytes parsing, keep-alive,
chunked decode, one dict-lookup route table — ~100 us/req round-trip with a
keep-alive Python client, ~15 us with a raw-socket one.

Handlers are `handler(req: Request) -> Response | awaitable[Response]`;
sync handlers run inline on the loop (the storage engine is sync and
loopback-local, same as the aiohttp servers elsewhere in the tree).

Two opt-in features serve large objects (the filer) with bounded memory;
every other route keeps the buffered behaviour above:
* a streamed request body, per route (`app.route(path, h, stream_body=True)`
  or `app.default(h, stream_body=True)`): the handler starts once the head
  is parsed and reads `req.stream` (a `BodyStream`) as the pieces arrive,
  Content-Length or chunked. At most STREAM_BOUND bytes wait between the
  protocol and the handler; past that the protocol pauses reading the
  socket and resumes as the handler drains. A client that drops mid-body
  ends the stream with an error, never with a short body.
* a streamed response: a `Response` whose body is an iterator (sync, pulled
  on a worker thread, or async) of bytes, with the `content_length` the
  handler states. Pieces go out one by one, waiting while the peer is slow;
  an error mid-stream closes the connection, so the client sees a
  truncation. HEAD sends the head alone; keep-alive goes on after a stream
  that completes. The next piece is pulled only once the transport's
  buffer is below its high-water mark; the Response's `max_piece` and
  `max_buffered` are the high-water marks that show it.
"""

from __future__ import annotations

import asyncio
import inspect
import json as _json
import threading
import time
import urllib.parse
from collections import deque

_MAX_HEAD = 64 << 10
# bound of a streamed request body's queue (bytes waiting between the
# protocol and the handler)
STREAM_BOUND = 1 << 20


class Headers(dict):
    """dict with case-insensitive lookup (keys stored lower-case)."""

    def get(self, key, default=None):  # noqa: A003
        return dict.get(self, key.lower(), default)

    def __getitem__(self, key):
        return dict.__getitem__(self, key.lower())

    def __contains__(self, key):
        return dict.__contains__(self, key.lower())


class BodyStream:
    """A request body read as it arrives: `async for piece in req.stream`
    on the loop, or `blocking_iter()` from a worker thread. The protocol
    feeds it (on the loop thread) and never queues more than `bound` bytes;
    `max_queued` and `max_piece` are the high-water marks that show it."""

    def __init__(self, bound: int, on_drain):
        self.bound = bound
        self._q: deque = deque()
        self.queued = 0
        self.max_queued = 0
        self.max_piece = 0
        self.received = 0
        self.complete = False
        self._error: "BaseException | None" = None
        self._waiter: "asyncio.Future | None" = None
        self._on_drain = on_drain

    # -- protocol side (loop thread) -----------------------------------------
    def room(self) -> int:
        return self.bound - self.queued

    def feed(self, piece: bytes) -> None:
        n = len(piece)
        self._q.append(piece)
        self.queued += n
        self.received += n
        self.max_queued = max(self.max_queued, self.queued)
        self.max_piece = max(self.max_piece, n)
        self._wake()

    def finish(self) -> None:
        self.complete = True
        self._wake()

    def fail(self, exc: BaseException) -> None:
        if not self.complete and self._error is None:
            self._error = exc
            self._wake()

    def _wake(self) -> None:
        w = self._waiter
        if w is not None and not w.done():
            w.set_result(None)

    # -- handler side -----------------------------------------------------
    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        while True:
            if self._q:
                piece = self._q.popleft()
                self.queued -= len(piece)
                self._on_drain()
                return piece
            if self._error is not None:
                raise self._error
            if self.complete:
                raise StopAsyncIteration
            self._waiter = asyncio.get_running_loop().create_future()
            try:
                await self._waiter
            finally:
                self._waiter = None

    async def read_all(self) -> bytes:
        """The whole body in one buffer (for bodies the handler must hold
        whole anyway, such as a multipart form)."""
        out = bytearray()
        async for piece in self:
            out += piece
        return bytes(out)

    def blocking_iter(self, loop: asyncio.AbstractEventLoop):
        """Iterate the body from a worker thread: each piece is taken on
        `loop`. Raises ConnectionError if the loop stops first."""
        while True:
            fut = asyncio.run_coroutine_threadsafe(self._next_or_none(),
                                                   loop)
            while True:
                try:
                    piece = fut.result(timeout=1.0)
                    break
                except TimeoutError:
                    if not loop.is_running():
                        fut.cancel()
                        raise ConnectionError(
                            "server stopped mid-body") from None
            if piece is None:
                return
            yield piece

    async def _next_or_none(self) -> "bytes | None":
        try:
            return await self.__anext__()
        except StopAsyncIteration:
            return None


class Request:
    __slots__ = ("method", "path", "query_string", "headers", "body",
                 "remote", "_query", "t_recv", "t_parsed", "stream")

    def __init__(self, method: str, path: str, query_string: str,
                 headers: Headers, body: bytes, remote: str):
        self.method = method
        self.path = path
        self.query_string = query_string
        self.headers = headers
        self.body = body
        self.remote = remote
        self._query = None
        # the BodyStream of a route opened with stream_body=True (body is
        # then b""); None on buffered routes
        self.stream: "BodyStream | None" = None
        # perf_counter at the request's first wire byte, stamped by the
        # protocol; lets handlers charge a recv/parse profiling stage
        self.t_recv = 0.0
        # perf_counter when the request finished parsing and was queued
        # for dispatch: [t_recv, t_parsed] is wire receive + parse,
        # [t_parsed, handler entry] is pure queueing (drain queue +
        # event-loop wait) — the split that de-confounds recv_parse
        self.t_parsed = 0.0

    @property
    def query(self) -> dict:
        if self._query is None:
            self._query = dict(urllib.parse.parse_qsl(self.query_string,
                                                      keep_blank_values=True))
        return self._query


class Response:
    """`body` is bytes (or str), or an iterator of bytes (sync or async)
    streamed out piece by piece; a streamed body needs `content_length`.
    While a streamed body goes out, `max_piece` is its largest piece and
    `max_buffered` the most bytes the transport held right after a write."""

    __slots__ = ("status", "body", "content_type", "headers",
                 "content_length", "max_piece", "max_buffered")

    def __init__(self, body=b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: dict | None = None,
                 content_length: "int | None" = None):
        self.body = body.encode() if isinstance(body, str) else body
        self.status = status
        self.content_type = content_type
        self.headers = headers
        self.content_length = content_length
        self.max_piece = self.max_buffered = 0
        if _is_streamed(self.body) and content_length is None:
            raise ValueError("a streamed response needs its content_length")


def _is_streamed(body) -> bool:
    return not isinstance(body, (bytes, bytearray, memoryview))


def json_response(obj, status: int = 200) -> Response:
    return Response(_json.dumps(obj).encode(), status=status,
                    content_type="application/json")


def html_response(text: str, status: int = 200) -> Response:
    return Response(text.encode(), status=status,
                    content_type="text/html; charset=utf-8")


def text_response(text: str, status: int = 200) -> Response:
    return Response(text.encode(), status=status,
                    content_type="text/plain; charset=utf-8")


class Redirect(Exception):
    """Raise from a handler to answer with a redirect."""

    def __init__(self, location: str, status: int = 301):
        super().__init__(location)
        self.location = location
        self.status = status


class FastApp:
    """Exact-path route table plus a catch-all; method dispatch is the
    handler's business (the volume server routes on fid paths). A route
    opened with `stream_body=True` reads its body as a BodyStream of at
    most STREAM_BOUND queued bytes."""

    def __init__(self):
        self.routes: dict[str, object] = {}
        self.catch_all = None
        self._streamed: "set[str]" = set()
        self._catch_all_streams = False

    def route(self, path: str, handler, stream_body: bool = False) -> None:
        self.routes[path] = handler
        if stream_body:
            self._streamed.add(path)
        else:
            self._streamed.discard(path)

    def default(self, handler, stream_body: bool = False) -> None:
        self.catch_all = handler
        self._catch_all_streams = stream_body

    def stream_bound(self, path: str) -> int:
        """The body-queue bound of the route `path` dispatches to
        (STREAM_BOUND); 0 when that route buffers its body."""
        if path in self.routes:
            streams = path in self._streamed
        else:
            streams = self.catch_all is not None and self._catch_all_streams
        return STREAM_BOUND if streams else 0


_REASONS = {200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
            206: "Partial Content", 207: "Multi-Status",
            301: "Moved Permanently", 302: "Found", 304: "Not Modified",
            400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
            404: "Not Found", 405: "Method Not Allowed", 406: "Not Acceptable",
            409: "Conflict",
            411: "Length Required", 412: "Precondition Failed", 413: "Payload Too Large",
            416: "Range Not Satisfiable", 431: "Headers Too Large",
            500: "Internal Server Error", 503: "Service Unavailable"}


class _HttpProtocol(asyncio.Protocol):
    def __init__(self, app: FastApp, client_max_size: int, logger,
                 conns: "set | None" = None):
        self.app = app
        self.conns = conns if conns is not None else set()
        self.max_body = client_max_size
        self.log = logger
        self.transport = None
        self.remote = ""
        self.buf = bytearray()
        # in-flight parse state
        self._head = None          # (method, path, qs, headers) once parsed
        self._body = None          # bytearray accumulating the body
        self._need = 0             # remaining content-length bytes
        self._chunked = False
        self._chunk_rem = -1       # -1 = expecting a size line
        self._queue: deque = deque()
        self._worker: asyncio.Task | None = None
        self._closing = False
        self._poison = None  # (status, msg) once unparseable bytes arrive
        self._t_first = None  # perf_counter at current request's first byte
        self._stream: "BodyStream | None" = None  # body being streamed
        self._paused = False  # reading paused: the stream's queue is full

    # -- wire in -----------------------------------------------------------
    def connection_made(self, transport):
        self.transport = transport
        self.conns.add(self)
        peer = transport.get_extra_info("peername")
        self.remote = peer[0] if peer else ""
        # write backpressure: when the transport buffer crosses its high
        # water mark we stop draining further pipelined requests until the
        # slow reader catches up (bounds per-connection memory at roughly
        # high-water + one response body)
        self._can_write = asyncio.Event()
        self._can_write.set()

    def pause_writing(self):
        self._can_write.clear()

    def resume_writing(self):
        self._can_write.set()

    def data_received(self, data: bytes):
        if self._poison is not None:
            return  # already answering-then-closing; drop further bytes
        if self._t_first is None:
            self._t_first = time.perf_counter()
        self.buf += data
        try:
            self._pump()
        except _BadRequest as e:
            self._bad_request(e)

    def connection_lost(self, exc):
        self._closing = True
        self.conns.discard(self)
        if self._stream is not None:
            # the handler reading this body learns of the drop from the
            # stream (an error, never a short body) and ends on its own
            self._stream.fail(ConnectionResetError(
                "client closed the connection mid-body"))
            self._stream = None
        elif self._worker is not None:
            self._worker.cancel()

    def _stream_drained(self):
        """The handler took a piece: move bytes already buffered into the
        stream, and read the socket again once the queue has room."""
        if self._poison is not None or self._closing:
            return
        try:
            self._pump()
        except _BadRequest as e:
            self._bad_request(e)
            return
        if self._paused and (self._stream is None
                             or self._stream.room() > 0):
            self._paused = False
            self.transport.resume_reading()

    def _bad_request(self, e: Exception):
        # valid requests may already be queued ahead of the malformed
        # bytes; answer them in order first, THEN emit the 400+close
        # (otherwise a completed write's response would be swallowed and
        # the client would retry an applied mutation); a body being
        # streamed ends with the error
        self._poison = (400, str(e))
        self.buf.clear()
        if self._stream is not None:
            self._stream.fail(ConnectionError(f"bad request body: {e}"))
            self._stream = None
        if self._worker is None or self._worker.done():
            self._flush_poison()

    # -- parse -------------------------------------------------------------
    def _pump(self):
        while True:
            if self._head is None:
                i = self.buf.find(b"\r\n\r\n")
                if i < 0:
                    if len(self.buf) > _MAX_HEAD:
                        self._simple_error(431, "request head too large")
                    return
                head = bytes(self.buf[:i])
                del self.buf[:i + 4]
                self._parse_head(head)
                if self._head is None:
                    return  # errored out
                bound = self.app.stream_bound(self._head[1])
                if bound:
                    # streamed route: the handler starts now and reads the
                    # body as it arrives
                    method, path, qs, headers = self._head
                    req = Request(method, path, qs, headers, b"",
                                  self.remote)
                    req.stream = self._stream = BodyStream(
                        bound, self._stream_drained)
                    req.t_parsed = time.perf_counter()
                    req.t_recv = self._t_first or req.t_parsed
                    self._t_first = None
                    self._body = None
                    self._enqueue(req)
            if self._stream is not None:
                if not self._accumulate_body():
                    return
                self._stream.finish()
                self._stream = None
                self._head = None
                continue
            if not self._accumulate_body():
                return
            method, path, qs, headers = self._head
            req = Request(method, path, qs, headers, bytes(self._body),
                          self.remote)
            # pipelined followers in the same buffer get "now" — their
            # bytes arrived with the previous request's, so recv ~ 0
            req.t_parsed = time.perf_counter()
            req.t_recv = self._t_first or req.t_parsed
            self._t_first = None
            self._head, self._body = None, None
            self._enqueue(req)

    def _enqueue(self, req: Request):
        self._queue.append(req)
        if self._worker is None or self._worker.done():
            self._worker = asyncio.ensure_future(self._drain())

    def _parse_head(self, head: bytes):
        lines = head.split(b"\r\n")
        parts = lines[0].split(b" ")
        if len(parts) != 3:
            raise _BadRequest("malformed request line")
        method = parts[0].decode("latin1")
        target = parts[1].decode("latin1")
        headers = Headers()
        for ln in lines[1:]:
            k, _, v = ln.partition(b":")
            headers[k.strip().lower().decode("latin1")] = \
                v.strip().decode("latin1")
        q = target.find("?")
        if q < 0:
            path, qs = target, ""
        else:
            path, qs = target[:q], target[q + 1:]
        if "%" in path:
            path = urllib.parse.unquote(path)
        te = headers.get("transfer-encoding", "")
        self._chunked = "chunked" in te.lower()
        self._chunk_rem = -1
        if self._chunked:
            self._need = 0
        else:
            try:
                self._need = int(headers.get("content-length") or 0)
            except ValueError:
                raise _BadRequest("bad content-length") from None
            # a streamed route holds at most its bound, whatever the size
            if self._need > self.max_body and not self.app.stream_bound(
                    path):
                self._simple_error(413, "payload too large")
                return
        if headers.get("expect", "").lower() == "100-continue":
            self.transport.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        self._head = (method, path, qs, headers)
        self._body = bytearray()

    def _take(self, want: int) -> int:
        """How many body bytes to move now: a streamed body takes no more
        than its queue has room for, and pauses reading when it is full."""
        take = min(want, len(self.buf))
        if self._stream is not None:
            room = self._stream.room()
            if take > room:
                take = max(0, room)
                if not self._paused:
                    self._paused = True
                    self.transport.pause_reading()
        return take

    def _sink(self, take: int) -> None:
        if self._stream is not None:
            self._stream.feed(bytes(self.buf[:take]))
        else:
            self._body += self.buf[:take]
        del self.buf[:take]

    def _accumulate_body(self) -> bool:
        """Move body bytes from self.buf; True when the body is complete."""
        if not self._chunked:
            if self._need:
                take = self._take(self._need)
                if take:
                    self._sink(take)
                    self._need -= take
            return self._need == 0
        # chunked decode
        while True:
            if self._chunk_rem == -1:  # expecting a size line
                i = self.buf.find(b"\r\n")
                if i < 0:
                    return False
                size_tok = bytes(self.buf[:i]).split(b";")[0].strip()
                del self.buf[:i + 2]
                try:
                    size = int(size_tok, 16)
                except ValueError:
                    raise _BadRequest("bad chunk size") from None
                if size == 0:
                    self._chunk_rem = -2  # awaiting trailer CRLF
                else:
                    self._chunk_rem = size
            if self._chunk_rem == -2:
                # consume optional trailers up to the final CRLF
                i = self.buf.find(b"\r\n")
                if i < 0:
                    return False
                del self.buf[:i + 2]
                if i == 0:  # empty line: done
                    self._chunk_rem = -1
                    return True
                continue
            take = self._take(self._chunk_rem)
            if take:
                self._sink(take)
                self._chunk_rem -= take
                if self._stream is None and len(self._body) > self.max_body:
                    self._simple_error(413, "payload too large")
                    return False
            if self._chunk_rem:
                return False
            # chunk data done: eat trailing CRLF then next size line
            if len(self.buf) < 2:
                self._chunk_rem = 0
                return False
            del self.buf[:2]
            self._chunk_rem = -1

    # -- dispatch ----------------------------------------------------------
    async def _drain(self):
        while self._queue and not self._closing:
            req = self._queue.popleft()
            try:
                handler = self.app.routes.get(req.path) or self.app.catch_all
                if handler is None:
                    resp = json_response({"error": "not found"}, 404)
                else:
                    resp = handler(req)
                    if inspect.isawaitable(resp):
                        resp = await resp
            except Redirect as r:
                resp = Response(b"", status=r.status,
                                headers={"Location": r.location})
            except KeyError as e:
                resp = json_response({"error": str(e)}, 404)
            except PermissionError as e:
                resp = json_response({"error": str(e)}, 403)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                if self.log:
                    self.log.error("http error: %s", e)
                resp = json_response({"error": str(e)}, 500)
            if _is_streamed(resp.body):
                await self._send_stream(req, resp)
            else:
                self._send(req, resp)
            if not self._can_write.is_set():
                await self._can_write.wait()
        if self._poison is not None and not self._closing:
            self._flush_poison()

    def _flush_poison(self):
        status, msg = self._poison
        self._simple_error(status, msg)

    def _head_of(self, req: Request, resp: Response,
                 length: int) -> "tuple[bytes, bool]":
        status = resp.status
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
                f"Content-Type: {resp.content_type}\r\n"
                f"Content-Length: {length}\r\n")
        if resp.headers:
            for k, v in resp.headers.items():
                head += f"{k}: {v}\r\n"
        # a streamed body the handler left unread cannot be skipped on a
        # kept-alive connection: answer, then close
        close = (req.headers.get("connection", "").lower() == "close"
                 or (req.stream is not None and not req.stream.complete))
        if close:
            head += "Connection: close\r\n"
        return head.encode("latin1") + b"\r\n", close

    def _send(self, req: Request, resp: Response):
        if self.transport.is_closing():
            return
        body = resp.body
        head, close = self._head_of(req, resp, len(body))
        self.transport.write(head + (b"" if req.method == "HEAD" else body))
        if close:
            self.transport.close()
            self._closing = True

    async def _send_stream(self, req: Request, resp: Response):
        """Write a streamed body piece by piece, waiting while the peer is
        slow. The head promised `content_length` bytes: a failure or a
        short body mid-stream closes the connection (a truncation the
        client sees), never a short body that looks whole."""
        body = resp.body
        length = resp.content_length
        try:
            if self.transport.is_closing():
                return
            head, close = self._head_of(req, resp, length)
            self.transport.write(head)
            if req.method == "HEAD":
                if close:
                    self.transport.close()
                    self._closing = True
                return
            sent = 0
            pieces = _pieces(body)
            try:
                async for piece in pieces:
                    if not piece:
                        continue
                    sent += len(piece)
                    if sent > length:
                        raise ValueError(f"streamed body overran its "
                                         f"Content-Length {length}")
                    self.transport.write(piece)
                    resp.max_piece = max(resp.max_piece, len(piece))
                    resp.max_buffered = max(
                        resp.max_buffered,
                        self.transport.get_write_buffer_size())
                    if not self._can_write.is_set():
                        await self._can_write.wait()
                    if self.transport.is_closing():
                        return
                if sent != length:
                    raise ValueError(f"streamed body ended at {sent} of "
                                     f"{length} bytes")
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                if self.log:
                    self.log.warning("streamed response %s aborted: %r",
                                     req.path, e)
                close = True
            finally:
                await pieces.aclose()
            if close:
                self.transport.close()
                self._closing = True
        finally:
            await _close_body(body)

    def _simple_error(self, status: int, msg: str):
        body = _json.dumps({"error": msg}).encode()
        self.transport.write(
            (f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
             f"Content-Type: application/json\r\n"
             f"Content-Length: {len(body)}\r\n"
             f"Connection: close\r\n\r\n").encode("latin1") + body)
        self.transport.close()
        self._closing = True


class _BadRequest(Exception):
    pass


_END = object()


async def _pieces(body):
    """The pieces of a streamed body: an async iterator is read on the
    loop; a sync one is pulled on a worker thread (it may block, as a
    fetch from a volume server does), with the caller's context."""
    if hasattr(body, "__aiter__"):
        async for piece in body:
            yield piece
        return
    it = iter(body)
    while True:
        piece = await asyncio.to_thread(next, it, _END)
        if piece is _END:
            return
        yield piece


async def _close_body(body) -> None:
    try:
        if hasattr(body, "aclose"):
            await body.aclose()
        elif hasattr(body, "close"):
            body.close()
    except ValueError:
        # a cancelled send can land here while a worker is still inside
        # next() of the generator; it is reaped when that call returns
        pass


def parse_multipart_single(body: bytes, content_type: str):
    """First file part of a multipart/form-data body ->
    (data, filename, part_content_type, part_headers).

    The volume data plane only ever receives single-file uploads
    (reference needle_parse_upload.go parses exactly one part too).
    """
    import re
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise _BadRequest("multipart without boundary")
    delim = b"--" + m.group(1).encode("latin1")
    start = body.find(delim)
    if start < 0:
        raise _BadRequest("multipart boundary not found")
    h_end = body.find(b"\r\n\r\n", start)
    if h_end < 0:
        raise _BadRequest("multipart part headers not terminated")
    part_headers = Headers()
    for ln in body[start + len(delim):h_end].split(b"\r\n"):
        k, _, v = ln.partition(b":")
        if v:
            part_headers[k.strip().lower().decode("latin1")] = \
                v.strip().decode("latin1")
    data_start = h_end + 4
    data_end = body.find(b"\r\n" + delim, data_start)
    if data_end < 0:
        raise _BadRequest("multipart part not terminated")
    data = body[data_start:data_end]
    disp = part_headers.get("content-disposition", "")
    fm = re.search(r'filename="?([^";]*)"?', disp)
    filename = fm.group(1) if fm else ""
    return data, filename, part_headers.get("content-type", ""), part_headers


def serve_fast_app(app: FastApp, ip: str, port: int, stop: threading.Event,
                   client_max_size: int = 1 << 30, logger=None,
                   on_loop=None, ready: "threading.Event | None" = None
                   ) -> None:
    """Blocking serve loop (run on the daemon's HTTP thread), mirroring
    utils/webapp.serve_web_app's contract. `on_loop(loop)` runs on the
    loop thread once it exists — the seam the profiling plane's
    loop-lag probe installs through; `ready` is set once the port is
    bound. On stop, open keep-alive connections are closed too: the
    server's wait_closed waits for them."""

    async def main():
        loop = asyncio.get_running_loop()
        if on_loop is not None:
            on_loop(loop)
        conns: set = set()
        server = await loop.create_server(
            lambda: _HttpProtocol(app, client_max_size, logger, conns),
            ip, port, backlog=1024, reuse_address=True)
        if ready is not None:
            ready.set()
        try:
            while not stop.is_set():
                await asyncio.sleep(0.2)
        finally:
            server.close()
            for proto in list(conns):
                proto.transport.close()
            await server.wait_closed()

    asyncio.run(main())
