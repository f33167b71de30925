"""The port's fastweb: its streamed request bodies and streamed responses
(the filer's HTTP plane), and the buffered routes that stay as they were.

Every server here is the port's `utils/fastweb.serve_fast_app` on a
loopback port, driven by raw sockets (so the test decides when each byte
leaves) or by `http.client`.
"""

from __future__ import annotations

import asyncio
import hashlib
import http.client
import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.utils import fastweb

from torch_cluster import free_port_pair


@pytest.fixture
def serve():
    """serve(app) -> port; every server stops at the end of the test."""
    stops = []

    def start(app):
        port = free_port_pair()
        stop = threading.Event()
        t = threading.Thread(target=fastweb.serve_fast_app,
                             args=(app, "127.0.0.1", port, stop),
                             daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port), 0.5).close()
                break
            except OSError:
                time.sleep(0.02)
        stops.append((stop, t))
        return port

    yield start
    for stop, t in stops:
        stop.set()
        t.join(5)


def _recv_response(sock: socket.socket) -> "tuple[int, dict, bytes]":
    """One HTTP/1.1 response with a Content-Length body off a raw socket."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        got = sock.recv(65536)
        if not got:
            raise ConnectionError("closed before the head")
        buf += got
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {k.lower(): v.strip() for k, _, v in
               (ln.partition(":") for ln in lines[1:])}
    n = int(headers.get("content-length", "0"))
    while len(rest) < n:
        got = sock.recv(65536)
        if not got:
            break
        rest += got
    return status, headers, rest


def _streaming_app(delay_s: float = 0.0):
    """A streamed catch-all that sums the body; `seen` records each piece's
    size and the stream object, `first` is set at the first piece."""
    seen = {"pieces": [], "stream": None, "error": None}
    first = threading.Event()

    async def handler(req):
        seen["stream"] = req.stream
        h = hashlib.sha256()
        n = 0
        try:
            async for piece in req.stream:
                seen["pieces"].append(len(piece))
                first.set()
                h.update(piece)
                n += len(piece)
                if delay_s:
                    await asyncio.sleep(delay_s)
        except ConnectionError as e:
            seen["error"] = e
            raise
        return fastweb.json_response({"n": n, "sha": h.hexdigest()})

    app = fastweb.FastApp()
    app.default(handler, stream_body=True)
    return app, seen, first


def test_streamed_body_pieces_arrive_before_the_body_ends(serve):
    app, seen, first = _streaming_app()
    port = serve(app)
    body = np.random.default_rng(1).bytes(300_000)
    with socket.create_connection(("127.0.0.1", port), 10) as s:
        s.sendall(b"PUT /x HTTP/1.1\r\nHost: t\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body[:1000])
        # the handler holds the first piece while the rest is unsent
        assert first.wait(10)
        assert sum(seen["pieces"]) == 1000
        s.sendall(body[1000:])
        status, _, resp = _recv_response(s)
    assert status == 200
    assert resp.decode() == (
        f'{{"n": {len(body)}, "sha": "{hashlib.sha256(body).hexdigest()}"}}')


@pytest.mark.parametrize("chunked", [False, True])
def test_streamed_body_bound_holds(serve, chunked, monkeypatch):
    bound = 64 << 10
    monkeypatch.setattr(fastweb, "STREAM_BOUND", bound)
    app, seen, _ = _streaming_app(delay_s=0.002)
    port = serve(app)
    body = np.random.default_rng(2).bytes(4 << 20)
    with socket.create_connection(("127.0.0.1", port), 30) as s:
        if chunked:
            wire = b"".join(b"%x\r\n" % len(body[i:i + 200_000])
                            + body[i:i + 200_000] + b"\r\n"
                            for i in range(0, len(body), 200_000))
            s.sendall(b"PUT /x HTTP/1.1\r\nHost: t\r\n"
                      b"Transfer-Encoding: chunked\r\n\r\n"
                      + wire + b"0\r\n\r\n")
        else:
            s.sendall(b"PUT /x HTTP/1.1\r\nHost: t\r\nContent-Length: "
                      + str(len(body)).encode() + b"\r\n\r\n" + body)
        status, _, resp = _recv_response(s)
    assert status == 200
    assert hashlib.sha256(body).hexdigest() in resp.decode()
    st = seen["stream"]
    assert st.received == len(body) and st.complete
    assert st.max_queued <= bound, st.max_queued
    assert max(seen["pieces"]) <= bound
    assert st.max_piece <= bound
    # the queue did fill: reading was paused and resumed
    assert st.max_queued > bound // 2


@pytest.mark.parametrize("sizes", [[1], [5, 0], [70_000, 3, 65_536, 1]],
                         ids=["one-byte", "tiny", "mixed"])
def test_streamed_body_chunked_encoding(serve, sizes):
    app, seen, _ = _streaming_app()
    port = serve(app)
    rng = np.random.default_rng(3)
    parts = [rng.bytes(n) for n in sizes if n]
    wire = b"".join(b"%x;ext=1\r\n" % len(p) + p + b"\r\n" for p in parts)
    with socket.create_connection(("127.0.0.1", port), 10) as s:
        # trailers after the last chunk are consumed, and the connection
        # stays alive for a second request
        s.sendall(b"POST /c HTTP/1.1\r\nHost: t\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n" + wire
                  + b"0\r\nX-Trailer: 1\r\n\r\n")
        status, _, resp = _recv_response(s)
        assert status == 200
        body = b"".join(parts)
        assert resp.decode() == (f'{{"n": {len(body)}, "sha": '
                                 f'"{hashlib.sha256(body).hexdigest()}"}}')
        s.sendall(b"POST /c HTTP/1.1\r\nHost: t\r\nContent-Length: 3\r\n"
                  b"\r\nabc")
        status, _, resp = _recv_response(s)
        assert status == 200 and '"n": 3' in resp.decode()


def test_streamed_body_client_drop_ends_with_an_error(serve):
    app, seen, first = _streaming_app()
    port = serve(app)
    s = socket.create_connection(("127.0.0.1", port), 10)
    s.sendall(b"PUT /x HTTP/1.1\r\nHost: t\r\nContent-Length: 100000\r\n\r\n"
              + b"x" * 5000)
    assert first.wait(10)
    s.close()
    deadline = time.monotonic() + 10
    while seen["error"] is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert isinstance(seen["error"], ConnectionError)
    assert seen["stream"].received == 5000 and not seen["stream"].complete


def test_streamed_body_blocking_iter_from_a_worker(serve, monkeypatch):
    """A worker thread reads the body through blocking_iter, as the filer's
    chunking writer does; an unread body closes the connection after the
    answer."""
    got = {}

    async def handler(req):
        loop = asyncio.get_running_loop()
        if req.path == "/skip":
            return fastweb.text_response("skipped")
        data = await loop.run_in_executor(
            None, lambda: b"".join(req.stream.blocking_iter(loop)))
        got["data"] = data
        return fastweb.text_response(str(len(data)))

    app = fastweb.FastApp()
    monkeypatch.setattr(fastweb, "STREAM_BOUND", 8192)
    app.default(handler, stream_body=True)
    port = serve(app)
    body = np.random.default_rng(4).bytes(200_000)
    with socket.create_connection(("127.0.0.1", port), 10) as s:
        s.sendall(b"PUT /w HTTP/1.1\r\nHost: t\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body)
        status, _, resp = _recv_response(s)
    assert status == 200 and resp == b"200000" and got["data"] == body
    with socket.create_connection(("127.0.0.1", port), 10) as s:
        s.sendall(b"PUT /skip HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: 1000000\r\n\r\n" + b"y" * 100)
        status, headers, resp = _recv_response(s)
        assert status == 200 and resp == b"skipped"
        assert headers["connection"] == "close"
        assert s.recv(10) == b""


def _response_app():
    def gen(n, fail_at=None):
        for i in range(n):
            if fail_at is not None and i == fail_at:
                raise OSError("chunk fetch failed")
            yield bytes([i % 251]) * 65536

    async def agen(n):
        for i in range(n):
            await asyncio.sleep(0)
            yield bytes([i % 251]) * 65536

    def handler(req):
        n = int(req.query.get("n", "4"))
        kind = req.query.get("kind", "sync")
        if kind == "sync":
            body = gen(n)
        elif kind == "async":
            body = agen(n)
        elif kind == "fail":
            body = gen(n, fail_at=n // 2)
        else:  # short: the iterator ends before the stated length
            body = gen(n - 1)
        resp = fastweb.Response(body, status=206, content_type="x/y",
                                headers={"X-K": kind},
                                content_length=n * 65536)
        app.sent.append(resp)
        return resp

    app = fastweb.FastApp()
    app.default(handler)
    app.sent = []
    return app


def _expected(n: int) -> bytes:
    return b"".join(bytes([i % 251]) * 65536 for i in range(n))


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_streamed_response_and_keep_alive(serve, kind):
    port = serve(_response_app())
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    for n in (4, 33):
        conn.request("GET", f"/o?n={n}&kind={kind}")
        r = conn.getresponse()
        assert r.status == 206 and r.getheader("Content-Type") == "x/y"
        assert r.getheader("X-K") == kind
        assert int(r.getheader("Content-Length")) == n * 65536
        assert r.read() == _expected(n)
    # HEAD: the head alone, the stated length, and the connection lives on
    conn.request("HEAD", f"/o?n=7&kind={kind}")
    r = conn.getresponse()
    assert int(r.getheader("Content-Length")) == 7 * 65536
    assert r.read() == b""
    conn.request("GET", f"/o?n=2&kind={kind}")
    assert conn.getresponse().read() == _expected(2)
    conn.close()


@pytest.mark.parametrize("kind", ["fail", "short"])
def test_streamed_response_failure_truncates(serve, kind):
    port = serve(_response_app())
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", f"/o?n=8&kind={kind}")
    r = conn.getresponse()
    assert int(r.getheader("Content-Length")) == 8 * 65536
    with pytest.raises(http.client.IncompleteRead) as ei:
        r.read()
    got = ei.value.partial
    assert len(got) < 8 * 65536 and _expected(8).startswith(got)
    conn.close()


def test_streamed_response_to_a_slow_reader(serve):
    """A peer that reads slowly holds the writer at the transport's high
    water mark: the transport never holds more than one piece past it
    (asyncio's default mark, 64 KiB), and every byte still arrives in
    order."""
    app = _response_app()
    port = serve(app)
    with socket.create_connection(("127.0.0.1", port), 30) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 65536)
        s.sendall(b"GET /o?n=32 HTTP/1.1\r\nHost: t\r\n\r\n")
        time.sleep(0.3)
        status, headers, body = _recv_response(s)
    assert status == 206 and body == _expected(32)
    (resp,) = app.sent
    assert resp.max_piece == 65536
    # whatever the socket buffers did not take, never more than one piece
    # past the high-water mark
    assert resp.max_buffered <= 65536 + (64 << 10)


def test_buffered_route_is_unchanged(serve):
    seen = {}

    def handler(req):
        seen["stream"] = req.stream
        seen["body"] = req.body
        return fastweb.Response(req.body[::-1], content_type="a/b")

    app = fastweb.FastApp()
    app.route("/buf", handler)
    app.default(handler, stream_body=True)
    assert app.stream_bound("/buf") == 0
    assert app.stream_bound("/other") == fastweb.STREAM_BOUND
    port = serve(app)
    body = np.random.default_rng(5).bytes(100_000)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", "/buf", body=body)
    r = conn.getresponse()
    assert r.status == 200 and r.read() == body[::-1]
    assert seen["stream"] is None and seen["body"] == body
    # chunked on a buffered route: still one whole body
    conn.request("POST", "/buf", body=iter([body[:10], body[10:]]),
                 encode_chunked=True)
    assert conn.getresponse().read() == body[::-1]
    conn.close()
    with pytest.raises(ValueError):
        fastweb.Response(iter([b"x"]))
