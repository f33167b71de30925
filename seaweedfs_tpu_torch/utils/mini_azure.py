"""In-process Azure Blob service double: REST + SharedKey over fastweb.

Implements the Blob-service subset the Azure client/sink uses — create
container, Put/Get/Head/Delete Blob, List Blobs XML with marker paging —
and VERIFIES every request's SharedKey signature with the same algorithm
a real account enforces, so remote/azure.py's signing is exercised over
the wire offline (reference integration tests hit real Azure; this image
has zero egress).

The port's copy of seaweedfs_tpu/utils/mini_azure.py, signing with the
port's `remote.azure.sign_shared_key`.
"""

from __future__ import annotations

import threading
import urllib.parse
import xml.sax.saxutils as sx

from ..remote.azure import sign_shared_key
from . import fastweb
from .log import logger

log = logger("mini-azure")


class MiniAzure:
    def __init__(self, account: str = "devaccount",
                 key_b64: str = "ZGV2LWtleS1kZXYta2V5LWRldi1rZXktZGV2LWtleQ==",
                 ip: str = "127.0.0.1", port: int = 0):
        import socket
        self.account = account
        self.key_b64 = key_b64
        if port == 0:
            s = socket.socket()
            s.bind((ip, 0))
            port = s.getsockname()[1]
            s.close()
        self.ip, self.port = ip, port
        self._stop = threading.Event()
        self._containers: dict[str, dict[str, bytes]] = {}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    @property
    def endpoint(self) -> str:
        return f"http://{self.ip}:{self.port}"

    def start(self) -> "MiniAzure":
        app = fastweb.FastApp()
        app.default(self._handle)
        self._thread = threading.Thread(
            target=fastweb.serve_fast_app,
            args=(app, self.ip, self.port, self._stop),
            kwargs={"logger": log}, daemon=True, name="mini-azure")
        self._thread.start()
        import time
        time.sleep(0.2)
        return self

    def stop(self) -> None:
        self._stop.set()

    # -- request handling ---------------------------------------------------
    def _handle(self, req: fastweb.Request) -> fastweb.Response:
        parts = req.path.lstrip("/").split("/", 1)
        container = parts[0]
        blob = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
        q = req.query
        # verify over the percent-encoded request path, like real Azure
        qblob = urllib.parse.quote(blob) if blob else ""
        expected = sign_shared_key(
            req.method, self.account, self.key_b64,
            f"/{container}" + (f"/{qblob}" if blob else ""), q,
            req.headers,  # case-insensitive view (Range, If-Match, ...)
            int(req.headers.get("Content-Length") or 0))
        if req.headers.get("Authorization") != expected:
            return fastweb.Response(
                b"<Error><Code>AuthenticationFailed</Code></Error>",
                status=403, content_type="application/xml")
        with self._lock:
            if not blob and q.get("restype") == "container":
                if req.method == "PUT":
                    if container in self._containers:
                        return fastweb.Response(b"", status=409)
                    self._containers[container] = {}
                    return fastweb.Response(b"", status=201)
                if req.method == "GET" and q.get("comp") == "list":
                    return self._list(container, q)
            blobs = self._containers.setdefault(container, {})
            if req.method == "PUT" and blob:
                if req.headers.get("x-ms-blob-type") != "BlockBlob":
                    return fastweb.Response(b"need x-ms-blob-type",
                                            status=400)
                blobs[blob] = req.body
                return fastweb.Response(b"", status=201)
            if req.method in ("GET", "HEAD") and blob:
                data = blobs.get(blob)
                if data is None:
                    return fastweb.Response(b"", status=404)
                rng = req.headers.get("Range", "")
                status = 200
                if rng.startswith("bytes="):
                    lo, _, hi = rng[6:].partition("-")
                    data = data[int(lo):int(hi) + 1 if hi else None]
                    status = 206
                if req.method == "HEAD":
                    return fastweb.Response(
                        b"", status=status,
                        headers={"Content-Length": str(len(blobs[blob]))})
                return fastweb.Response(data, status=status)
            if req.method == "DELETE" and blob:
                existed = blobs.pop(blob, None) is not None
                return fastweb.Response(b"", status=202 if existed else 404)
        return fastweb.Response(b"", status=400)

    def _list(self, container: str, q: dict) -> fastweb.Response:
        blobs = self._containers.get(container, {})
        prefix = q.get("prefix", "")
        marker = q.get("marker", "")
        names = sorted(n for n in blobs if n.startswith(prefix))
        if marker:
            names = [n for n in names if n > marker]
        page, rest = names[:2], names[2:]  # tiny pages exercise paging
        items = "".join(
            f"<Blob><Name>{sx.escape(n)}</Name>"
            f"<Properties><Content-Length>{len(blobs[n])}"
            f"</Content-Length></Properties></Blob>" for n in page)
        nxt = f"<NextMarker>{sx.escape(page[-1])}</NextMarker>" \
            if rest else "<NextMarker/>"
        xml = (f"<?xml version=\"1.0\"?><EnumerationResults>"
               f"<Blobs>{items}</Blobs>{nxt}</EnumerationResults>")
        return fastweb.Response(xml.encode(), status=200,
                                content_type="application/xml")
