"""In-process GCS JSON-API double over fastweb.

Media upload/download, object metadata, paged listing, delete — with
Bearer-token enforcement, so remote/gcs.py is exercised over the wire
offline (zero-egress image; reference tests hit real GCS).

The port's copy of seaweedfs_tpu/utils/mini_gcs.py."""

from __future__ import annotations

import json
import threading
import urllib.parse

from . import fastweb
from .log import logger

log = logger("mini-gcs")


class MiniGcs:
    def __init__(self, token: str = "dev-token", ip: str = "127.0.0.1",
                 port: int = 0):
        import socket
        self.token = token
        if port == 0:
            s = socket.socket()
            s.bind((ip, 0))
            port = s.getsockname()[1]
            s.close()
        self.ip, self.port = ip, port
        self._stop = threading.Event()
        self._buckets: dict[str, dict[str, bytes]] = {}
        self._lock = threading.Lock()

    @property
    def endpoint(self) -> str:
        return f"http://{self.ip}:{self.port}"

    def start(self) -> "MiniGcs":
        app = fastweb.FastApp()
        app.default(self._handle)
        threading.Thread(
            target=fastweb.serve_fast_app,
            args=(app, self.ip, self.port, self._stop),
            kwargs={"logger": log}, daemon=True, name="mini-gcs").start()
        import time
        time.sleep(0.2)
        return self

    def stop(self) -> None:
        self._stop.set()

    def _handle(self, req: fastweb.Request) -> fastweb.Response:
        if req.headers.get("Authorization") != f"Bearer {self.token}":
            return fastweb.json_response({"error": "unauthorized"}, 401)
        parts = req.path.strip("/").split("/")
        with self._lock:
            # POST /upload/storage/v1/b/{bucket}/o?uploadType=media&name=
            if req.method == "POST" and parts[:1] == ["upload"]:
                bucket = parts[4]
                name = req.query.get("name", "")
                self._buckets.setdefault(bucket, {})[name] = req.body
                return fastweb.json_response(
                    {"name": name, "size": str(len(req.body))})
            # /storage/v1/b/{bucket}/o[/{object}]
            if parts[:3] == ["storage", "v1", "b"]:
                bucket = parts[3]
                objs = self._buckets.setdefault(bucket, {})
                if len(parts) == 5:  # listing
                    prefix = req.query.get("prefix", "")
                    token = req.query.get("pageToken", "")
                    names = sorted(n for n in objs if n.startswith(prefix))
                    if token:
                        names = [n for n in names if n > token]
                    page, rest = names[:2], names[2:]
                    doc = {"items": [{"name": n, "size": str(len(objs[n]))}
                                     for n in page]}
                    if rest:
                        doc["nextPageToken"] = page[-1]
                    return fastweb.json_response(doc)
                # fastweb unquotes %2F in the path, so a slashed object
                # name arrives as extra path segments — rejoin them
                name = urllib.parse.unquote("/".join(parts[5:]))
                data = objs.get(name)
                if req.method == "DELETE":
                    if objs.pop(name, None) is None:
                        return fastweb.json_response({"error": "nf"}, 404)
                    return fastweb.Response(b"", status=204)
                if data is None:
                    return fastweb.json_response({"error": "nf"}, 404)
                if req.query.get("alt") == "media":
                    rng = req.headers.get("Range", "")
                    if rng.startswith("bytes="):
                        lo, _, hi = rng[6:].partition("-")
                        return fastweb.Response(
                            data[int(lo):int(hi) + 1 if hi else None],
                            status=206)
                    return fastweb.Response(data)
                return fastweb.json_response(
                    {"name": name, "size": str(len(data))})
        return fastweb.json_response({"error": "bad request"}, 400)
