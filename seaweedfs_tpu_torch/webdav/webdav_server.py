"""WebDAV server over the filer namespace.

Reference: weed/server/webdav_server.go (the golang.org/x/net/webdav
FileSystem adapter; OpenFile/Stat/Rename/RemoveAll/Mkdir map to filer
entry CRUD, file bytes ride the chunked-file model). We speak the
protocol directly: OPTIONS, PROPFIND (Depth 0/1), GET/HEAD, PUT, MKCOL,
DELETE, MOVE, COPY, and advisory LOCK/UNLOCK (class-2 clients like
macOS/Windows demand lock support; locks are process-local like the
reference's in-memory webdav.NewMemLS).

The port's copy of seaweedfs_tpu/webdav/webdav_server.py. Its differences:
* The HTTP plane runs on the port's utils/fastweb, not aiohttp (the port
  has none), as the port's filer and S3 gateway do. `_DavRequest` shows a
  fastweb Request to the handlers as the reference's aiohttp request: the
  path percent-decoded once (as aiohttp's `request.path`; spaces, `+`,
  `%`, `%2F` and non-ASCII names decode alike), `content_type` as aiohttp
  parses it, case-insensitive headers (a plain dict: a repeated header
  keeps its last value). A request line's raw non-ASCII bytes reach the
  handlers latin-1 decoded, where aiohttp decodes them as UTF-8; clients
  percent-encode names, and those decode alike.
* The handlers, which call the filer synchronously, run on a worker thread
  rather than on the loop, so one slow PUT does not hold other requests.
* A HEAD states the file's length with no body (a fastweb streamed
  response with no pieces), as aiohttp's does.
The bodies are the reference's: a PUT reads the whole body before it
writes (the route buffers it), and a GET answers the whole file, so a 16
MiB file costs 16 MiB of the gateway's memory a request, and a COPY the
file's size again. The gateway does no device work and imports no torch;
it runs over an in-process FilerServer or a FilerClient, as the
reference's does.
"""

from __future__ import annotations

import asyncio
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from ..filer.filer import join_path, split_path
from ..pb import filer_pb2 as fpb
from ..utils import fastweb
from ..utils.log import logger

log = logger("webdav")

DAV_NS = "DAV:"


def _dav(tag: str) -> str:
    return f"{{{DAV_NS}}}{tag}"


def _http_date(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))


def _text(status: int, text: str = "") -> fastweb.Response:
    return fastweb.Response(text.encode(), status=status,
                            content_type="text/plain; charset=utf-8")


def _xml(status: int, body: bytes, headers: "dict | None" = None
         ) -> fastweb.Response:
    return fastweb.Response(body, status=status,
                            content_type="application/xml", headers=headers)


class _DavRequest:
    """A fastweb Request seen as the reference's aiohttp request."""

    __slots__ = ("_req",)

    def __init__(self, req: fastweb.Request):
        self._req = req

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
    def content_type(self) -> str:
        from ..filer.filer_server import _content_type
        return _content_type(self._req.headers.get("content-type"))

    def read(self) -> bytes:
        return self._req.body


class WebDavServer:
    def __init__(self, filer_server, ip: str = "127.0.0.1", port: int = 7333,
                 root: str = "/"):
        self.fs = filer_server  # in-process FilerServer or a FilerClient
        self.ip, self.port = ip, port
        self.root = root.rstrip("/") or ""
        self._locks: dict[str, str] = {}  # path -> lock token
        self._lock_mu = threading.Lock()
        self._stop = threading.Event()
        self._http_thread: threading.Thread | None = None
        self._http_ready = threading.Event()
        self._http_error: "BaseException | None" = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> "WebDavServer":
        self._http_thread = threading.Thread(target=self._run_http,
                                             daemon=True,
                                             name=f"webdav-http-{self.port}")
        self._http_thread.start()
        self._http_ready.wait(10)  # port bound before start() returns
        if self._http_error is not None:
            raise self._http_error
        log.info("webdav %s up (root %s)", self.url, self.root or "/")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._http_thread is not None and \
                self._http_thread is not threading.current_thread():
            self._http_thread.join(5)

    # -- helpers -------------------------------------------------------------
    def _abs(self, request_path: str) -> str:
        # request.path is already percent-decoded; decoding again would
        # collapse literal %XX sequences in filenames
        p = "/" + request_path.strip("/")
        return (self.root + p).rstrip("/") or "/"

    def _find(self, path: str) -> fpb.Entry | None:
        if path == "/":
            e = fpb.Entry(name="/", is_directory=True)
            return e
        d, n = split_path(path)
        return self.fs.filer.find_entry(d, n)

    # -- HTTP ----------------------------------------------------------------
    def _run_http(self) -> None:
        handlers = {
            "OPTIONS": self._h_options, "PROPFIND": self._h_propfind,
            "GET": self._h_get, "HEAD": self._h_get, "PUT": self._h_put,
            "MKCOL": self._h_mkcol, "DELETE": self._h_delete,
            "MOVE": self._h_move, "COPY": self._h_copy,
            "LOCK": self._h_lock, "UNLOCK": self._h_unlock,
            "PROPPATCH": self._h_proppatch,
        }

        def handle(request: _DavRequest) -> fastweb.Response:
            h = handlers.get(request.method)
            if h is None:
                return _text(405)
            try:
                return h(request)
            except FileNotFoundError as e:
                return _text(404, str(e))
            except FileExistsError as e:
                return _text(409, str(e))
            except Exception as e:  # noqa: BLE001
                log.error("webdav %s %s: %r", request.method, request.path,
                          e)
                return _text(500, str(e))

        async def dispatch(req: fastweb.Request):
            return await asyncio.to_thread(handle, _DavRequest(req))

        app = fastweb.FastApp()
        app.default(dispatch)
        try:
            fastweb.serve_fast_app(app, self.ip, self.port, self._stop,
                                   logger=log, ready=self._http_ready)
        except BaseException as e:  # noqa: BLE001 — start() reports it
            self._http_error = e
            self._http_ready.set()

    def _h_options(self, request):
        return fastweb.Response(b"", status=200, headers={
            "DAV": "1, 2", "MS-Author-Via": "DAV",
            "Allow": ("OPTIONS, PROPFIND, PROPPATCH, GET, HEAD, PUT, MKCOL, "
                      "DELETE, MOVE, COPY, LOCK, UNLOCK")})

    # -- PROPFIND ------------------------------------------------------------
    def _prop_response(self, href: str, entry: fpb.Entry) -> ET.Element:
        resp = ET.Element(_dav("response"))
        ET.SubElement(resp, _dav("href")).text = urllib.parse.quote(href)
        propstat = ET.SubElement(resp, _dav("propstat"))
        prop = ET.SubElement(propstat, _dav("prop"))
        ET.SubElement(prop, _dav("displayname")).text = entry.name.split("/")[-1]
        rtype = ET.SubElement(prop, _dav("resourcetype"))
        mtime = entry.attributes.mtime or int(time.time())
        if entry.is_directory:
            ET.SubElement(rtype, _dav("collection"))
        else:
            size = entry.attributes.file_size
            ET.SubElement(prop, _dav("getcontentlength")).text = str(size)
            ET.SubElement(prop, _dav("getcontenttype")).text = (
                entry.attributes.mime or "application/octet-stream")
        ET.SubElement(prop, _dav("getlastmodified")).text = _http_date(mtime)
        ET.SubElement(propstat, _dav("status")).text = "HTTP/1.1 200 OK"
        return resp

    def _h_propfind(self, request):
        path = self._abs(request.path)
        depth = request.headers.get("Depth", "1")
        entry = self._find(path)
        if entry is None:
            raise FileNotFoundError(path)
        ET.register_namespace("D", DAV_NS)
        ms = ET.Element(_dav("multistatus"))
        href = request.path.rstrip("/") or "/"
        if entry.is_directory and not href.endswith("/"):
            href += "/"
        ms.append(self._prop_response(href, entry))
        if entry.is_directory and depth != "0":
            for child in self.fs.filer.list_entries(path):
                chref = href + child.name.split("/")[-1]
                if child.is_directory:
                    chref += "/"
                ms.append(self._prop_response(chref, child))
        body = (b'<?xml version="1.0" encoding="utf-8"?>'
                + ET.tostring(ms, encoding="utf-8"))
        return _xml(207, body)

    def _h_proppatch(self, request):
        # accept-and-ignore (reference webdav lib does the same for
        # dead properties it doesn't store)
        path = self._abs(request.path)
        if self._find(path) is None:
            raise FileNotFoundError(path)
        ET.register_namespace("D", DAV_NS)
        ms = ET.Element(_dav("multistatus"))
        resp = ET.SubElement(ms, _dav("response"))
        ET.SubElement(resp, _dav("href")).text = request.path
        ps = ET.SubElement(resp, _dav("propstat"))
        ET.SubElement(ps, _dav("status")).text = "HTTP/1.1 200 OK"
        return _xml(207, ET.tostring(ms))

    # -- data ----------------------------------------------------------------
    def _h_get(self, request):
        path = self._abs(request.path)
        entry = self._find(path)
        if entry is None:
            raise FileNotFoundError(path)
        if entry.is_directory:
            names = [e.name.split("/")[-1] + ("/" if e.is_directory else "")
                     for e in self.fs.filer.list_entries(path)]
            return fastweb.json_response({"directory": path,
                                          "entries": names})
        mime = entry.attributes.mime or "application/octet-stream"
        if request.method == "HEAD":
            return fastweb.Response(
                iter(()), status=200, content_type=mime,
                content_length=entry.attributes.file_size,
                headers={"Last-Modified":
                         _http_date(entry.attributes.mtime or 0)})
        data = self.fs.read_entry_bytes(entry)
        return fastweb.Response(data, content_type=mime)

    def _h_put(self, request):
        path = self._abs(request.path)
        data = request.read()
        existed = self._find(path) is not None
        self.fs.write_file(path, data, mime=request.content_type or "")
        return _text(204 if existed else 201)

    def _h_mkcol(self, request):
        path = self._abs(request.path)
        if self._find(path) is not None:
            return _text(405)  # RFC4918: MKCOL on existing
        d, n = split_path(path)
        entry = fpb.Entry(name=n, is_directory=True)
        entry.attributes.file_mode = 0o755 | 0x80000000
        self.fs.filer.create_entry(d, entry)
        return _text(201)

    def _h_delete(self, request):
        path = self._abs(request.path)
        if self._find(path) is None:
            raise FileNotFoundError(path)
        d, n = split_path(path)
        self.fs.filer.delete_entry(d, n, is_recursive=True,
                                   is_delete_data=True)
        return _text(204)

    def _dest_path(self, request) -> str:
        dest = request.headers.get("Destination", "")
        if not dest:
            raise FileExistsError("missing Destination header")
        u = urllib.parse.urlparse(dest)
        # the Destination header is still percent-encoded (unlike
        # request.path)
        return self._abs(urllib.parse.unquote(u.path))

    def _h_move(self, request):
        src = self._abs(request.path)
        dst = self._dest_path(request)
        if src == dst:
            return _text(403)  # RFC 4918 9.9.4
        if self._find(src) is None:
            raise FileNotFoundError(src)
        overwrite = request.headers.get("Overwrite", "T") != "F"
        existed = self._find(dst) is not None
        if existed and not overwrite:
            return _text(412)
        sd, sn = split_path(src)
        dd, dn = split_path(dst)
        if existed:
            self.fs.filer.delete_entry(dd, dn, is_recursive=True,
                                       is_delete_data=True)
        self.fs.filer.rename(sd, sn, dd, dn)
        return _text(204 if existed else 201)

    def _h_copy(self, request):
        src = self._abs(request.path)
        dst = self._dest_path(request)
        entry = self._find(src)
        if entry is None:
            raise FileNotFoundError(src)
        overwrite = request.headers.get("Overwrite", "T") != "F"
        existed = self._find(dst) is not None
        if existed and not overwrite:
            return _text(412)
        if entry.is_directory:
            self._copy_tree(src, dst)
        else:
            data = self.fs.read_entry_bytes(entry)
            self.fs.write_file(dst, data, mime=entry.attributes.mime)
        return _text(204 if existed else 201)

    def _copy_tree(self, src: str, dst: str) -> None:
        dd, dn = split_path(dst)
        if self._find(dst) is None:
            e = fpb.Entry(name=dn, is_directory=True)
            e.attributes.file_mode = 0o755 | 0x80000000
            self.fs.filer.create_entry(dd, e)
        for child in self.fs.filer.list_entries(src):
            name = child.name.split("/")[-1]
            if child.is_directory:
                self._copy_tree(join_path(src, name), join_path(dst, name))
            else:
                data = self.fs.read_entry_bytes(child)
                self.fs.write_file(join_path(dst, name), data,
                                   mime=child.attributes.mime)

    # -- locks (advisory, in-memory like webdav.NewMemLS) --------------------
    def _h_lock(self, request):
        path = self._abs(request.path)
        token = f"opaquelocktoken:{uuid.uuid4()}"
        with self._lock_mu:
            self._locks[path] = token
        ET.register_namespace("D", DAV_NS)
        root = ET.Element(_dav("prop"))
        ld = ET.SubElement(root, _dav("lockdiscovery"))
        al = ET.SubElement(ld, _dav("activelock"))
        lt = ET.SubElement(al, _dav("locktoken"))
        ET.SubElement(lt, _dav("href")).text = token
        ET.SubElement(al, _dav("timeout")).text = "Second-3600"
        return _xml(200, ET.tostring(root),
                    headers={"Lock-Token": f"<{token}>"})

    def _h_unlock(self, request):
        path = self._abs(request.path)
        with self._lock_mu:
            self._locks.pop(path, None)
        return _text(204)
