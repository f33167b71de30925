"""Minimal-but-real FTP server over a FilerClient.

Reference: weed/ftpd/ftp_server.go (81-line unwired skeleton; this
implementation speaks RFC 959 directly instead of adapting a library —
the same stance webdav_server.py takes for WebDAV). One thread per
control connection; passive-mode data sockets bound to an OS-assigned
port (or a configured range). Paths are confined under `root` inside the
filer namespace.

The port's copy of seaweedfs_tpu/ftpd/ftp_server.py, unchanged. It
serves any filer through a FilerClient of the port; on a degraded volume
a RETR reads through the servers' reconstructs.
"""

from __future__ import annotations

import posixpath
import socket
import threading
import time

from ..pb import filer_pb2 as fpb
from ..utils.log import logger

log = logger("ftpd")


class FtpServer:
    def __init__(self, filer_client, ip: str = "127.0.0.1", port: int = 2121,
                 root: str = "/", users: "dict[str, str] | None" = None,
                 passive_ports: "tuple[int, int] | None" = None):
        """`users` maps name->password; None allows anonymous (like the
        reference's AuthUser accepting everyone)."""
        self.fc = filer_client
        self.ip, self.port = ip, port
        self.root = root.rstrip("/") or "/"
        self.users = users
        self.passive_ports = passive_ports
        self._srv: socket.socket | None = None
        self._stop = threading.Event()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> "FtpServer":
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.ip, self.port))
        if not self.port:
            self.port = self._srv.getsockname()[1]
        self._srv.listen(8)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"ftpd-{self.port}").start()
        log.info("ftp gateway %s up (root %s, auth %s)", self.url,
                 self.root, "on" if self.users else "anonymous")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=_Session(self, conn).run, daemon=True,
                             name=f"ftpd-sess-{addr[1]}").start()


class _Session:
    def __init__(self, server: FtpServer, conn: socket.socket):
        self.srv = server
        self.conn = conn
        self.fc = server.fc
        self.cwd = "/"            # virtual path, relative to server.root
        self.user = ""
        self.authed = server.users is None
        self.binary = True
        self._pasv: socket.socket | None = None
        self._rnfr: str | None = None

    # -- plumbing -----------------------------------------------------------
    def send(self, code: int, msg: str) -> None:
        self.conn.sendall(f"{code} {msg}\r\n".encode())

    def _abs(self, arg: str) -> str:
        """Virtual absolute path for an FTP argument (resolves against
        cwd, normalizes .. , confines to '/')."""
        p = arg if arg.startswith("/") else posixpath.join(self.cwd, arg)
        p = posixpath.normpath(p)
        return p if p.startswith("/") else "/"

    def _real(self, vpath: str) -> str:
        """Filer path for a virtual path (jail under server.root)."""
        if self.srv.root == "/":
            return vpath
        return self.srv.root + ("" if vpath == "/" else vpath)

    def _split(self, vpath: str) -> tuple[str, str]:
        real = self._real(vpath)
        d, _, n = real.rpartition("/")
        return d or "/", n

    def _entry(self, vpath: str) -> "fpb.Entry | None":
        if vpath == "/":
            e = fpb.Entry(name="/", is_directory=True)
            return e
        d, n = self._split(vpath)
        return self.fc.filer.find_entry(d, n)

    # -- data channel -------------------------------------------------------
    def _open_pasv(self) -> None:
        if self._pasv is not None:
            try:
                self._pasv.close()
            except OSError:
                pass
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        rng = self.srv.passive_ports
        if rng:
            for p in range(rng[0], rng[1] + 1):
                try:
                    s.bind((self.srv.ip, p))
                    break
                except OSError:
                    continue
            else:
                raise OSError("no free passive port in range")
        else:
            s.bind((self.srv.ip, 0))
        s.listen(1)
        s.settimeout(30)
        self._pasv = s

    def _data_conn(self) -> socket.socket:
        if self._pasv is None:
            raise OSError("no PASV data channel")
        conn, _ = self._pasv.accept()
        return conn

    # -- command loop -------------------------------------------------------
    def run(self) -> None:
        try:
            self.send(220, "swtpu FTP gateway ready")
            buf = b""
            while True:
                while b"\r\n" not in buf:
                    if len(buf) > 8192:
                        # no CRLF in 8 KiB: not an FTP client — drop it
                        # before it grows the buffer without bound
                        self.send(500, "line too long")
                        return
                    chunk = self.conn.recv(4096)
                    if not chunk:
                        return
                    buf += chunk
                line, _, buf = buf.partition(b"\r\n")
                try:
                    text = line.decode("utf-8", "replace").strip()
                except Exception:  # noqa: BLE001
                    continue
                if not text:
                    continue
                cmd, _, arg = text.partition(" ")
                cmd = cmd.upper()
                if cmd == "QUIT":
                    self.send(221, "bye")
                    return
                handler = getattr(self, f"do_{cmd}", None)
                if handler is None:
                    self.send(502, f"{cmd} not implemented")
                    continue
                if not self.authed and cmd not in ("USER", "PASS", "FEAT",
                                                   "SYST", "NOOP"):
                    self.send(530, "please login with USER and PASS")
                    continue
                try:
                    handler(arg)
                except FileNotFoundError:
                    self.send(550, "file not found")
                except Exception as e:  # noqa: BLE001
                    log.warning("ftp %s %r: %s", cmd, arg, e)
                    self.send(451, f"action aborted: {e}")
        finally:
            for s in (self._pasv, self.conn):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass

    # -- auth ---------------------------------------------------------------
    def do_USER(self, arg):
        self.user = arg
        if self.srv.users is None:
            self.authed = True
            self.send(230, "anonymous access granted")
        else:
            self.send(331, "password required")

    def do_PASS(self, arg):
        if self.srv.users is None:
            self.authed = True
            self.send(230, "logged in")
            return
        if self.srv.users.get(self.user) == arg:
            self.authed = True
            self.send(230, "logged in")
        else:
            self.send(530, "login incorrect")

    # -- session state ------------------------------------------------------
    def do_SYST(self, arg):
        self.send(215, "UNIX Type: L8")

    def do_FEAT(self, arg):
        self.conn.sendall(b"211-Features:\r\n SIZE\r\n MDTM\r\n EPSV\r\n"
                          b" UTF8\r\n211 End\r\n")

    def do_NOOP(self, arg):
        self.send(200, "ok")

    def do_TYPE(self, arg):
        self.binary = arg.upper().startswith("I")
        self.send(200, f"type set to {'I' if self.binary else 'A'}")

    def do_PWD(self, arg):
        self.send(257, f'"{self.cwd}" is the current directory')

    def do_CWD(self, arg):
        target = self._abs(arg or "/")
        e = self._entry(target)
        if e is None or not e.is_directory:
            self.send(550, "no such directory")
            return
        self.cwd = target
        self.send(250, "directory changed")

    def do_CDUP(self, arg):
        self.do_CWD("..")

    # -- passive mode -------------------------------------------------------
    def do_PASV(self, arg):
        self._open_pasv()
        # advertise the address the CLIENT reached us on — the bind ip
        # may be 0.0.0.0 or a hostname, neither of which belongs in a 227
        host = self.conn.getsockname()[0].replace(".", ",")
        port = self._pasv.getsockname()[1]
        self.send(227, f"entering passive mode "
                       f"({host},{port >> 8},{port & 0xFF})")

    def do_EPSV(self, arg):
        self._open_pasv()
        self.send(229, f"entering extended passive mode "
                       f"(|||{self._pasv.getsockname()[1]}|)")

    # -- directory listings -------------------------------------------------
    def _list_lines(self, vpath: str, names_only: bool) -> list[str]:
        real = self._real(vpath if vpath != "/" else "/")
        if real == "":
            real = "/"
        out = []
        for e in self.fc.filer.list_entries(real):
            if names_only:
                out.append(e.name)
                continue
            kind = "d" if e.is_directory else "-"
            size = e.attributes.file_size
            mt = time.strftime("%b %d %H:%M",
                               time.localtime(e.attributes.mtime
                                              or time.time()))
            out.append(f"{kind}rwxr-xr-x 1 swtpu swtpu {size:>12d} "
                       f"{mt} {e.name}")
        return out

    def _send_over_data(self, payload: bytes) -> None:
        conn = self._data_conn()
        try:
            conn.sendall(payload)
        finally:
            conn.close()

    def do_LIST(self, arg):
        arg = (arg or "").strip()
        if arg.startswith("-"):  # ignore ls flags some clients send
            arg = ""
        vpath = self._abs(arg) if arg else self.cwd
        self.send(150, "opening data connection for LIST")
        lines = self._list_lines(vpath, names_only=False)
        self._send_over_data(("\r\n".join(lines) + "\r\n").encode()
                             if lines else b"")
        self.send(226, "transfer complete")

    def do_NLST(self, arg):
        vpath = self._abs(arg) if arg else self.cwd
        self.send(150, "opening data connection for NLST")
        lines = self._list_lines(vpath, names_only=True)
        self._send_over_data(("\r\n".join(lines) + "\r\n").encode()
                             if lines else b"")
        self.send(226, "transfer complete")

    # -- file transfer ------------------------------------------------------
    def do_RETR(self, arg):
        vpath = self._abs(arg)
        e = self._entry(vpath)
        if e is None or e.is_directory:
            self.send(550, "not a file")
            return
        self.send(150, "opening data connection")
        conn = self._data_conn()
        try:
            # stream window-by-window: one RETR of a huge file must not
            # materialize it in gateway memory
            for part in self.fc.iter_entry_bytes(e):
                conn.sendall(part)
        finally:
            conn.close()
        self.send(226, "transfer complete")

    def do_STOR(self, arg):
        vpath = self._abs(arg)
        existing = self._entry(vpath)
        if existing is not None and existing.is_directory:
            # silently replacing a directory entry with a file would
            # orphan its children in the store
            self.send(550, "is a directory")
            return
        self.send(150, "ok to send data")
        conn = self._data_conn()

        def blocks():
            while True:
                part = conn.recv(1 << 16)
                if not part:
                    return
                yield part

        try:
            # spool through the chunked write path: at most one filer
            # chunk of the upload is ever buffered in the gateway
            self.fc.write_file_stream(self._real(vpath), blocks())
        finally:
            conn.close()
        self.send(226, "transfer complete")

    def do_DELE(self, arg):
        vpath = self._abs(arg)
        if vpath == "/":
            self.send(550, "refusing to delete the root")
            return
        e = self._entry(vpath)
        if e is None:
            self.send(550, "no such file")
            return
        if e.is_directory:
            # RFC 959: DELE removes FILES only (RMD is the directory verb,
            # and it refuses non-empty dirs); without this check a typo'd
            # DELE would recursively destroy a subtree
            self.send(550, "is a directory; use RMD")
            return
        d, n = self._split(vpath)
        self.fc.filer.delete_entry(d, n)
        self.send(250, "deleted")

    def do_MKD(self, arg):
        vpath = self._abs(arg)
        if self._entry(vpath) is not None:
            self.send(550, "already exists")
            return
        d, n = self._split(vpath)
        e = fpb.Entry(name=n, is_directory=True)
        e.attributes.file_mode = 0o40755
        self.fc.filer.create_entry(d, e)
        self.send(257, f'"{vpath}" created')

    def do_RMD(self, arg):
        vpath = self._abs(arg)
        if vpath == "/":
            self.send(550, "refusing to remove the root")
            return
        d, n = self._split(vpath)
        entry = self.fc.filer.find_entry(d, n)
        if entry is None or not entry.is_directory:
            self.send(550, "no such directory")
            return
        self.fc.filer.delete_entry(d, n, is_recursive=False)
        self.send(250, "removed")

    def do_RNFR(self, arg):
        vpath = self._abs(arg)
        if vpath == "/":
            self.send(550, "refusing to rename the root")
            return
        if self._entry(vpath) is None:
            self.send(550, "no such file")
            return
        self._rnfr = vpath
        self.send(350, "ready for RNTO")

    def do_RNTO(self, arg):
        if self._rnfr is None:
            self.send(503, "RNFR first")
            return
        if self._abs(arg) == "/":
            self.send(553, "bad target")
            return
        od, on = self._split(self._rnfr)
        nd, nn = self._split(self._abs(arg))
        self.fc.filer.rename(od, on, nd, nn)
        self._rnfr = None
        self.send(250, "renamed")

    def do_SIZE(self, arg):
        e = self._entry(self._abs(arg))
        if e is None or e.is_directory:
            self.send(550, "not a file")
            return
        self.send(213, str(e.attributes.file_size))

    def do_MDTM(self, arg):
        e = self._entry(self._abs(arg))
        if e is None:
            self.send(550, "not found")
            return
        self.send(213, time.strftime("%Y%m%d%H%M%S",
                                     time.gmtime(e.attributes.mtime or 0)))
