"""In-process mini redis: a RESP2 server over TCP for dev/test clusters.

Speaks the real wire protocol (arrays of bulk strings in, RESP replies
out) with the command subset the redis filer store uses — GET/SET/DEL/
EXISTS/ZADD/ZREM/ZCARD/ZRANGEBYLEX/FLUSHALL/PING. The redis-protocol
FilerStore (filer/redis_store.py) is tested against this server, the way
the reference tests its redis2 store against a redis it can reach; point
the store at a real redis and the same bytes flow.

The port's copy of seaweedfs_tpu/utils/mini_redis.py, unchanged: a
reference RedisStore and a port RedisStore share one server.
"""

from __future__ import annotations

import socket
import threading
from bisect import bisect_left, insort


class MiniRedis:
    def __init__(self, ip: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((ip, port))
        self._srv.listen(64)
        self.ip, self.port = self._srv.getsockname()
        self._kv: dict[bytes, bytes] = {}
        self._zsets: dict[bytes, list[bytes]] = {}  # sorted member lists
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="mini-redis")

    def start(self) -> "MiniRedis":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    # -- wire ---------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        rf = conn.makefile("rb")
        try:
            while not self._stop.is_set():
                args = self._read_command(rf)
                if args is None:
                    return
                try:
                    reply = self._dispatch(args)
                except Exception as e:  # noqa: BLE001
                    reply = b"-ERR " + str(e).encode()[:100] + b"\r\n"
                conn.sendall(reply)
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _read_command(rf) -> "list[bytes] | None":
        line = rf.readline()
        if not line:
            return None
        if not line.startswith(b"*"):
            raise ValueError(f"expected array, got {line[:20]!r}")
        n = int(line[1:])
        args = []
        for _ in range(n):
            hdr = rf.readline()
            if not hdr.startswith(b"$"):
                raise ValueError("expected bulk string")
            ln = int(hdr[1:])
            data = rf.read(ln + 2)[:-2]
            args.append(data)
        return args

    # -- replies ------------------------------------------------------------
    @staticmethod
    def _bulk(v: "bytes | None") -> bytes:
        if v is None:
            return b"$-1\r\n"
        return b"$" + str(len(v)).encode() + b"\r\n" + v + b"\r\n"

    @staticmethod
    def _int(n: int) -> bytes:
        return b":" + str(n).encode() + b"\r\n"

    @staticmethod
    def _array(items: "list[bytes]") -> bytes:
        out = b"*" + str(len(items)).encode() + b"\r\n"
        for it in items:
            out += MiniRedis._bulk(it)
        return out

    # -- commands -----------------------------------------------------------
    def _dispatch(self, args: "list[bytes]") -> bytes:
        cmd = args[0].upper()
        with self._lock:
            if cmd == b"PING":
                return b"+PONG\r\n"
            if cmd == b"SET":
                self._kv[args[1]] = args[2]
                return b"+OK\r\n"
            if cmd == b"GET":
                return self._bulk(self._kv.get(args[1]))
            if cmd == b"DEL":
                n = 0
                for k in args[1:]:
                    n += self._kv.pop(k, None) is not None
                    n += self._zsets.pop(k, None) is not None
                return self._int(n)
            if cmd == b"EXISTS":
                return self._int(sum(1 for k in args[1:]
                                     if k in self._kv or k in self._zsets))
            if cmd == b"ZADD":
                z = self._zsets.setdefault(args[1], [])
                added = 0
                # pairs of (score, member); scores ignored (lex ordering)
                for member in args[3::2]:
                    i = bisect_left(z, member)
                    if i >= len(z) or z[i] != member:
                        insort(z, member)
                        added += 1
                return self._int(added)
            if cmd == b"ZREM":
                z = self._zsets.get(args[1], [])
                removed = 0
                for member in args[2:]:
                    i = bisect_left(z, member)
                    if i < len(z) and z[i] == member:
                        z.pop(i)
                        removed += 1
                return self._int(removed)
            if cmd == b"ZCARD":
                return self._int(len(self._zsets.get(args[1], [])))
            if cmd == b"ZRANGEBYLEX":
                z = self._zsets.get(args[1], [])
                lo, hi = args[2], args[3]
                start = 0
                end = len(z)
                if lo == b"-":
                    start = 0
                elif lo.startswith(b"["):
                    start = bisect_left(z, lo[1:])
                elif lo.startswith(b"("):
                    i = bisect_left(z, lo[1:])
                    start = i + 1 if i < len(z) and z[i] == lo[1:] else i
                if hi == b"+":
                    end = len(z)
                elif hi.startswith(b"["):
                    i = bisect_left(z, hi[1:])
                    end = i + 1 if i < len(z) and z[i] == hi[1:] else i
                elif hi.startswith(b"("):
                    end = bisect_left(z, hi[1:])
                sel = z[start:end]
                if len(args) >= 7 and args[4].upper() == b"LIMIT":
                    off, cnt = int(args[5]), int(args[6])
                    sel = sel[off:] if cnt < 0 else sel[off:off + cnt]
                return self._array(sel)
            if cmd == b"FLUSHALL":
                self._kv.clear()
                self._zsets.clear()
                return b"+OK\r\n"
        raise ValueError(f"unknown command {cmd.decode(errors='replace')}")
