"""Redis-protocol FilerStore.

Reference: weed/filer/redis2/redis_store.go — entries as plain keys
("<dir>/<name>" -> serialized Entry), per-directory member lists as a
sorted set keyed "<dir>\\x00members" scanned with ZRANGEBYLEX, KV pairs
under a "kv:" prefix. This client speaks RESP2 directly over a pooled
per-thread socket (no redis-py in the image); it works against any redis
2.8+ — including utils/mini_redis.MiniRedis for offline dev/test.

The port's copy of seaweedfs_tpu/filer/redis_store.py, unchanged: the
key layout and the encoded entries are the reference's, so a filer of
either package opens the other's redis namespace, kv pairs included.
"""

from __future__ import annotations

import socket
import threading
from typing import Iterator

from ..pb import filer_pb2 as fpb
from .store import FilerStore

_MEMBERS_SUFFIX = b"\x00members"


class _RespConn:
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rf = self.sock.makefile("rb")

    def command(self, *args: bytes):
        out = [b"*", str(len(args)).encode(), b"\r\n"]
        for a in args:
            out += [b"$", str(len(a)).encode(), b"\r\n", a, b"\r\n"]
        self.sock.sendall(b"".join(out))
        return self._read_reply()

    def _read_reply(self):
        line = self.rf.readline()
        if not line:
            raise ConnectionError("redis connection closed")
        t, body = line[:1], line[1:-2]
        if t == b"+":
            return body
        if t == b"-":
            raise RuntimeError(f"redis error: {body.decode(errors='replace')}")
        if t == b":":
            return int(body)
        if t == b"$":
            n = int(body)
            if n < 0:
                return None
            data = self.rf.read(n + 2)[:-2]
            return data
        if t == b"*":
            return [self._read_reply() for _ in range(int(body))]
        raise ValueError(f"bad RESP type {t!r}")

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


class RedisStore(FilerStore):
    name = "redis"

    def __init__(self, address: str):
        self.address = address
        host, _, port = address.rpartition(":")
        if host and port.isdigit():
            self._host, self._port = host, int(port)
        else:  # bare hostname (no port): default redis port
            self._host, self._port = address, 6379
        self._local = threading.local()
        self._cmd(b"PING")  # fail fast on a bad address

    def _cmd(self, *args: bytes):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = _RespConn(self._host, self._port)
        try:
            return conn.command(*args)
        except (ConnectionError, OSError):
            # one transparent reconnect (server restarted)
            conn.close()
            conn = self._local.conn = _RespConn(self._host, self._port)
            return conn.command(*args)

    @staticmethod
    def _entry_key(directory: str, name: str) -> bytes:
        return f"{directory}\x01{name}".encode()

    @staticmethod
    def _members_key(directory: str) -> bytes:
        return directory.encode() + _MEMBERS_SUFFIX

    def insert_entry(self, directory, entry):
        self._cmd(b"SET", self._entry_key(directory, entry.name),
                  entry.SerializeToString())
        self._cmd(b"ZADD", self._members_key(directory), b"0",
                  entry.name.encode())

    update_entry = insert_entry

    def find_entry(self, directory, name):
        blob = self._cmd(b"GET", self._entry_key(directory, name))
        if blob is None:
            return None
        e = fpb.Entry()
        e.ParseFromString(blob)
        return e

    def delete_entry(self, directory, name):
        self._cmd(b"DEL", self._entry_key(directory, name))
        self._cmd(b"ZREM", self._members_key(directory), name.encode())

    def delete_folder_children(self, directory):
        members = self._cmd(b"ZRANGEBYLEX", self._members_key(directory),
                            b"-", b"+")
        if members:
            self._cmd(b"DEL", *[self._entry_key(directory,
                                                m.decode()) for m in members])
        self._cmd(b"DEL", self._members_key(directory))

    def list_entries(self, directory, start_from="", inclusive=False,
                     limit=2**31, prefix="") -> Iterator[fpb.Entry]:
        lo = b"-" if not start_from else \
            (b"[" if inclusive else b"(") + start_from.encode()
        if prefix and prefix > start_from:
            # seek straight to the prefix region instead of paging the
            # whole directory from the start
            lo = b"[" + prefix.encode()
        n = 0
        batch = 1024
        while n < limit:
            members = self._cmd(b"ZRANGEBYLEX", self._members_key(directory),
                                lo, b"+", b"LIMIT", b"0",
                                str(batch).encode())
            if not members:
                return
            for m in members:
                name = m.decode()
                if prefix:
                    if name.startswith(prefix):
                        pass
                    elif name[:len(prefix)] > prefix:
                        return  # lex-sorted: nothing later can match
                    else:
                        continue
                e = self.find_entry(directory, name)
                if e is not None:
                    n += 1
                    yield e
                    if n >= limit:
                        return
            lo = b"(" + members[-1]

    def kv_get(self, key):
        return self._cmd(b"GET", b"kv:" + key)

    def kv_put(self, key, value):
        self._cmd(b"SET", b"kv:" + key, value)

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
