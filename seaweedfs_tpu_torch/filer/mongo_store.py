"""MongoDB wire-protocol FilerStore.

Reference: weed/filer/mongodb/mongodb_store.go — one collection of
{directory, name, meta} documents, indexed on (directory, name). This
client speaks OP_MSG (MongoDB 3.6+ wire protocol) directly over pooled
per-thread sockets with the hand-rolled BSON codec in utils/bson_lite —
no pymongo in the image. It works against any mongod 4.x+ and against
utils/mini_mongo.MiniMongo, the in-process protocol double that decodes
and verifies every frame for offline dev/test.

Document shape (mirrors mongodb_store.go):
    {_id: "<dir>\\x01<name>", dir: <dir>, name: <name>, meta: <Entry pb>}
KV pairs live in a second collection keyed by the hex of the key.
Listing pages through find/getMore cursors with range filters on `name`
(the store contract's start_from/prefix semantics), sorted ascending.

The port's copy of seaweedfs_tpu/filer/mongo_store.py, unchanged: the
documents and the kv collection are the reference's, so a filer of either
package opens the other's mongo namespace.
"""

from __future__ import annotations

import struct
import threading
from typing import Iterator

from ..pb import filer_pb2 as fpb
from ..utils import bson_lite as bson
from .store import FilerStore

_HDR = struct.Struct("<iiii")
_OP_MSG = 2013
_HIGH = "\U0010FFFF"


class _MongoConn:
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        import socket
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rf = self.sock.makefile("rb")
        self._req = 0

    def command(self, doc: dict) -> dict:
        self._req += 1
        body = struct.pack("<I", 0) + b"\x00" + bson.encode(doc)
        self.sock.sendall(_HDR.pack(_HDR.size + len(body), self._req, 0,
                                    _OP_MSG) + body)
        hdr = self.rf.read(_HDR.size)
        if len(hdr) < _HDR.size:
            raise ConnectionError("mongo connection closed")
        length, _, _, opcode = _HDR.unpack(hdr)
        payload = self.rf.read(length - _HDR.size)
        if opcode != _OP_MSG:
            raise ValueError(f"unexpected opcode {opcode}")
        if payload[4] != 0:
            raise ValueError(f"unexpected section kind {payload[4]}")
        reply, _ = bson.decode(payload, 5)
        if not reply.get("ok"):
            raise RuntimeError(f"mongo error: {reply.get('errmsg')!r} "
                               f"({reply.get('codeName')})")
        return reply

    def close(self):
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


class MongoStore(FilerStore):
    name = "mongo"
    DB = "seaweedfs"
    COLL = "filemeta"  # mongodb_store.go uses the same collection name
    KV_COLL = "kv"

    def __init__(self, address: str):
        self.address = address
        host, _, port = address.rpartition(":")
        if host and port.isdigit():
            self._host, self._port = host, int(port)
        else:
            self._host, self._port = address, 27017
        self._local = threading.local()
        hello = self._cmd({"hello": 1, "$db": "admin"})
        if not hello.get("isWritablePrimary") and \
                not hello.get("ismaster"):
            raise ConnectionError(f"{address} is not a writable primary")

    def _cmd(self, doc: dict) -> dict:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = _MongoConn(self._host, self._port)
        try:
            return conn.command(doc)
        except (ConnectionError, OSError):
            conn.close()
            conn = self._local.conn = _MongoConn(self._host, self._port)
            return conn.command(doc)

    @staticmethod
    def _id(directory: str, name: str) -> str:
        return f"{directory}\x01{name}"

    # -- entries -------------------------------------------------------------
    def insert_entry(self, directory, entry):
        doc = {"_id": self._id(directory, entry.name),
               "dir": directory, "name": entry.name,
               "meta": entry.SerializeToString()}
        self._cmd({"update": self.COLL, "$db": self.DB,
                   "updates": [{"q": {"_id": doc["_id"]}, "u": doc,
                                "upsert": True}]})

    update_entry = insert_entry

    def find_entry(self, directory, name):
        reply = self._cmd({"find": self.COLL, "$db": self.DB,
                           "filter": {"_id": self._id(directory, name)},
                           "limit": 1})
        batch = reply["cursor"]["firstBatch"]
        if not batch:
            return None
        e = fpb.Entry()
        e.ParseFromString(batch[0]["meta"])
        return e

    def delete_entry(self, directory, name):
        self._cmd({"delete": self.COLL, "$db": self.DB,
                   "deletes": [{"q": {"_id": self._id(directory, name)},
                                "limit": 1}]})

    def delete_folder_children(self, directory):
        self._cmd({"delete": self.COLL, "$db": self.DB,
                   "deletes": [{"q": {"dir": directory}, "limit": 0}]})

    def list_entries(self, directory, start_from="", inclusive=False,
                     limit=2**31, prefix="") -> Iterator[fpb.Entry]:
        name_cond: dict = {}
        if prefix and prefix > start_from:
            name_cond["$gte"] = prefix
        elif start_from:
            name_cond["$gte" if inclusive else "$gt"] = start_from
        if prefix:
            name_cond["$lt"] = prefix + _HIGH
        filt: dict = {"dir": directory}
        if name_cond:
            filt["name"] = name_cond
        reply = self._cmd({"find": self.COLL, "$db": self.DB,
                           "filter": filt, "sort": {"name": 1},
                           "limit": min(limit, 2**31 - 1)})
        cur = reply["cursor"]
        yielded = 0
        batch = cur["firstBatch"]
        while True:
            for d in batch:
                if prefix and not d["name"].startswith(prefix):
                    continue
                e = fpb.Entry()
                e.ParseFromString(d["meta"])
                yield e
                yielded += 1
                if yielded >= limit:
                    return
            if not cur["id"]:
                return
            # getMore MUST be int64 on the wire (real mongod rejects
            # an int32 cursor id with TypeMismatch)
            reply = self._cmd({"getMore": bson.Int64(cur["id"]),
                               "$db": self.DB, "collection": self.COLL})
            cur = reply["cursor"]
            batch = cur["nextBatch"]

    # -- kv ------------------------------------------------------------------
    def kv_put(self, key, value):
        kid = bytes(key).hex()
        self._cmd({"update": self.KV_COLL, "$db": self.DB,
                   "updates": [{"q": {"_id": kid},
                                "u": {"_id": kid, "v": bytes(value)},
                                "upsert": True}]})

    def kv_get(self, key):
        reply = self._cmd({"find": self.KV_COLL, "$db": self.DB,
                           "filter": {"_id": bytes(key).hex()},
                           "limit": 1})
        batch = reply["cursor"]["firstBatch"]
        if not batch:
            return None
        # presence, not truthiness: a stored b"" must round-trip as b""
        return bytes(batch[0]["v"] or b"")

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
