"""In-process MongoDB protocol double: a real OP_MSG server.

Like mini_redis / mini_kafka / mini_azure: not a mock — it decodes every
wire frame (header, flagBits, kind-0 section, BSON body per
utils/bson_lite), validates the shapes the driver contract requires, and
executes commands against in-memory collections. filer/mongo_store.py is
developed and conformance-tested against THIS, and speaks the identical
bytes to a real mongod.

Supported commands: hello/isMaster, ping, insert, update (upsert),
find (equality + $gt/$gte/$lt/$lte on scalar fields, single-field sort,
limit, batchSize), getMore (cursored find batches), delete (limit 0/1),
drop, listCollections (empty). Unknown commands answer ok:0 with a
CommandNotFound error like the real server.

The port's copy of seaweedfs_tpu/utils/mini_mongo.py, unchanged (its
logger is the port's): a reference MongoStore and a port MongoStore share
one server, getMore paging included.
"""

from __future__ import annotations

import socket
import struct
import threading

from . import bson_lite as bson
from .log import logger

log = logger("mini-mongo")

_HDR = struct.Struct("<iiii")  # messageLength, requestID, responseTo, opCode
OP_MSG = 2013


class MiniMongo:
    def __init__(self, ip: str = "127.0.0.1", port: int = 0,
                 batch_size: int = 101):
        self.ip, self.port = ip, port
        self.batch_size = batch_size  # real mongod first-batch default
        # db.collection -> {_id: doc}
        self.collections: dict[str, dict] = {}
        self._cursors: dict[int, list] = {}
        self._next_cursor = 1000
        self._lock = threading.Lock()
        self._srv: socket.socket | None = None
        self._stop = threading.Event()
        self.frames = 0  # decoded OP_MSG frames (test introspection)

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> "MiniMongo":
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.ip, self.port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen(16)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="mini-mongo").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._srv:
            try:
                self._srv.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="mini-mongo-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        rf = conn.makefile("rb")
        try:
            while not self._stop.is_set():
                hdr = rf.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return
                length, req_id, _resp_to, opcode = _HDR.unpack(hdr)
                body = rf.read(length - _HDR.size)
                if opcode != OP_MSG:
                    raise ValueError(f"unsupported opcode {opcode}")
                (flags,) = struct.unpack_from("<I", body, 0)
                if flags & ~0x2:  # only checksumPresent=0, moreToCome ok
                    raise ValueError(f"unsupported flagBits 0x{flags:x}")
                if body[4] != 0:
                    raise ValueError(f"unsupported section kind {body[4]}")
                doc, _ = bson.decode(body, 5)
                self.frames += 1
                reply = self._dispatch(doc)
                out = bson.encode(reply)
                payload = struct.pack("<I", 0) + b"\x00" + out
                conn.sendall(_HDR.pack(_HDR.size + len(payload),
                                       req_id + 1, req_id, OP_MSG) + payload)
        except (ConnectionError, OSError, ValueError) as e:
            if not self._stop.is_set():
                log.info("mini-mongo conn: %s", e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- command dispatch ----------------------------------------------------
    def _dispatch(self, doc: dict) -> dict:
        cmd = next(iter(doc))
        db = doc.get("$db", "test")
        handler = getattr(self, f"_cmd_{cmd.lower()}", None)
        if handler is None:
            return {"ok": 0.0, "errmsg": f"no such command: '{cmd}'",
                    "code": 59, "codeName": "CommandNotFound"}
        return handler(db, doc)

    def _coll(self, db: str, name: str) -> dict:
        return self.collections.setdefault(f"{db}.{name}", {})

    def _cmd_hello(self, db, doc):
        return {"ok": 1.0, "isWritablePrimary": True,
                "maxWireVersion": 17, "minWireVersion": 0,
                "maxBsonObjectSize": 16 * 1024 * 1024}

    _cmd_ismaster = _cmd_hello

    def _cmd_ping(self, db, doc):
        return {"ok": 1.0}

    def _cmd_insert(self, db, doc):
        coll = self._coll(db, doc["insert"])
        n = 0
        with self._lock:
            for d in doc.get("documents", []):
                if "_id" not in d:
                    return {"ok": 0.0, "errmsg": "document missing _id"}
                coll[d["_id"]] = d
                n += 1
        return {"ok": 1.0, "n": n}

    def _cmd_update(self, db, doc):
        coll = self._coll(db, doc["update"])
        n = upserted = 0
        with self._lock:
            for u in doc.get("updates", []):
                q, repl = u["q"], u["u"]
                if any(k.startswith("$") for k in repl):
                    return {"ok": 0.0,
                            "errmsg": "update operators not supported"}
                matched = [k for k, d in coll.items()
                           if self._matches(d, q)]
                if matched:
                    for k in matched:
                        repl.setdefault("_id", k)
                        coll[k] = repl
                        n += 1
                elif u.get("upsert"):
                    key = repl.get("_id", q.get("_id"))
                    if key is None:
                        return {"ok": 0.0, "errmsg": "upsert without _id"}
                    repl.setdefault("_id", key)
                    coll[key] = repl
                    upserted += 1
        return {"ok": 1.0, "n": n + upserted, "nModified": n}

    def _cmd_delete(self, db, doc):
        coll = self._coll(db, doc["delete"])
        n = 0
        with self._lock:
            for d in doc.get("deletes", []):
                q, limit = d["q"], d.get("limit", 0)
                matched = [k for k, dd in coll.items()
                           if self._matches(dd, q)]
                if limit == 1:
                    matched = matched[:1]
                for k in matched:
                    del coll[k]
                    n += 1
        return {"ok": 1.0, "n": n}

    def _cmd_find(self, db, doc):
        coll = self._coll(db, doc["find"])
        with self._lock:
            rows = [d for d in coll.values()
                    if self._matches(d, doc.get("filter", {}))]
        sort = doc.get("sort") or {}
        for field, direction in reversed(list(sort.items())):
            rows.sort(key=lambda d: d.get(field),
                      reverse=direction < 0)
        limit = doc.get("limit", 0)
        if limit:
            rows = rows[:limit]
        batch = doc.get("batchSize", self.batch_size)
        first, rest = rows[:batch], rows[batch:]
        cursor_id = 0
        if rest:
            with self._lock:
                cursor_id = self._next_cursor
                self._next_cursor += 1
                self._cursors[cursor_id] = rest
        ns = f"{db}.{doc['find']}"
        return {"ok": 1.0, "cursor": {"id": cursor_id if rest else 0,
                                      "ns": ns, "firstBatch": first}}

    def _cmd_getmore(self, db, doc):
        cid = doc["getMore"]
        with self._lock:
            rest = self._cursors.pop(cid, [])
        batch = doc.get("batchSize", self.batch_size)
        out, rest = rest[:batch], rest[batch:]
        if rest:
            with self._lock:
                self._cursors[cid] = rest
        return {"ok": 1.0,
                "cursor": {"id": cid if rest else 0,
                           "ns": f"{db}.{doc.get('collection', '')}",
                           "nextBatch": out}}

    def _cmd_drop(self, db, doc):
        with self._lock:
            self.collections.pop(f"{db}.{doc['drop']}", None)
        return {"ok": 1.0}

    def _cmd_listcollections(self, db, doc):
        return {"ok": 1.0, "cursor": {"id": 0, "ns": f"{db}.$cmd",
                                      "firstBatch": []}}

    @staticmethod
    def _matches(d: dict, q: dict) -> bool:
        for field, cond in q.items():
            have = d.get(field)
            if isinstance(cond, dict):
                for op, val in cond.items():
                    if have is None:
                        return False
                    if op == "$gt" and not have > val:
                        return False
                    elif op == "$gte" and not have >= val:
                        return False
                    elif op == "$lt" and not have < val:
                        return False
                    elif op == "$lte" and not have <= val:
                        return False
                    elif op not in ("$gt", "$gte", "$lt", "$lte"):
                        raise ValueError(f"unsupported operator {op}")
            elif have != cond:
                return False
        return True
