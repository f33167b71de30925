"""In-process etcd v3 protocol double: the real gRPC KV service surface.

Like mini_redis / mini_mongo: a working server, not a mock — it serves
`etcdserverpb.KV` (Range/Put/DeleteRange, real grpc over real protobuf
messages whose field numbers match the public etcd api) against a sorted
in-memory keyspace with mod/create revisions. filer/etcd_store.py is
developed and conformance-tested against THIS and dials a real etcd
identically.

The port's copy of seaweedfs_tpu/utils/mini_etcd.py over the port's
`utils/rpc` and `pb/etcd_pb2` (byte-equal descriptors): a reference
EtcdStore and a port EtcdStore share one server.
"""

from __future__ import annotations

import bisect
import threading

from ..pb import etcd_pb2 as epb
from .rpc import RpcService, serve

KV_SERVICE = "etcdserverpb.KV"


class MiniEtcd:
    def __init__(self, ip: str = "127.0.0.1", port: int = 0):
        self.ip, self.port = ip, port
        self._keys: list[bytes] = []  # sorted
        self._data: dict[bytes, epb.KeyValue] = {}
        self._rev = 1
        self._lock = threading.Lock()
        self._grpc = None
        self.requests = 0  # served RPCs (test introspection)

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> "MiniEtcd":
        svc = RpcService(KV_SERVICE)
        store = self

        def header() -> epb.ResponseHeader:
            return epb.ResponseHeader(cluster_id=1, member_id=1,
                                      revision=store._rev, raft_term=1)

        def span(key: bytes, range_end: bytes) -> "tuple[int, int]":
            """[lo, hi) indexes into the sorted key list for a request."""
            lo = bisect.bisect_left(store._keys, key)
            if not range_end:
                hi = lo + 1 if (lo < len(store._keys)
                                and store._keys[lo] == key) else lo
            elif range_end == b"\x00":  # from key to end of keyspace
                hi = len(store._keys)
            else:
                hi = bisect.bisect_left(store._keys, range_end)
            return lo, hi

        @svc.unary("Range", epb.RangeRequest, epb.RangeResponse)
        def range_(req, ctx):
            store.requests += 1
            with store._lock:
                lo, hi = span(bytes(req.key), bytes(req.range_end))
                kvs = [store._data[k] for k in store._keys[lo:hi]]
                if req.sort_order == epb.RangeRequest.DESCEND:
                    kvs = kvs[::-1]
                count = len(kvs)
                more = bool(req.limit) and count > req.limit
                if req.limit:
                    kvs = kvs[:req.limit]
                resp = epb.RangeResponse(header=header(), more=more,
                                         count=count)
                if not req.count_only:
                    for kv in kvs:
                        out = resp.kvs.add()
                        out.CopyFrom(kv)
                        if req.keys_only:
                            out.value = b""
                return resp

        @svc.unary("Put", epb.PutRequest, epb.PutResponse)
        def put(req, ctx):
            store.requests += 1
            key = bytes(req.key)
            with store._lock:
                store._rev += 1
                prev = store._data.get(key)
                kv = epb.KeyValue(key=key, value=bytes(req.value),
                                  mod_revision=store._rev,
                                  create_revision=(prev.create_revision
                                                   if prev else store._rev),
                                  version=(prev.version + 1 if prev else 1))
                if prev is None:
                    bisect.insort(store._keys, key)
                store._data[key] = kv
                resp = epb.PutResponse(header=header())
                if req.prev_kv and prev is not None:
                    resp.prev_kv.CopyFrom(prev)
                return resp

        @svc.unary("DeleteRange", epb.DeleteRangeRequest,
                   epb.DeleteRangeResponse)
        def delete_range(req, ctx):
            store.requests += 1
            with store._lock:
                lo, hi = span(bytes(req.key), bytes(req.range_end))
                doomed = store._keys[lo:hi]
                resp = epb.DeleteRangeResponse(header=header(),
                                               deleted=len(doomed))
                if doomed:
                    store._rev += 1
                for k in doomed:
                    if req.prev_kv:
                        resp.prev_kvs.add().CopyFrom(store._data[k])
                    del store._data[k]
                del store._keys[lo:hi]
                return resp

        if self.port == 0:
            # serve() refuses port 0 (grpc wraps overflows silently);
            # allocate a free port explicitly
            import socket
            with socket.socket() as s:
                s.bind((self.ip, 0))
                self.port = s.getsockname()[1]
        self._grpc = serve(f"{self.ip}:{self.port}", [svc])
        return self

    def stop(self) -> None:
        if self._grpc:
            self._grpc.stop(grace=0.2)

    def clear(self) -> None:
        with self._lock:
            self._keys.clear()
            self._data.clear()
