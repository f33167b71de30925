"""etcd v3 FilerStore over the real gRPC KV API.

Reference: weed/filer/etcd/etcd_store.go — entries keyed
"<dir>\\x00<name>" under a prefix, listed with prefix Ranges, KV pairs
under "kv:". This client speaks `etcdserverpb.KV` (Range/Put/DeleteRange
with the public field numbers, pb/etcd.proto) through the same generic
Stub machinery the rest of the cluster uses — it dials a real etcd
3.x identically to utils/mini_etcd.MiniEtcd, the in-process double the
conformance suite runs against.

The port's copy of seaweedfs_tpu/filer/etcd_store.py over the port's
`utils/rpc.Stub` and `pb/etcd_pb2`: keys and entries are the reference's,
so a filer of either package opens the other's etcd namespace.
"""

from __future__ import annotations

from typing import Iterator

from ..pb import etcd_pb2 as epb
from ..pb import filer_pb2 as fpb
from ..utils.rpc import Stub
from .store import FilerStore

KV_SERVICE = "etcdserverpb.KV"
# reference DIR_FILE_SEPARATOR = 0x00 (etcd_store.go:23)
_SEP = b"\x00"
_ENTRY_PREFIX = b"swtpu/"
_KV_PREFIX = b"swtpu-kv/"


def _prefix_end(prefix: bytes) -> bytes:
    """etcd's conventional end-of-prefix key (last byte + 1)."""
    out = bytearray(prefix)
    for i in reversed(range(len(out))):
        if out[i] < 0xFF:
            out[i] += 1
            return bytes(out[:i + 1])
    return b"\x00"  # all-0xff prefix: to end of keyspace


class EtcdStore(FilerStore):
    name = "etcd"

    def __init__(self, address: str):
        self.address = address if ":" in address else f"{address}:2379"
        self.stub = Stub(self.address, KV_SERVICE)
        # fail fast on a bad address (a Range on a tiny span)
        self.stub.call("Range", epb.RangeRequest(key=b"\x00", limit=1),
                       epb.RangeResponse, timeout=5)

    @staticmethod
    def _entry_key(directory: str, name: str) -> bytes:
        return _ENTRY_PREFIX + directory.encode() + _SEP + name.encode()

    # -- entries -------------------------------------------------------------
    def insert_entry(self, directory, entry):
        self.stub.call("Put", epb.PutRequest(
            key=self._entry_key(directory, entry.name),
            value=entry.SerializeToString()), epb.PutResponse)

    update_entry = insert_entry

    def find_entry(self, directory, name):
        resp = self.stub.call("Range", epb.RangeRequest(
            key=self._entry_key(directory, name), limit=1),
            epb.RangeResponse)
        if not resp.kvs:
            return None
        e = fpb.Entry()
        e.ParseFromString(resp.kvs[0].value)
        return e

    def delete_entry(self, directory, name):
        self.stub.call("DeleteRange", epb.DeleteRangeRequest(
            key=self._entry_key(directory, name)), epb.DeleteRangeResponse)

    def delete_folder_children(self, directory):
        prefix = _ENTRY_PREFIX + directory.encode() + _SEP
        self.stub.call("DeleteRange", epb.DeleteRangeRequest(
            key=prefix, range_end=_prefix_end(prefix)),
            epb.DeleteRangeResponse)

    def list_entries(self, directory, start_from="", inclusive=False,
                     limit=2**31, prefix="") -> Iterator[fpb.Entry]:
        dirp = _ENTRY_PREFIX + directory.encode() + _SEP
        lo_name = prefix if (prefix and prefix > start_from) else start_from
        lo = dirp + lo_name.encode()
        end = (_prefix_end(dirp + prefix.encode()) if prefix
               else _prefix_end(dirp))
        first_exclusive = bool(start_from) and not inclusive \
            and lo_name == start_from
        yielded = 0
        while yielded < limit:
            # never over-fetch: small listings ask for small pages (the
            # +1 covers the excluded start_from key on the first page)
            page = min(512, limit - yielded + (1 if first_exclusive else 0))
            resp = self.stub.call("Range", epb.RangeRequest(
                key=lo, range_end=end, limit=page,
                sort_order=epb.RangeRequest.ASCEND),
                epb.RangeResponse)
            if not resp.kvs:
                return
            for kv in resp.kvs:
                name = bytes(kv.key)[len(dirp):].decode()
                if first_exclusive and name == start_from:
                    continue
                if prefix and not name.startswith(prefix):
                    continue
                e = fpb.Entry()
                e.ParseFromString(kv.value)
                yield e
                yielded += 1
                if yielded >= limit:
                    return
            if not resp.more:
                return
            first_exclusive = False
            lo = bytes(resp.kvs[-1].key) + b"\x00"  # next key after last

    # -- kv ------------------------------------------------------------------
    def kv_put(self, key, value):
        self.stub.call("Put", epb.PutRequest(key=_KV_PREFIX + bytes(key),
                                             value=bytes(value)),
                       epb.PutResponse)

    def kv_get(self, key):
        resp = self.stub.call("Range", epb.RangeRequest(
            key=_KV_PREFIX + bytes(key), limit=1), epb.RangeResponse)
        return bytes(resp.kvs[0].value) if resp.kvs else None

    def close(self):
        pass
