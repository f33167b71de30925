"""The port's redis, mongo and etcd filer stores and their local stand-ins
(seaweedfs_tpu_torch/filer/{redis,mongo,etcd}_store.py,
utils/mini_{redis,mongo,etcd}.py, utils/bson_lite.py, pb/etcd_pb2.py)
against the JAX package's.

The reference's store cases (tests/test_filer_stores.py,
TestFilerStoreConformance) run unchanged against this module's `store`
fixture, which opens the port's stores on the port's mini servers (the
mongo server pages every cursor at 7 documents, so listings go through
getMore, as the reference's fixture forces); its persistence case is
replaced by one that reopens the namespace with a client of each package.
Across packages: a reference store and a port store on one mini server of
either package read what the other wrote, entries and kv alike, and the
servers speak the same wire (BSON bytes, etcd descriptors). `open_store`
takes the reference's specs.
"""

import subprocess
import sys

import pytest

import torch_cluster as tc
from test_filer_stores import TestFilerStoreConformance as _RefStoreCases
from test_filer_stores import _entry

from seaweedfs_tpu.filer import store as ref_store
from seaweedfs_tpu.pb import filer_pb2 as ref_fpb
from seaweedfs_tpu_torch.filer import store as port_store
from seaweedfs_tpu_torch.pb import filer_pb2 as port_fpb

KINDS = ("redis", "mongo", "etcd")
PKGS = ("seaweedfs_tpu", "seaweedfs_tpu_torch")


def _mini(pkg: str, kind: str):
    """A stand-in on a port below the ephemeral range."""
    mod = __import__(f"{pkg}.utils.mini_{kind}", fromlist=["x"])
    cls = getattr(mod, {"redis": "MiniRedis", "mongo": "MiniMongo",
                        "etcd": "MiniEtcd"}[kind])
    kw = {"batch_size": 7} if kind == "mongo" else {}
    return cls(port=tc.free_port_pair(), **kw).start()


def _store_cls(pkg: str, kind: str):
    mod = __import__(f"{pkg}.filer.{kind}_store", fromlist=["x"])
    return getattr(mod, {"redis": "RedisStore", "mongo": "MongoStore",
                         "etcd": "EtcdStore"}[kind])


@pytest.fixture(scope="module")
def servers():
    """One mini server of each kind from each package."""
    out = {(pkg, kind): _mini(pkg, kind) for pkg in PKGS for kind in KINDS}
    yield out
    for srv in out.values():
        srv.stop()


def _clear(srv, kind: str, store) -> None:
    if kind == "redis":
        store._cmd(b"FLUSHALL")
    elif kind == "mongo":
        srv.collections.clear()
    else:
        srv.clear()


@pytest.fixture(params=KINDS)
def store(request, servers):
    kind = request.param
    srv = servers[("seaweedfs_tpu_torch", kind)]
    s = _store_cls("seaweedfs_tpu_torch", kind)(srv.address)
    _clear(srv, kind, s)
    yield s
    s.close()


class TestPortStoreCases(_RefStoreCases):
    """The reference's store cases on the port's stores and servers."""

    def test_persistence_across_reopen(self, store, tmp_path):
        store.insert_entry("/persist", _entry("keep", 7))
        store.kv_put(b"pk", b"pv")
        store.close()
        for pkg in PKGS:
            re = _store_cls(pkg, store.name)(store.address)
            try:
                assert re.find_entry("/persist", "keep").attributes \
                    .file_size == 7
                assert re.kv_get(b"pk") == b"pv"
            finally:
                re.close()


def _rich_entry(fpb, name: str, size: int):
    e = fpb.Entry(name=name)
    e.attributes.file_size = size
    e.attributes.mime = "text/plain"
    e.chunks.add(file_id=f"3,{size:x}01", offset=0, size=size)
    e.extended["k"] = name.encode()
    return e


@pytest.mark.parametrize("server_pkg", PKGS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer,reader", [(PKGS[0], PKGS[1]),
                                           (PKGS[1], PKGS[0])])
def test_a_store_reads_what_the_other_package_wrote(servers, kind, writer,
                                                    reader, server_pkg):
    """Entries (with chunks and extended attributes), listings with
    start/prefix/limit, deletes, folder deletes and kv written by one
    package's store read back byte-equal through the other's, on a server
    of either package."""
    srv = servers[(server_pkg, kind)]
    w = _store_cls(writer, kind)(srv.address)
    _clear(srv, kind, w)
    r = _store_cls(reader, kind)(srv.address)
    wf = ref_fpb if writer == PKGS[0] else port_fpb
    try:
        names = [f"f{i:03d}" for i in range(23)] + ["g.1", "g.2", "sp ace"]
        for i, n in enumerate(names):
            w.insert_entry("/x/y", _rich_entry(wf, n, i + 1))
        w.insert_entry("/x/z", _rich_entry(wf, "other", 5))
        w.delete_entry("/x/y", "f004")
        w.kv_put(b"sync.offset.7", b"\x01\x02\x03\x04\x05\x06\x07\x08")
        w.kv_put(b"empty", b"")
        want = [n for n in names if n != "f004"]
        for n in want:
            got = r.find_entry("/x/y", n)
            src = w.find_entry("/x/y", n)
            assert got.SerializeToString() == src.SerializeToString()
        assert r.find_entry("/x/y", "f004") is None
        assert [e.name for e in r.list_entries("/x/y")] == sorted(want)
        assert [e.name for e in r.list_entries("/x/y", start_from="f010",
                                               limit=5)] == \
            [f"f{i:03d}" for i in range(11, 16)]
        assert [e.name for e in r.list_entries("/x/y", prefix="g.")] == \
            ["g.1", "g.2"]
        assert r.kv_get(b"sync.offset.7") == \
            b"\x01\x02\x03\x04\x05\x06\x07\x08"
        assert r.kv_get(b"empty") == b"" and r.kv_get(b"none") is None
        r.delete_folder_children("/x/y")
        assert list(w.list_entries("/x/y")) == []
        assert w.find_entry("/x/z", "other").attributes.file_size == 5
    finally:
        w.close()
        r.close()


def test_bson_codec_bytes_equal():
    """The port's BSON encoder emits the reference's bytes, and each
    decodes the other's, every element type the stores use."""
    from seaweedfs_tpu.utils import bson_lite as ref_bson
    from seaweedfs_tpu_torch.utils import bson_lite as port_bson
    doc = {"find": "filemeta", "$db": "seaweedfs", "n": 7, "big": 1 << 40,
           "f": 2.5, "ok": True, "no": None, "b": b"\x00\xff",
           "i64": port_bson.Int64(3), "sub": {"name": {"$gte": "a"}},
           "arr": [1, "x", {"y": False}]}
    ref_doc = dict(doc, i64=ref_bson.Int64(3))
    enc = port_bson.encode(doc)
    assert enc == ref_bson.encode(ref_doc)
    assert port_bson.decode(enc)[0] == ref_bson.decode(enc)[0]


def test_etcd_descriptors_equal():
    from seaweedfs_tpu.pb import etcd_pb2 as ref_epb
    from seaweedfs_tpu_torch.pb import etcd_pb2 as port_epb
    assert port_epb.DESCRIPTOR.serialized_pb == \
        ref_epb.DESCRIPTOR.serialized_pb
    req = port_epb.RangeRequest(key=b"a", range_end=b"b", limit=3,
                                sort_order=port_epb.RangeRequest.ASCEND)
    assert ref_epb.RangeRequest.FromString(req.SerializeToString()) == \
        ref_epb.RangeRequest(key=b"a", range_end=b"b", limit=3,
                             sort_order=ref_epb.RangeRequest.ASCEND)


def test_mongo_listing_pages_through_get_more(servers):
    """A listing past the server's 7-document batch goes through getMore
    frames on the port's server, as the reference's does on its own."""
    counts = {}
    for pkg in PKGS:
        srv = servers[(pkg, "mongo")]
        s = _store_cls(pkg, "mongo")(srv.address)
        srv.collections.clear()
        for i in range(30):
            s.insert_entry("/page", _entry(f"e{i:02d}", i))
        before = srv.frames
        assert [e.name for e in s.list_entries("/page")] == \
            [f"e{i:02d}" for i in range(30)]
        counts[pkg] = srv.frames - before
        s.close()
    assert counts[PKGS[0]] == counts[PKGS[1]] >= 5  # find + 4 getMores


def test_etcd_range_paging_equal(servers):
    """Listings page through bounded Ranges in both packages alike."""
    counts = {}
    for pkg in PKGS:
        srv = servers[(pkg, "etcd")]
        srv.clear()
        s = _store_cls(pkg, "etcd")(srv.address)
        for i in range(1100):
            s.insert_entry("/page", _entry(f"e{i:05d}", i))
        before = srv.requests
        assert [e.name for e in s.list_entries("/page")] == \
            [f"e{i:05d}" for i in range(1100)]
        counts[pkg] = srv.requests - before
        s.close()
    assert counts[PKGS[0]] == counts[PKGS[1]] >= 3


@pytest.mark.parametrize("kind", KINDS)
def test_open_store_specs_equal_reference(servers, kind):
    """open_store takes the reference's specs (with and without a leading
    '/', `mongodb:` too) to each package's own store class."""
    addr = servers[("seaweedfs_tpu_torch", kind)].address
    specs = [f"{kind}:{addr}", f"{kind}:/{addr}"]
    if kind == "mongo":
        specs.append(f"mongodb:{addr}")
    for spec in specs:
        got = port_store.open_store(spec)
        want = ref_store.open_store(spec)
        try:
            assert (got.name, got.address) == (want.name, want.address)
            assert type(got) is _store_cls("seaweedfs_tpu_torch", kind)
        finally:
            got.close()
            want.close()
    with pytest.raises(ValueError) as e:
        port_store.open_store("cassandra:nope")
    assert "redis:<host:port>" in str(e.value)


def test_filer_on_each_store(servers, tmp_path):
    """A whole port Filer rides each network store, and a reference Filer
    on the same namespace sees its tree."""
    from seaweedfs_tpu.filer.filer import Filer as RefFiler
    from seaweedfs_tpu_torch.filer.filer import Filer
    for kind in KINDS:
        srv = servers[("seaweedfs_tpu_torch", kind)]
        spec = f"{kind}:{srv.address}"
        f = Filer(port_store.open_store(spec), str(tmp_path / f"{kind}.log"))
        _clear(srv, kind, f.store)
        f.create_entry("/d/e", _entry("hello.txt", 5))
        rf = RefFiler(ref_store.open_store(spec),
                      str(tmp_path / f"{kind}-ref.log"))
        assert rf.find_entry("/d/e", "hello.txt").attributes.file_size == 5
        assert [x.name for x in rf.store.list_entries("/d")] == ["e"]
        f.delete_entry("/d/e", "hello.txt")
        assert rf.find_entry("/d/e", "hello.txt") is None
        f.store.close()
        rf.store.close()


_HYGIENE = r"""
import sys
sys.modules["jax"] = None
import seaweedfs_tpu_torch.filer.redis_store, seaweedfs_tpu_torch.filer.mongo_store
import seaweedfs_tpu_torch.filer.etcd_store, seaweedfs_tpu_torch.utils.bson_lite
import seaweedfs_tpu_torch.utils.mini_redis, seaweedfs_tpu_torch.utils.mini_mongo
import seaweedfs_tpu_torch.utils.mini_etcd
print("LOADED", sorted(n for n, m in sys.modules.items() if m is not None
                       and n.split(".")[0] in ("torch", "jax", "seaweedfs_tpu")))
"""


def test_stores_import_neither_jax_torch_nor_the_reference():
    out = subprocess.run([sys.executable, "-c", _HYGIENE], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
