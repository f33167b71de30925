"""The port's filer core (seaweedfs_tpu_torch/filer/) against the JAX
package's, on the same seeded inputs: chunk views, interval resolution,
manifests and windowed reads; the memory, sqlite, logdb and lsm stores
under one op sequence, and the store files and meta logs each package
writes opened by the other; filer.conf rules; the namespace core and the
events it logs; the AES-GCM chunk cipher; crashsim's meta-log scenario."""

import os
import threading

import numpy as np
import pytest

from seaweedfs_tpu.devtools import crashsim as ref_crashsim
from seaweedfs_tpu.filer import chunk_cache as ref_cc
from seaweedfs_tpu.filer import chunks as ref_chunks
from seaweedfs_tpu.filer import filer as ref_filer
from seaweedfs_tpu.filer import filer_conf as ref_conf
from seaweedfs_tpu.filer import meta_log as ref_meta
from seaweedfs_tpu.filer import store as ref_store
from seaweedfs_tpu.pb import filer_pb2 as ref_fpb
from seaweedfs_tpu_torch.devtools import crashsim
from seaweedfs_tpu_torch.filer import chunk_cache as port_cc
from seaweedfs_tpu_torch.filer import chunks as port_chunks
from seaweedfs_tpu_torch.filer import filer as port_filer
from seaweedfs_tpu_torch.filer import filer_conf as port_conf
from seaweedfs_tpu_torch.filer import meta_log as port_meta
from seaweedfs_tpu_torch.filer import store as port_store
from seaweedfs_tpu_torch.pb import filer_pb2 as port_fpb

PKG = {"port": dict(chunks=port_chunks, cc=port_cc, store=port_store,
                    meta=port_meta, filer=port_filer, conf=port_conf,
                    fpb=port_fpb),
       "ref": dict(chunks=ref_chunks, cc=ref_cc, store=ref_store,
                   meta=ref_meta, filer=ref_filer, conf=ref_conf,
                   fpb=ref_fpb)}


def _chunk_list(fpb, seed: int, n: int = 24, span: int = 4000):
    """Seeded overlapping chunks (newest wins), some with gaps between."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        off = int(rng.integers(0, span))
        out.append(fpb.FileChunk(
            file_id=f"{i % 7 + 1},{i:x}{int(rng.integers(0, 1 << 32)):08x}",
            offset=off, size=int(rng.integers(1, 600)),
            modified_ts_ns=int(rng.integers(1, 50)),
            e_tag=f"{int(rng.integers(0, 1 << 60)):x}"))
    return out


def _oracle(chunks, length):
    owner = [None] * length
    for c in sorted(chunks, key=lambda c: (c.modified_ts_ns, c.file_id)):
        for i in range(c.offset, min(c.offset + c.size, length)):
            owner[i] = (c.file_id, i - c.offset)
    return owner


def _views(pkg, chunks, offset, size):
    return [(v.file_id, v.chunk_offset, v.size, v.logical_offset)
            for v in PKG[pkg]["chunks"].read_views(chunks, offset, size)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_read_views_and_resolution(pkg, seed):
    """Each package's views cover the range newest-wins (a byte oracle),
    and the port's views, resolution, size and ETag equal the JAX
    package's on the same chunks."""
    fpb, ch = PKG[pkg]["fpb"], PKG[pkg]["chunks"]
    chunks = _chunk_list(fpb, seed)
    end = ch.total_size(chunks)
    owner = _oracle(chunks, end)
    rng = np.random.default_rng(seed + 100)
    for _ in range(20):
        off = int(rng.integers(0, end))
        size = int(rng.integers(0, end - off + 50))
        for fid, coff, n, loff in _views(pkg, chunks, off, size):
            for k in range(n):
                assert owner[loff + k] == (fid, coff + k)
        if pkg == "port":
            ref = _chunk_list(ref_fpb, seed)
            assert _views("port", chunks, off, size) == \
                _views("ref", ref, off, size)
    if pkg == "port":
        ref = _chunk_list(ref_fpb, seed)
        got = [(a, b, c.file_id) for a, b, c in ch.resolve_chunks(chunks)]
        want = [(a, b, c.file_id) for a, b, c in
                ref_chunks.resolve_chunks(ref)]
        assert got == want
        assert ch.etag(chunks) == ref_chunks.etag(ref)
        assert ch.total_size(chunks) == ref_chunks.total_size(ref)


@pytest.mark.parametrize("batch", [3, 5])
def test_manifestize_at_a_tiny_batch(monkeypatch, batch):
    """maybe_manifestize folds runs of MANIFEST_BATCH chunks into manifest
    blobs byte-equal to the JAX package's, and resolve_manifests restores
    the chunk list (MANIFEST_BATCH cut from 1,000 to `batch`)."""
    results = {}
    for pkg in ("port", "ref"):
        fpb, ch = PKG[pkg]["fpb"], PKG[pkg]["chunks"]
        monkeypatch.setattr(ch, "MANIFEST_BATCH", batch)
        blobs = {}

        def save(blob, blobs=blobs, fpb=fpb):
            fid = f"9,{len(blobs):x}00000001"
            blobs[fid] = blob
            return fpb.FileChunk(file_id=fid, size=len(blob),
                                 modified_ts_ns=1)

        chunks = [fpb.FileChunk(file_id=f"3,{i:x}0000abcd", offset=i * 100,
                                size=100, modified_ts_ns=i + 1)
                  for i in range(batch * 3 + 2)]
        folded = ch.maybe_manifestize(list(chunks), save)
        assert sum(c.is_chunk_manifest for c in folded) == 3
        back = ch.resolve_manifests(folded, blobs.__getitem__)
        assert sorted(c.SerializeToString() for c in back) == \
            sorted(c.SerializeToString() for c in chunks)
        results[pkg] = ([c.SerializeToString() for c in folded],
                        sorted(blobs.items()))
    assert results["port"] == results["ref"]


@pytest.mark.parametrize("window_views", [1, 2, 4])
@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_iter_windows_with_gaps(pkg, window_views):
    """Windows of a chunked file with holes tile the range exactly (zeros
    in the holes) and equal the byte oracle; the port's windows equal the
    JAX package's, window by window."""
    fpb, cc = PKG[pkg]["fpb"], PKG[pkg]["cc"]
    rng = np.random.default_rng(window_views)
    blobs, chunks, pos = {}, [], 0
    for i in range(9):
        pos += int(rng.integers(0, 300))  # a gap
        n = int(rng.integers(1, 900))
        fid = f"4,{i:x}00000007"
        blobs[fid] = rng.bytes(n)
        chunks.append(fpb.FileChunk(file_id=fid, offset=pos, size=n,
                                    modified_ts_ns=i + 1))
        pos += n
    want = bytearray(pos)
    for c in chunks:
        want[c.offset:c.offset + c.size] = blobs[c.file_id]

    def fetch(fid, upcoming=None):
        return blobs[fid]

    for off, size in ((0, pos), (17, pos - 40), (pos - 5, 100), (3, 0)):
        wins = list(cc.iter_windows(chunks, off, size, fetch,
                                    window_views=window_views))
        end = min(off + size, pos) if size else off
        assert b"".join(wins)[:end - off] == bytes(want[off:end])
        assert cc.assemble_window(chunks, off, size, fetch) == b"".join(wins)
        if pkg == "port":
            ref_chunks_ = [ref_fpb.FileChunk.FromString(c.SerializeToString())
                           for c in chunks]
            assert wins == list(ref_cc.iter_windows(
                ref_chunks_, off, size, fetch, window_views=window_views))


def _entry(fpb, rng, name, is_dir=False):
    e = fpb.Entry(name=name, is_directory=is_dir)
    e.attributes.file_size = int(rng.integers(0, 1 << 30))
    e.attributes.mtime = int(rng.integers(1, 1 << 31))
    e.attributes.mime = "application/x-test"
    if not is_dir:
        for i in range(int(rng.integers(0, 3))):
            e.chunks.add(file_id=f"{i + 1},{int(rng.integers(1, 1 << 40)):x}",
                         offset=i * 10, size=10, modified_ts_ns=i + 1)
    return e


def _open(pkg, kind, path):
    st = PKG[pkg]["store"]
    if kind == "memory":
        return st.MemoryStore()
    if kind == "sqlite":
        return st.SqliteStore(os.path.join(path, "filer.db"))
    if kind == "logdb":
        return st.LogDbStore(os.path.join(path, "filer.logdb"))
    return st.LsmStore(os.path.join(path, "lsm"), memtable_limit=7)


def _apply_ops(pkg, store, seed: int) -> None:
    """A seeded op sequence: inserts, overwrites, deletes, folder clears,
    KV puts (the lsm memtable of 7 flushes and compacts on the way)."""
    fpb = PKG[pkg]["fpb"]
    rng = np.random.default_rng(seed)
    dirs = ["/", "/a", "/a/b", "/c", "/c/d e"]
    for step in range(160):
        d = dirs[int(rng.integers(0, len(dirs)))]
        name = f"n{int(rng.integers(0, 24)):02d}"
        op = int(rng.integers(0, 10))
        if op < 5:
            store.insert_entry(d, _entry(fpb, rng, name, op == 0))
        elif op < 7:
            store.update_entry(d, _entry(fpb, rng, name))
        elif op < 9:
            store.delete_entry(d, name)
        elif step % 40 == 39:
            store.delete_folder_children(d)
        store.kv_put(f"k{step % 13}".encode(), rng.bytes(8))


def _listing(store) -> dict:
    out = {}
    for d in ["/", "/a", "/a/b", "/c", "/c/d e"]:
        out[d] = [e.SerializeToString() for e in store.list_entries(d)]
        out[d + "?n1"] = [e.name for e in store.list_entries(
            d, start_from="n10", inclusive=True, limit=5, prefix="n1")]
    out["kv"] = [store.kv_get(f"k{i}".encode()) for i in range(14)]
    return out


@pytest.mark.parametrize("kind", ["memory", "sqlite", "logdb", "lsm"])
def test_store_ops_equal_reference(tmp_path, kind):
    """The same seeded op sequence on each package's store of a kind gives
    equal listings (entries byte for byte, start/inclusive/prefix/limit
    pages) and KV values."""
    got = {}
    for pkg in ("port", "ref"):
        d = tmp_path / pkg
        d.mkdir()
        st = _open(pkg, kind, str(d))
        _apply_ops(pkg, st, seed=11)
        got[pkg] = _listing(st)
        st.close()
    assert got["port"] == got["ref"]
    assert sum(len(v) for k, v in got["port"].items() if k != "kv")


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("kind", ["sqlite", "logdb", "lsm"])
def test_store_files_open_in_the_other_package(tmp_path, kind, writer):
    """A sqlite db, a logdb file or an lsm directory written by one package
    opens in the other with the same listing and KV."""
    reader = "ref" if writer == "port" else "port"
    st = _open(writer, kind, str(tmp_path))
    _apply_ops(writer, st, seed=5)
    want = _listing(st)
    st.close()
    st = _open(reader, kind, str(tmp_path))
    assert _listing(st) == want
    st.close()


def test_open_store_specs(tmp_path):
    """open_store takes the reference's embeddable specs, and its redis,
    mongo and etcd specs open the port's stores on the port's stand-ins
    (tests/test_torch_filer_stores.py holds those stores)."""
    from seaweedfs_tpu_torch.utils.mini_etcd import MiniEtcd
    from seaweedfs_tpu_torch.utils.mini_mongo import MiniMongo
    from seaweedfs_tpu_torch.utils.mini_redis import MiniRedis
    assert port_store.open_store("memory").name == "memory"
    assert port_store.open_store(f"sqlite:{tmp_path}/x.db").name == "sqlite"
    assert port_store.open_store(f"lsm:{tmp_path}/l").name == \
        ref_store.open_store(f"lsm:{tmp_path}/l2").name
    for kind, cls in (("redis", MiniRedis), ("mongo", MiniMongo),
                      ("etcd", MiniEtcd)):
        srv = cls().start()
        try:
            st = port_store.open_store(f"{kind}:{srv.address}")
            assert st.name == kind and \
                type(st).__module__.startswith("seaweedfs_tpu_torch.")
            st.close()
        finally:
            srv.stop()
    with pytest.raises(ValueError):
        port_store.open_store("cassandra:whatever")


def _events(pkg, path):
    ml = PKG[pkg]["meta"].MetaLog(path)
    stop = threading.Event()
    stop.set()
    out = [(r.ts_ns, r.directory, r.event_notification.SerializeToString())
           for r in ml.subscribe(0, stop)]
    ml.close()
    return out


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_meta_log_replays_in_the_other_package(tmp_path, writer):
    """A meta log appended by one package replays in the other: the same
    events, timestamps and directories, from 0 and from a midpoint."""
    fpb = PKG[writer]["fpb"]
    path = str(tmp_path / "meta.log")
    ml = PKG[writer]["meta"].MetaLog(path)
    rng = np.random.default_rng(3)
    for i in range(40):
        ev = fpb.EventNotification()
        if i % 3:
            ev.new_entry.CopyFrom(_entry(fpb, rng, f"e{i}"))
        if i % 4 == 0:
            ev.old_entry.CopyFrom(_entry(fpb, rng, f"e{i - 1}"))
        ev.signatures.append(int(rng.integers(1, 1 << 30)))
        ml.append(f"/d{i % 5}", ev)
    ml.close()
    want = _events(writer, path)
    reader = "ref" if writer == "port" else "port"
    assert _events(reader, path) == want and len(want) == 40
    ml = PKG[reader]["meta"].MetaLog(path)
    stop = threading.Event()
    stop.set()
    mid = want[20][0]
    assert [r.ts_ns for r in ml.subscribe(mid, stop)] == \
        [w[0] for w in want if w[0] > mid]
    ml.close()


def test_filer_conf_rules_equal_reference():
    """Seeded rules and paths: the longest-prefix match, upsert, delete
    and the JSON document equal the JAX package's."""
    prefixes = ["/", "/a/", "/a/b/", "/buckets/", "/buckets/logs/", "/hot/"]
    parts = ["a", "b", "buckets", "logs", "hot", "x"]
    rng = np.random.default_rng(4)
    paths = ["/" + "/".join(rng.choice(parts, int(k))) + "/f"
             for k in rng.integers(1, 4, 40)]
    docs = {}
    for pkg in ("port", "ref"):
        conf = PKG[pkg]["conf"]
        r = np.random.default_rng(9)
        fc = conf.FilerConf()
        for p in prefixes:
            fc.upsert(conf.PathRule(
                location_prefix=p, collection=f"c{int(r.integers(0, 9))}",
                replication=["", "001", "010"][int(r.integers(0, 3))],
                ttl=["", "7d"][int(r.integers(0, 2))],
                fsync=bool(r.integers(0, 2))))
        fc.delete("/a/")
        raw = fc.to_bytes()
        back = conf.FilerConf.from_bytes(raw)
        docs[pkg] = (raw, [(m.location_prefix, m.collection, m.replication,
                            m.ttl, m.fsync) if (m := back.match(p)) else None
                           for p in paths])
    assert docs["port"] == docs["ref"]
    assert any(m is not None for m in docs["port"][1])


def _namespace_ops(pkg, tmp_path):
    """One seeded namespace history on a Filer of `pkg` over a memory
    store: its final listing, the events it logged and the chunk fids it
    handed to GC."""
    fpb = PKG[pkg]["fpb"]
    deleted = []
    f = PKG[pkg]["filer"].Filer(PKG[pkg]["store"].MemoryStore(),
                                meta_log_path=str(tmp_path / f"{pkg}.log"),
                                chunk_deleter=deleted.extend)
    rng = np.random.default_rng(21)
    for i in range(30):
        e = _entry(fpb, rng, f"f{i:02d}")
        e.attributes.ttl_sec = 0
        e.attributes.mtime = 1 << 40  # never expired
        f.create_entry(f"/t/d{i % 4}", e)
    f.rename("/t/d0", "f00", "/t/d1", "moved")
    f.rename("/t", "d2", "/u", "d2")
    f.delete_entry("/t/d3", "f03", is_delete_data=True)
    f.delete_entry("/t", "d1", is_delete_data=True, is_recursive=True)
    e = _entry(fpb, rng, "f06")
    e.attributes.mtime = 1 << 40
    f.update_entry("/t/d2" if f.find_entry("/t/d2", "f06") else "/u/d2", e)
    listing = {}
    for d in ("/", "/t", "/t/d0", "/t/d3", "/u", "/u/d2"):
        listing[d] = [(x.name, x.is_directory, [c.file_id for c in x.chunks])
                      for x in f.list_entries(d)]
    stop = threading.Event()
    stop.set()
    events = []
    for r in f.meta_log.subscribe(0, stop):
        ev = r.event_notification
        events.append((r.directory, ev.old_entry.name, ev.new_entry.name,
                       ev.new_parent_path, ev.delete_chunks))
    f.close()
    return listing, events, sorted(deleted)


def test_namespace_core_equals_reference(tmp_path):
    """Creates with auto-made parents, renames of a file and of a subtree,
    a delete and a recursive delete: the same listing, the same logged
    events (directory, old and new names, new parent) and the same chunk
    fids handed to GC in both packages."""
    got, want = (_namespace_ops("port", tmp_path),
                 _namespace_ops("ref", tmp_path))
    assert got == want
    assert got[1] and got[2]


def test_cipher_round_trips_across_packages():
    """A chunk sealed by either package's cipher opens with the other's;
    a wrong key fails. Skipped without the optional cryptography."""
    pytest.importorskip("cryptography")
    from seaweedfs_tpu.security import cipher as ref_cipher
    from seaweedfs_tpu_torch.security import cipher
    data = np.random.default_rng(2).bytes(70_000)
    for seal, open_ in ((cipher, ref_cipher), (ref_cipher, cipher)):
        blob, key = seal.encrypt(data)
        assert len(key) == 32 and blob[12:12 + 64] != data[:64]
        assert open_.decrypt(blob, key) == data
        with pytest.raises(Exception):
            open_.decrypt(blob, bytes(32))
    with pytest.raises(ValueError):
        cipher.decrypt(b"short", bytes(32))


@pytest.mark.parametrize("seed", [1, 2])
def test_meta_log_crash_states_match_reference(seed):
    """crashsim's meta-log scenario over the port's MetaLog: 0 violations
    and the reference's distinct crash states on the same seed."""
    got = crashsim.run_scenario(
        next(s for s in crashsim.scenarios("cpu") if s.name == "meta-log"),
        seed=seed)
    want = ref_crashsim.run_scenario(
        next(s for s in ref_crashsim.SCENARIOS if s.name == "meta-log"),
        seed=seed)
    assert got["violations"] == [] and want["violations"] == []
    assert got["states"] >= want["states"] >= 90
