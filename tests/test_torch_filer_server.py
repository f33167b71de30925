"""The port's filer server (seaweedfs_tpu_torch/filer/filer_server.py, its
HTTP plane on the port's fastweb) against the JAX package's (aiohttp), both
over one cluster of the port on the CPU (tests/torch_cluster.py: a port
master and four port volume servers).

The same seeded tree goes into each filer over HTTP (Content-Length,
chunked and multipart bodies) and is read back (whole, ranged, HEAD,
listings): bytes, sizes, md5 ETags, mime types and the chunk layout are
equal, fids aside. A 64 MiB streamed PUT and GET hold the port's body
queue bound and upload window; a body that fails mid-stream leaves no
entry and no needle. Each package's FilerClient drives the other's filer;
a JAX filer and a port filer on one master mesh their metadata; a filer
file on a volume sealed at RS(10,4) with four shards lost reads back
equal through both."""

import hashlib
import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.client.filer_client import FilerClient as RefFilerClient
from seaweedfs_tpu.filer.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu_torch.client.filer_client import FilerClient
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.utils import failpoints, fastweb
from seaweedfs_tpu_torch.utils.rpc import FILER_SERVICE, Stub

MiB = 1 << 20


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("filer-cluster"),
                 volume_size_limit_mb=64)
    yield c
    tc.stop(c)


def _filer(cls, c, **kw):
    port = tc.free_port_pair()
    return cls(c["master"].address, store_spec="memory", port=port,
               chunk_size_mb=1, **kw).start()


@pytest.fixture(scope="module")
def filers(cluster):
    """A port filer and a JAX filer over the same cluster."""
    port = _filer(FilerServer, cluster)
    ref = _filer(RefFilerServer, cluster)
    yield {"port": port, "ref": ref}
    port.stop()
    ref.stop()


def _req(port: int, method: str, path: str, body=None, headers=None,
         encode_chunked=False):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body, headers=headers or {},
                  encode_chunked=encode_chunked)
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


def _multipart(name: str, data: bytes, mime: str) -> "tuple[bytes, str]":
    b = "swtpu-test-boundary"
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: {mime}\r\n\r\n").encode() \
        + data + f"\r\n--{b}--\r\n".encode()
    return body, f"multipart/form-data; boundary={b}"


def _tree():
    rng = np.random.default_rng(17)
    return {"empty": b"", "a.txt": b"hello filer\n" * 100,
            "b.bin": rng.bytes(MiB - 1), "c.bin": rng.bytes(MiB),
            "d.bin": rng.bytes(5 * MiB // 2), "e.json": b'{"k": 1}',
            "pic.png": rng.bytes(70_000), "named.dat": rng.bytes(3000)}


def _write_tree(port: int) -> list:
    """Each way of writing, once; the statuses and JSON answers."""
    t = _tree()
    out = []

    def put(path, body, headers=None, **kw):
        st, _, b = _req(port, "PUT", path, body, headers, **kw)
        out.append((path, st, json.loads(b) if b else None))

    put("/t/empty", b"")
    put("/t/a.txt", t["a.txt"], {"Content-Type": "text/plain; charset=utf-8"})
    put("/t/b.bin", t["b.bin"])
    put("/t/c.bin", t["c.bin"], {"Content-Type": "application/octet-stream"})
    put("/t/d.bin", (t["d.bin"][i:i + 100_000]
                     for i in range(0, len(t["d.bin"]), 100_000)),
        encode_chunked=True)
    put("/t/e.json", t["e.json"])
    for path, name, mime in (("/t/up/", "pic.png", "image/png"),
                             ("/t/named.dat", "ignored.bin",
                              "application/x-named")):
        body, ctype = _multipart(name, t[name if name in t else "named.dat"],
                                 mime)
        st, _, b = _req(port, "POST", path, body, {"Content-Type": ctype})
        out.append((path, st, json.loads(b)))
    return out


_HEADERS = ("content-type", "content-length", "etag", "accept-ranges",
            "content-range")


def _read_tree(port: int) -> list:
    """Every read a client makes of the tree: statuses, the headers that
    carry meaning, the bytes (hashed) and the masked listings."""
    out = []

    def get(path, headers=None, method="GET"):
        st, hd, b = _req(port, method, path, None, headers)
        row = [path, method, headers, st,
               {k: hd.get(k) for k in _HEADERS if k in hd}]
        if hd.get("content-type", "").startswith("application/json"):
            # aiohttp names the charset of its JSON, fastweb does not
            row[4]["content-type"] = "application/json"
        if st < 300 and hd.get("content-type", "").startswith(
                "application/json") and method == "GET" and "Entries" in (
                b.decode(errors="replace")):
            doc = json.loads(b)
            for e in doc["Entries"]:
                e.pop("Mtime"), e.pop("Crtime")
            row[4].pop("content-length", None)
            row.append(doc)
        else:
            row.append(hashlib.sha256(b).hexdigest() if st < 300 else None)
        out.append(row)

    for name in ("empty", "a.txt", "b.bin", "c.bin", "d.bin", "e.json",
                 "up/pic.png", "named.dat", "missing"):
        get(f"/t/{name}")
        get(f"/t/{name}", method="HEAD")
    for rng in ("bytes=0-99", "bytes=1048000-1049999", "bytes=-500",
                "bytes=2621000-", "bytes=100-", "bytes=5-3", "bytes=9-9",
                "bytes=3000000-"):
        get("/t/d.bin", {"Range": rng})
    get("/t/a.txt", {"Range": "bytes=5-"})
    get("/t", None)
    get("/t/?limit=2&lastFileName=b.bin")
    get("/t/up/")
    return out


def _layout(fs) -> dict:
    """name -> the entry's chunk layout and attributes, fids aside."""
    stub = Stub(f"127.0.0.1:{fs.grpc_port}", FILER_SERVICE)
    out = {}
    for d in ("/t", "/t/up"):
        for r in stub.call_stream("ListEntries",
                                  fpb.ListEntriesRequest(directory=d),
                                  fpb.ListEntriesResponse):
            e = r.entry
            a = e.attributes
            out[f"{d}/{e.name}"] = (
                e.is_directory, a.file_size, a.mime, a.md5.hex(), a.ttl_sec,
                a.file_mode, [(c.offset, c.size) for c in e.chunks],
                bool(e.content))
    return out


def test_same_tree_as_the_reference_filer(filers):
    """Both filers take the same tree (PUT with a length, chunked PUT,
    multipart into a directory and onto a path) and answer every read
    alike: statuses, Content-Type, Content-Length, md5 ETags, ranges
    (inside a chunk, across chunks, suffix, open, past the end, inverted),
    HEAD, listings with paging; their chunk layouts and attributes are
    equal; then the same deletes."""
    wrote = {k: _write_tree(fs.port) for k, fs in filers.items()}
    assert wrote["port"] == wrote["ref"]
    assert all(st == 201 for _, st, _ in wrote["port"])
    read = {k: _read_tree(fs.port) for k, fs in filers.items()}
    for got, want in zip(read["port"], read["ref"]):
        assert got == want, (got[:4], want[:4])
    # the bytes are the tree's
    t = _tree()
    row = next(r for r in read["port"] if r[0] == "/t/d.bin" and r[2] is None
               and r[1] == "GET")
    assert row[5] == hashlib.sha256(t["d.bin"]).hexdigest()
    assert row[4]["etag"] == f'"{hashlib.md5(t["d.bin"]).hexdigest()}"'
    lay = {k: _layout(fs) for k, fs in filers.items()}
    assert lay["port"] == lay["ref"]
    assert lay["port"]["/t/d.bin"][6] == [(0, MiB), (MiB, MiB),
                                          (2 * MiB, MiB // 2)]
    assert lay["port"]["/t/a.txt"][2] == "text/plain"
    assert lay["port"]["/t/up/pic.png"][2] == "image/png"
    dels = {}
    for k, fs in filers.items():
        dels[k] = [_req(fs.port, "DELETE", p)[0] for p in (
            "/t/a.txt", "/t/a.txt", "/t/up", "/t/up?recursive=true")]
        dels[k].append(_req(fs.port, "GET", "/t/up/pic.png")[0])
    assert dels["port"] == dels["ref"]
    assert dels["port"][0] == 204 and dels["port"][-1] == 404


def _live_needles(c) -> int:
    return sum(v.file_count for served in c["served"].values()
               for loc in served.vs.store.locations
               for v in list(loc.volumes.values()))


def test_streamed_put_and_get_of_64_mib_hold_the_window(cluster,
                                                        monkeypatch,
                                                        tmp_path):
    """A 64 MiB PUT at -maxMB 1 streams through the route's body queue (at
    most 256 KiB waiting, no piece larger) and the upload window (at most
    SWTPU_FILER_UPLOAD_CONC chunks in flight); the GET streams it back
    window by window (no window past SWTPU_FILER_READ_WINDOW chunks, and
    the transport holding no more than one window past its high-water
    mark, asyncio's default 64 KiB); bytes and md5 equal. An uncached
    remote-mounted object of 6 MiB streams back in windows of one chunk."""
    monkeypatch.setattr(fastweb, "STREAM_BOUND", 256 << 10)
    fs = FilerServer(cluster["master"].address, store_spec="memory",
                     port=tc.free_port_pair(), chunk_size_mb=1)
    fs.start()
    try:
        rng = np.random.default_rng(64)
        pieces = [rng.bytes(MiB) for _ in range(4)]
        h = hashlib.md5()
        for i in range(64):
            h.update(pieces[i % 4])
        st, _, b = _req(fs.port, "PUT", "/big/obj.bin",
                        (pieces[i % 4] for i in range(64)),
                        {"Content-Length": str(64 * MiB)})
        assert st == 201 and json.loads(b)["size"] == 64 * MiB
        peaks = dict(fs.stream_peaks)
        assert 0 < peaks["queued"] <= 256 << 10
        assert 0 < peaks["piece"] <= 256 << 10
        assert 1 <= peaks["inflight_chunks"] <= fs.upload_conc
        c = http.client.HTTPConnection("127.0.0.1", fs.port, timeout=120)
        c.request("GET", "/big/obj.bin")
        r = c.getresponse()
        assert r.status == 200 and r.getheader("Content-Length") == \
            str(64 * MiB)
        assert r.getheader("ETag") == f'"{h.hexdigest()}"'
        got = hashlib.md5()
        n = 0
        while True:
            piece = r.read(MiB)
            if not piece:
                break
            got.update(piece)
            n += len(piece)
        c.close()
        assert n == 64 * MiB and got.hexdigest() == h.hexdigest()
        window = fs.read_window_views * MiB
        tc.wait_until(lambda: fs.stream_peaks["window"] > 0,
                      msg="the GET's peaks recorded")
        peaks = dict(fs.stream_peaks)
        assert peaks["window"] <= window
        assert peaks["sent_buffered"] <= window + (64 << 10)
        e = fs.filer.find_entry("/big", "obj.bin")
        assert len(e.chunks) == 64
        from seaweedfs_tpu_torch.remote import mount_remote
        remote = rng.bytes(6 * MiB + 12345)
        (tmp_path / "rem").mkdir()
        (tmp_path / "rem" / "obj.bin").write_bytes(remote)
        mount_remote(fs, "/rem", f"local:{tmp_path}/rem")
        for k in fs.stream_peaks:
            fs.stream_peaks[k] = 0
        st, _, body = _req(fs.port, "GET", "/rem/obj.bin")
        assert (st, body) == (200, remote)
        tc.wait_until(lambda: fs.stream_peaks["window"] > 0,
                      msg="the remote GET's peaks recorded")
        assert fs.stream_peaks["window"] <= MiB
        assert fs.stream_peaks["sent_buffered"] <= MiB + (64 << 10)
    finally:
        fs.stop()


@pytest.mark.parametrize("how", ["client-drop", "chunk-upload-fails"])
def test_mid_stream_failure_leaves_no_entry(cluster, filers, how):
    """A PUT whose body dies mid-stream (the client drops after 5 of 8 MiB,
    or the sixth chunk's upload fails) publishes no entry, and every chunk
    that landed is deleted again."""
    fs = filers["port"]
    before = _live_needles(cluster)
    body = np.random.default_rng(5).bytes(8 * MiB)
    if how == "client-drop":
        s = socket.create_connection(("127.0.0.1", fs.port), 30)
        s.sendall(b"PUT /drop/x.bin HTTP/1.1\r\nHost: t\r\nContent-Length: "
                  + str(len(body)).encode() + b"\r\n\r\n" + body[:5 * MiB])
        tc.wait_until(lambda: fs.stream_peaks["inflight_chunks"] > 0,
                      msg="chunks in flight")
        time.sleep(0.5)
        s.close()
    else:
        calls = {"n": 0}

        def gen():
            for i in range(8):
                if i == 6:
                    failpoints.configure("filer.blob.write", "error:boom")
                yield body[i * MiB:(i + 1) * MiB]
                calls["n"] += 1

        try:
            st, _, _ = _req(fs.port, "PUT", "/drop/x.bin", gen(),
                            {"Content-Length": str(len(body))})
            assert st == 500
        except OSError:
            pass  # the server answered and closed before the body ended
        finally:
            failpoints.configure("filer.blob.write", "off")
    tc.wait_until(lambda: fs.filer.find_entry("/drop", "x.bin") is None
                  and _live_needles(cluster) == before, timeout=30,
                  msg="no entry and the landed chunks deleted")
    assert _req(fs.port, "GET", "/drop/x.bin")[0] == 404


def test_filer_clients_cross_packages(filers):
    """The JAX package's FilerClient drives the port's filer and the
    port's drives the JAX filer: writes chunked to the blob cluster, entry
    lookups, listings, reads back, deletes, and the metadata stream."""
    rng = np.random.default_rng(3)
    for client_cls, fs in ((RefFilerClient, filers["port"]),
                           (FilerClient, filers["ref"])):
        fc = client_cls(f"127.0.0.1:{fs.port}", client_name="x")
        since = fc.filer.server_now_ns()
        data = rng.bytes(2 * MiB + 77)
        fc.write_file("/x/one.bin", data, mime="application/x-one")
        fc.write_file("/x/two.txt", b"two")
        e = fc.filer.find_entry("/x", "one.bin")
        assert e.attributes.file_size == len(data)
        assert e.attributes.mime == "application/x-one"
        assert [c.size for c in e.chunks] == [MiB, MiB, 77]
        assert fc.read_entry_bytes(e) == data
        assert fc.read_entry_bytes(e, MiB - 5, 10) == data[MiB - 5:MiB + 5]
        assert [x.name for x in fc.filer.list_entries("/x")] == \
            ["one.bin", "two.txt"]
        st, _, body = _req(fs.port, "GET", "/x/one.bin")
        assert (st, body) == (200, data)
        fc.filer.delete_entry("/x", "two.txt", True, False)
        assert fc.filer.find_entry("/x", "two.txt") is None
        stop = threading.Event()
        names = []
        for resp in fc.filer.subscribe(since, stop, path_prefix="/x"):
            ev = resp.event_notification
            names.append((ev.old_entry.name, ev.new_entry.name))
            if len(names) == 4:
                stop.set()
                break
        assert ("", "one.bin") in names and ("two.txt", "") in names
        fc.close()


def test_meta_aggregator_meshes_jax_and_port_filers(cluster):
    """A JAX filer and a port filer on one master with the peer mesh on
    see each other's creates and deletes."""
    port = _filer(FilerServer, cluster, meta_aggregate=True)
    ref = _filer(RefFilerServer, cluster, meta_aggregate=True)
    try:
        port.write_file("/mesh/from-port.txt", b"p" * 10)
        ref.write_file("/mesh/from-ref.txt", b"r" * 20)
        tc.wait_until(lambda: ref.filer.find_entry("/mesh", "from-port.txt")
                      is not None and port.filer.find_entry(
                          "/mesh", "from-ref.txt") is not None, timeout=30,
                      msg="each filer sees the other's create")
        got = port.filer.find_entry("/mesh", "from-ref.txt")
        assert got.attributes.file_size == 20
        assert port.read_entry_bytes(got) == b"r" * 20
        port.filer.delete_entry("/mesh", "from-port.txt", True, False)
        tc.wait_until(lambda: ref.filer.find_entry("/mesh", "from-port.txt")
                      is None, timeout=30, msg="the delete relayed")
        assert f"{ref.ip}:{ref.port}" in port.aggregator.peers
    finally:
        port.stop()
        ref.stop()


def test_degraded_read_of_a_sealed_filer_file(cluster, filers):
    """Files of a port filer on volumes sealed at RS(10,4) (the port's
    shell, ec.encode), shards 0, 5, 10 and 13 unmounted on every holder:
    reads through the port filer and the JAX filer give the written
    bytes, the servers reconstructing the lost intervals."""
    fs = FilerServer(cluster["master"].address, store_spec="memory",
                     port=tc.free_port_pair(), chunk_size_mb=1,
                     collection="fdeg").start()
    ref = _filer(RefFilerServer, cluster)
    try:
        rng = np.random.default_rng(13)
        files = {f"/deg/f{i}.bin": rng.bytes(int(n))
                 for i, n in enumerate((MiB + 999, 300_000, 4_321))}
        for p, data in files.items():
            fs.write_file(p, data)
        for served in cluster["served"].values():
            served.vs.heartbeat_flush()
        vids = set()
        tc.wait_until(lambda: vids.update(
            v.id for dc in cluster["mc"].volume_list()
            .topology_info.data_center_infos for rk in dc.rack_infos
            for dn in rk.data_node_infos for d in dn.disk_infos.values()
            for v in d.volume_infos if v.collection == "fdeg" and v.size > 8)
            or vids, msg="fdeg volumes")
        out = tc.shell(cluster, "lock", *[f"ec.encode -volumeId {v}"
                                          for v in sorted(vids)], "unlock")
        assert "error" not in out.lower(), out
        for v in vids:
            tc.wait_until(lambda v=v: len(cluster["mc"].lookup_ec(v)) == 14,
                          timeout=30, msg=f"volume {v}'s shards")
        lost = [0, 5, 10, 13]
        for served in cluster["served"].values():
            for v in vids:
                if served.vs.store.find_ec_volume(v) is not None:
                    served.vs.volume_ec_shards_unmount(v, lost)
        r0 = sum(s.vs.read_stats.get("reconstructs", 0)
                 for s in cluster["served"].values())
        from seaweedfs_tpu.pb import filer_pb2 as ref_fpb
        for p, data in files.items():
            entry = fs.filer.find_entry(*p.rsplit("/", 1))
            assert fs.read_entry_bytes(entry) == data
            assert ref.read_entry_bytes(ref_fpb.Entry.FromString(
                entry.SerializeToString())) == data
            st, _, body = _req(fs.port, "GET", p)
            assert (st, body) == (200, data)
        assert sum(s.vs.read_stats.get("reconstructs", 0)
                   for s in cluster["served"].values()) > r0
    finally:
        fs.stop()
        ref.stop()


def test_degraded_4_mib_chunk_at_16_kib_blocks_reads_within_verify(
        tmp_path):
    """A 4 MiB chunk sealed at RS(10,4) with 16 KiB small blocks is 256
    intervals; with shards 0, 5, 10 and 13 unmounted on every holder, four
    GETs of it at once (as fs.verify reads a chunk: the volume server's
    URL, a 10 s timeout) each come back whole within those 10 s, and each
    reconstructs once per lost data shard: the server reads each shard's
    adjacent intervals as one run, its remote runs concurrently. Interval
    by interval, one after another, such a read outlasted fs.verify's
    deadline under loaded test workers."""
    from seaweedfs_tpu_torch.client import http_util
    c = tc.start(tmp_path / "c", volume_size_limit_mb=64,
                 small_block=1 << 14)
    fs = FilerServer(c["master"].address, store_spec="memory",
                     port=tc.free_port_pair(), chunk_size_mb=4,
                     collection="v16").start()
    try:
        data = np.random.default_rng(21).bytes(4 * MiB)
        fs.write_file("/v16/chunk.bin", data)
        e = fs.filer.find_entry("/v16", "chunk.bin")
        assert len(e.chunks) == 1
        vid = int(e.chunks[0].file_id.split(",")[0])
        for served in c["served"].values():
            served.vs.heartbeat_flush()
        tc.wait_until(lambda: any(
            v.id == vid and v.size > 4 * MiB
            for dc in c["mc"].volume_list().topology_info.data_center_infos
            for rk in dc.rack_infos for dn in rk.data_node_infos
            for d in dn.disk_infos.values() for v in d.volume_infos),
            msg="the chunk's volume size at the master")
        out = tc.shell(c, "lock", f"ec.encode -volumeId {vid}", "unlock")
        assert "error" not in out.lower(), out
        tc.wait_until(lambda: len(c["mc"].lookup_ec(vid)) == 14,
                      timeout=30, msg="the volume's shards")
        for served in c["served"].values():
            if served.vs.store.find_ec_volume(vid) is not None:
                served.vs.volume_ec_shards_unmount(vid, [0, 5, 10, 13])
        r0 = sum(s.vs.read_stats.get("reconstructs", 0)
                 for s in c["served"].values())
        url = c["mc"].lookup_file_id(e.chunks[0].file_id)[0]
        said = [None] * 4

        def get(i):
            t = time.monotonic()
            r = http_util.get(url, timeout=10)
            said[i] = (r.status, r.content == data, time.monotonic() - t)

        threads = [threading.Thread(target=get, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(s is not None and s[:2] == (200, True) and s[2] < 10
                   for s in said), said
        assert sum(s.vs.read_stats.get("reconstructs", 0)
                   for s in c["served"].values()) - r0 == 4 * 2
    finally:
        fs.stop()
        tc.stop(c)


def test_filer_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """Phase 20 of chip_smoke.py on the CPU at a small size (24 small
    files, one of 1-16 MiB, one of 5 MiB; 16 KiB EC small blocks): every
    step's checks hold, and the reads with r1 lost reconstruct."""
    import chip_smoke
    import torch
    res = chip_smoke.filer_round_trip(np, torch, str(tmp_path), 7, "cpu",
                                      24, 1, 5, 8, 2, device="cpu",
                                      small_block=1 << 14)
    assert res["reconstructs"] > 0 and res["widths"]
    assert res["verdict"] in ("DEGRADED", "AT_RISK")
