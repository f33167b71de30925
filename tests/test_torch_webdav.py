"""The port's WebDAV gateway (seaweedfs_tpu_torch/webdav/) against the JAX
package's, on the CPU.

A port gateway over a port FilerServer and a JAX gateway over a JAX
FilerServer, both filers over one cluster of the port
(tests/torch_cluster.py): the same ~30-request sequence to each, every
status equal and every body equal once dates and lock tokens are masked,
the bytes of every GET equal; PROPFIND hrefs of names with spaces, `+`,
`%`, an encoded `/` and non-ASCII characters equal. The reference's cases
(tests/test_webdav.py), imported unchanged, run against the port's gateway
through this module's `dav` fixture; a gateway over a port FilerClient (the
standalone verb's arrangement) answers as one over the in-process filer.
"""

import http.client
import inspect
import re
import urllib.parse

import numpy as np
import pytest
import requests

import test_webdav as ref_cases
import torch_cluster as tc
from seaweedfs_tpu.filer.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.webdav import WebDavServer as RefWebDavServer
from seaweedfs_tpu_torch.client.filer_client import FilerClient
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.webdav import WebDavServer


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("webdav-cluster"),
                 volume_size_limit_mb=64)
    yield c
    tc.stop(c)


def _stack(cluster, filer_cls, dav_cls):
    fs = filer_cls(cluster["master"].address, store_spec="memory",
                   port=tc.free_port_pair(), chunk_size_mb=1).start()
    wd = dav_cls(fs, port=tc.free_port_pair()).start()
    tc.wait_until(lambda: _req(wd.port, "OPTIONS", "/")[0] == 200,
                  msg="webdav up")
    return fs, wd


@pytest.fixture(scope="module")
def gateways(cluster):
    port = _stack(cluster, FilerServer, WebDavServer)
    ref = _stack(cluster, RefFilerServer, RefWebDavServer)
    yield {"port": port, "ref": ref}
    for fs, wd in (port, ref):
        wd.stop()
        fs.stop()


@pytest.fixture(scope="module")
def dav(gateways):
    """The reference cases' fixture: the port's gateway."""
    return f"http://{gateways['port'][1].url}"


def _cases(module):
    return {name: fn for name, fn in vars(module).items()
            if name.startswith("test_") and inspect.isfunction(fn)
            and fn.__module__ == module.__name__}


# the reference's cases, under their own names, bound to this module's
# `dav` fixture
_CASES = _cases(ref_cases)
globals().update(_CASES)


def test_all_reference_cases_are_collected():
    assert len(_CASES) == 10


def _req(port: int, method: str, path: str, body: bytes = b"",
         headers: "dict | None" = None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        c.close()


_DATE = re.compile(rb"[A-Z][a-z]{2}, \d\d [A-Z][a-z]{2} \d{4} "
                   rb"\d\d:\d\d:\d\d GMT")
_TOKEN = re.compile(rb"opaquelocktoken:[0-9a-f-]{36}")


def _mask(body: bytes) -> bytes:
    return _TOKEN.sub(b"opaquelocktoken:T", _DATE.sub(b"DATE", body))


def _sequence(rng):
    """~30 requests of a document share: a tree, files of seeded sizes,
    listings, moves, copies, deletes, locks, and the error answers."""
    files = {f"/dav/t/{d}/f{i}.bin": rng.bytes(int(rng.integers(1, 3 << 20)))
             for d in ("a", "b") for i in range(3)}
    seq = [("OPTIONS", "/", b"", {}),
           ("MKCOL", "/dav", b"", {}), ("MKCOL", "/dav/t", b"", {}),
           ("MKCOL", "/dav/t/a", b"", {}), ("MKCOL", "/dav/t/b", b"", {}),
           ("MKCOL", "/dav/t/a", b"", {})]  # 405 on an existing one
    seq += [("PUT", p, data, {"Content-Type": "application/x-test"})
            for p, data in files.items()]
    seq += [("PUT", "/dav/t/a/f0.bin", b"second version", {}),
            ("GET", "/dav/t/a/f0.bin", b"", {}),
            ("GET", "/dav/t/b/f2.bin", b"", {}),
            ("HEAD", "/dav/t/b/f1.bin", b"", {}),
            ("GET", "/dav/t", b"", {}),
            ("PROPFIND", "/dav/t", b"", {"Depth": "1"}),
            ("PROPFIND", "/dav/t/a", b"", {"Depth": "1"}),
            ("PROPFIND", "/dav/t/b/f1.bin", b"", {"Depth": "0"}),
            ("PROPFIND", "/dav/t/none", b"", {}),
            ("PROPPATCH", "/dav/t/a/f1.bin", b"<x/>", {}),
            ("MOVE", "/dav/t/b", b"", {"Destination": "http://h/dav/t/c"}),
            ("MOVE", "/dav/t/c/f0.bin", b"",
             {"Destination": "http://h/dav/t/a/f1.bin", "Overwrite": "F"}),
            ("MOVE", "/dav/t/c/f0.bin", b"",
             {"Destination": "http://h/dav/t/c/f0.bin"}),
            ("COPY", "/dav/t/a/f1.bin", b"",
             {"Destination": "http://h/dav/t/a/copy.bin"}),
            ("COPY", "/dav/t/a", b"", {"Destination": "http://h/dav/t/a2"}),
            ("GET", "/dav/t/a2/copy.bin", b"", {}),
            ("DELETE", "/dav/t/a/f2.bin", b"", {}),
            ("DELETE", "/dav/t/a/f2.bin", b"", {}),
            ("GET", "/dav/t/a/f2.bin", b"", {}),
            ("LOCK", "/dav/t/a/f1.bin", b"", {}),
            ("UNLOCK", "/dav/t/a/f1.bin", b"", {}),
            ("COPY", "/dav/t/a/f1.bin", b"", {}),  # no Destination: 409
            ("PROPFIND", "/dav/t/a2", b"", {"Depth": "1"}),
            ("PROPFIND", "/dav/t/c", b"", {"Depth": "1"})]
    return seq


def test_differential_sequence_equals_reference(gateways):
    """Every status and masked body equal, every GET's bytes equal."""
    seq = _sequence(np.random.default_rng(19))
    assert len(seq) >= 30
    got = {}
    for name, (_fs, wd) in gateways.items():
        got[name] = [(m, p, *_req(wd.port, m, p, body, headers)[::2])
                     for m, p, body, headers in seq]
    for (m, p, st, body), (_m, _p, rst, rbody) in zip(got["port"],
                                                      got["ref"]):
        assert st == rst, (m, p, st, rst, body[:200], rbody[:200])
        assert _mask(body) == _mask(rbody), (m, p, body[:400], rbody[:400])
    statuses = [st for _m, _p, st, _b in got["port"]]
    assert {201, 204, 207, 404, 405, 409, 412, 403} <= set(statuses)
    # a HEAD states the file's length with no body, as aiohttp's
    heads = {n: _req(wd.port, "HEAD", "/dav/t/a/f1.bin")
             for n, (_fs, wd) in gateways.items()}
    assert [(st, body) for st, _h, body in heads.values()] == \
        [(200, b"")] * 2
    lengths = {n: hd["content-length"] for n, (_s, hd, _b) in heads.items()}
    assert lengths["port"] == lengths["ref"] != "0"


ODD = ["sp ace.txt", "plus+sign.txt", "pct%25lit.txt", "é-ü-名.txt",
       "a%2Fb.txt", "sub/slash.txt"]


def test_odd_names_hrefs_equal_reference(gateways):
    """Names with spaces, `+`, a literal `%`, non-ASCII characters and an
    encoded `/`, PUT percent-encoded: PROPFIND hrefs and displaynames, and
    the GETs, equal in both gateways."""
    out = {}
    for name, (_fs, wd) in gateways.items():
        assert _req(wd.port, "MKCOL", "/odd")[0] == 201
        for n in ODD:
            # quoted whole: the last name's "/" goes as %2F
            st = _req(wd.port, "PUT", "/odd/" + urllib.parse.quote(n, safe=""),
                      n.encode())[0]
            assert st == 201, (name, n, st)
        st, _h, body = _req(wd.port, "PROPFIND", "/odd", b"",
                            {"Depth": "1"})
        gets = [_req(wd.port, "GET", "/odd/" + urllib.parse.quote(n, safe=""))
                for n in ODD]
        out[name] = (st, _mask(body), [(g[0], g[2]) for g in gets])
    assert out["port"] == out["ref"]
    hrefs = re.findall(rb"<D:href>([^<]*)</D:href>", out["port"][1])
    assert len(hrefs) == 1 + len(ODD)  # the collection, 5 files and sub/
    assert [g[0] for g in out["port"][2]] == [200] * len(ODD)


def test_gateway_over_a_filer_client_answers_alike(gateways):
    """The standalone arrangement: a gateway over a port FilerClient of
    the port filer answers a PUT/PROPFIND/GET/MOVE/DELETE run as the
    in-process gateway does."""
    fs, wd = gateways["port"]
    fc = FilerClient(fs.url)
    remote = WebDavServer(fc, port=tc.free_port_pair()).start()
    try:
        answers = []
        for i, port in enumerate((wd.port, remote.port)):
            base = f"/fc{i}"
            run = [("MKCOL", base, b"", {}),
                   ("PUT", f"{base}/x.bin", b"x" * 70000, {}),
                   ("PROPFIND", base, b"", {"Depth": "1"}),
                   ("GET", f"{base}/x.bin", b"", {}),
                   ("MOVE", f"{base}/x.bin", b"",
                    {"Destination": f"http://h{base}/y.bin"}),
                   ("DELETE", f"{base}/y.bin", b"", {}),
                   ("GET", f"{base}/y.bin", b"", {})]
            answers.append([(st, _mask(body).replace(base[1:].encode(),
                                                     b"B"))
                            for st, _h, body in
                            (_req(port, *r) for r in run)])
        assert answers[0] == answers[1]
    finally:
        remote.stop()
        fc.close()


def test_delete_frees_the_needles(gateways, cluster):
    """A DELETE through the gateway removes the file's chunks from the
    volume servers (is_delete_data), as the reference's does."""
    fs, wd = gateways["port"]
    data = np.random.default_rng(5).bytes(3 << 20)
    assert _req(wd.port, "PUT", "/free.bin", data)[0] == 201
    entry = fs.filer.find_entry("/", "free.bin")
    fids = [c.file_id for c in entry.chunks]
    assert len(fids) == 3
    assert _req(wd.port, "DELETE", "/free.bin")[0] == 204

    def gone():
        return all(tc.get(cluster["mc"], f)[0] == 404 for f in fids)
    tc.wait_until(gone, timeout=20, msg="the chunks deleted")


def test_requests_client_sees_multistatus(dav):
    r = requests.request("PROPFIND", f"{dav}/", headers={"Depth": "0"},
                         timeout=5)
    assert r.status_code == 207 and r.reason == "Multi-Status"
