"""The port's verbs of the client and the volume tools, run as
``python -m seaweedfs_tpu_torch <verb>``: upload and download round-trip
files byte for byte through a cluster of the port alone
(tests/torch_cluster.py, device="cpu"); benchmark writes and reads a small
set; fix's .idx, export's files and compact's .dat/.idx equal what the JAX
package's verbs make of a copy of the same volume; version prints the
reference's version after the port's name. The filer's verbs: a `filer`
daemon over a sqlite store, `filer.copy` of a directory tree and a file,
`filer.cat` of each, `filer.meta.tail` seeing one create a file and one
delete a removal, `filer.meta.backup` holding the filer's entries, and
`server -filer` serving the same verbs. The S3 verbs: `filer -s3 -iam`,
the standalone `s3` and `iam` over a filer with identities from the
filer's /etc (s3.configure, the IAM API) reloaded while they run, and
phase 21 of chip_smoke.py at a small size. The replication verbs:
`webdav` over the filer daemon, `filer.backup` mirroring its tree into a
local directory and resuming from its offset, `filer.sync` both ways and
`geo.sync` one way between port filers, and phase 22 of chip_smoke.py at
a small size."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu import __main__ as ref_main
from seaweedfs_tpu import __version__ as ref_version
from seaweedfs_tpu.storage.volume import rebuild_idx_from_dat as ref_fix
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VID = 5


def _verb(*args, timeout=120):
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=REPO)
    assert r.returncode == 0, (args, r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture
def volume_pair(tmp_path):
    """One port volume with named, plain and deleted needles, and a copy
    of its files: (port dir, reference dir)."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(21)
    v = Volume(str(src), "", VID)
    for k in range(1, 41):
        v.write_needle(Needle(
            id=k, cookie=int(rng.integers(1, 1 << 32)),
            data=rng.bytes(int(rng.integers(1, 3000))),
            name=f"file-{k}.bin".encode() if k % 3 else b""))
    for k in (4, 9, 17, 33):
        v.delete_needle(k)
    v.sync()
    v.close()
    dirs = tmp_path / "port", tmp_path / "ref"
    for d in dirs:
        shutil.copytree(src, d)
    return dirs


def test_version_prints_the_references_version():
    assert _verb("version").strip() == f"seaweedfs-tpu-torch {ref_version}"
    from seaweedfs_tpu_torch import __version__
    assert __version__ == ref_version


def test_usage_lists_the_new_verbs():
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch"],
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode == 2
    for verb in ("upload", "download", "benchmark", "backup",
                 "master.follow", "export", "compact", "version", "fix",
                 "filer", "filer.copy", "filer.cat", "filer.meta.tail",
                 "filer.meta.backup", "s3", "iam"):
        assert verb in r.stderr


def test_fix_rebuilds_the_idx_like_reference(volume_pair):
    port_dir, ref_dir = volume_pair
    for d in volume_pair:
        os.unlink(str(d / f"{VID}.idx"))
    out = _verb("fix", str(port_dir / f"{VID}.dat"))
    n = ref_fix(str(ref_dir / f"{VID}.dat"), str(ref_dir / f"{VID}.idx"))
    assert out.strip() == f"wrote {n} entries to {port_dir / f'{VID}.idx'}"
    assert _sha(str(port_dir / f"{VID}.idx")) == \
        _sha(str(ref_dir / f"{VID}.idx"))
    v = Volume(str(port_dir), "", VID, create_if_missing=False)
    try:
        assert v.read_needle(2, cookie=None).name == b"file-2.bin"
        with pytest.raises(KeyError):
            v.read_needle(4, cookie=None)
    finally:
        v.close()


def test_export_writes_the_references_files(volume_pair, tmp_path,
                                            capsys):
    port_dir, ref_dir = volume_pair
    outs = tmp_path / "out_port", tmp_path / "out_ref"
    said = _verb("export", "-dir", str(port_dir), "-volumeId", str(VID),
                 "-o", str(outs[0]))
    ref_main.run_export(["-dir", str(ref_dir), "-volumeId", str(VID),
                         "-o", str(outs[1])])
    assert said.strip() == capsys.readouterr().out.strip().replace(
        str(outs[1]), str(outs[0]))
    files = [{f: _sha(str(o / f)) for f in sorted(os.listdir(o))}
             for o in outs]
    assert files[0] == files[1] and len(files[0]) == 36


def test_compact_equals_reference(volume_pair, capsys):
    port_dir, ref_dir = volume_pair
    said = _verb("compact", "-dir", str(port_dir), "-volumeId", str(VID))
    ref_main.run_compact(["-dir", str(ref_dir), "-volumeId", str(VID)])
    assert said == capsys.readouterr().out
    for ext in (".dat", ".idx"):
        assert _sha(str(port_dir / f"{VID}{ext}")) == \
            _sha(str(ref_dir / f"{VID}{ext}")), ext


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("cli"), device="cpu")
    try:
        yield c
    finally:
        tc.stop(c)


def test_upload_then_download_round_trip(cluster, tmp_path):
    rng = np.random.default_rng(22)
    paths = []
    for i, ext in enumerate((".bin", ".txt", ".json")):
        p = tmp_path / f"in{i}{ext}"
        p.write_bytes(rng.bytes(int(rng.integers(100, 20000))))
        paths.append(p)
    master = cluster["master"].address
    lines = _verb("upload", "-master", master, "-collection", "cli",
                  *map(str, paths)).splitlines()
    docs = [json.loads(x) for x in lines]
    assert [d["file"] for d in docs] == [str(p) for p in paths]
    assert [d["size"] for d in docs] == [p.stat().st_size for p in paths]
    for d, p in zip(docs, paths):
        out = tmp_path / f"got-{p.name}"
        said = _verb("download", "-master", master, "-o", str(out),
                     d["fid"])
        assert said.strip() == f"{d['fid']} -> {out} ({p.stat().st_size} bytes)"
        assert out.read_bytes() == p.read_bytes()


def test_benchmark_writes_and_reads(cluster):
    out = _verb("benchmark", "-master", cluster["master"].address,
                "-n", "64", "-size", "256", "-c", "4")
    assert "writing 64 x 256B files, concurrency 4, per-needle" in out
    assert "write:" in out and "read:" in out and "errors 0" in out
    for line in out.splitlines():
        if line.strip().startswith(("write:", "read:")):
            assert float(line.split()[1]) > 0


def test_client_verbs_of_chip_smoke_on_cpu(cluster, tmp_path):
    """Phase 17(h)-(j) of chip_smoke.py on the CPU cluster at a small
    size: upload/download round trips, backup of the damaged regular
    volume sha256-equal to its holder's files, benchmark -n 64."""
    import chip_smoke
    res = chip_smoke.client_verbs(np, str(tmp_path), 5, "cpu",
                                  cluster["master"].address,
                                  cluster["dirs"]["r4"], tc.SCRUB_VID,
                                  "scrub", 64)
    assert res["bench_write"][0] > 0 and res["bench_read"][0] > 0


def _spawn(*args, log=None):
    return subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch",
                             *args], cwd=REPO, stdout=log or subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _wait_http(port: int, proc, timeout: float = 60) -> None:
    from seaweedfs_tpu_torch.client import http_util

    def up():
        assert proc.poll() is None, "the daemon exited"
        try:
            return http_util.get(f"http://127.0.0.1:{port}/__status__",
                                 max_attempts=1, timeout=2).status == 200
        except OSError:
            return False
    tc.wait_until(up, timeout=timeout, msg="the filer's HTTP plane")


def _local_tree(root, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    want = {}
    for rel in ("a.txt", "sub/b.bin", "sub/deeper/c.json", "sub/d.bin"):
        p = root / "tree" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(rng.bytes(int(rng.integers(1, 300_000))))
        want[f"/dst/tree/{rel}"] = p.read_bytes()
    single = root / "single.png"
    single.write_bytes(rng.bytes(4321))
    want["/dst/single.png"] = single.read_bytes()
    return want


@pytest.fixture(scope="module")
def filer_verb(cluster, tmp_path_factory):
    """`python -m seaweedfs_tpu_torch filer` over a sqlite store, with
    `filer.meta.tail` following it from before the first write."""
    root = tmp_path_factory.mktemp("filer-verb")
    port = tc.free_port_pair()
    log = open(root / "filer.log", "w")
    proc = _spawn("filer", "-master", cluster["master"].address, "-port",
                  str(port), "-store", f"sqlite:{root}/filer.db", "-maxMB",
                  "1", "-noPeerMeta", log=log)
    tail = None
    try:
        _wait_http(port, proc)
        tail = _spawn("filer.meta.tail", "-filer", f"127.0.0.1:{port}",
                      "-pathPrefix", "/dst")
        import threading
        import time
        tail_lines = []
        threading.Thread(target=lambda: tail_lines.extend(
            iter(lambda: tail.stdout.readline().decode().split(), [])),
            daemon=True).start()
        time.sleep(1.5)
        want = _local_tree(root, 41)
        said = _verb("filer.copy", "-filer", f"127.0.0.1:{port}",
                     str(root / "tree"), str(root / "single.png"), "/dst")
        assert said.strip() == f"copied {len(want)} files to " \
            f"127.0.0.1:{port}/dst"
        yield {"port": port, "proc": proc, "tail_lines": tail_lines,
               "want": want, "root": root}
    finally:
        for p in (tail, proc):
            if p is not None and p.poll() is None:
                p.terminate()
                p.wait(timeout=30)
        log.close()


def test_filer_copy_then_cat(filer_verb):
    """filer.cat prints each copied file byte for byte; a directory and a
    missing path exit 1."""
    addr = f"127.0.0.1:{filer_verb['port']}"
    for path, data in filer_verb["want"].items():
        r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                            "filer.cat", "-filer", addr, path],
                           capture_output=True, timeout=120, cwd=REPO)
        assert r.returncode == 0 and r.stdout == data, path
    for path, why in (("/dst/tree", b"is a directory"),
                      ("/dst/none", b"not found")):
        r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                            "filer.cat", "-filer", addr, path],
                           capture_output=True, timeout=120, cwd=REPO)
        assert r.returncode == 1 and why in r.stderr


def test_filer_meta_tail_sees_each_create_and_delete(filer_verb):
    """filer.meta.tail prints one create a file copied in and one delete
    a file removed, as `<ts> <kind> <path>` lines flushed as they come."""
    from seaweedfs_tpu_torch.client import http_util
    port = filer_verb["port"]
    r = http_util.delete(f"http://127.0.0.1:{port}/dst/tree/a.txt")
    assert r.status == 204
    lines = filer_verb["tail_lines"]
    tc.wait_until(lambda: any(x[1] == "delete" for x in lines), timeout=30,
                  msg="the tail's delete")
    creates = [x[2] for x in lines if x[1] == "create"]
    for path in filer_verb["want"]:
        assert creates.count(path) == 1, path
    assert [x[2] for x in lines if x[1] == "delete"] == ["/dst/tree/a.txt"]
    assert all(int(x[0]) > 0 for x in lines)


def test_filer_meta_backup_holds_the_entries(filer_verb, tmp_path):
    """filer.meta.backup scans the filer into a sqlite store and then
    tails it; the store lists what the filer lists; SIGINT ends it."""
    import signal

    from seaweedfs_tpu_torch.client.filer_client import FilerClient
    from seaweedfs_tpu_torch.filer.store import SqliteStore
    addr = f"127.0.0.1:{filer_verb['port']}"
    db = tmp_path / "backup.db"
    proc = _spawn("filer.meta.backup", "-filer", addr, "-store", str(db))
    out = b""
    try:
        while b"tailing" not in out:
            line = proc.stdout.readline()
            assert line, out
            out += line
        assert b"full scan: " in out
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=30)
    assert proc.returncode == 0

    def listing(lister, d):
        rows = {}
        for e in lister(d):
            path = d.rstrip("/") + "/" + e.name
            rows[path] = (e.is_directory, e.attributes.file_size,
                          [c.file_id for c in e.chunks])
            if e.is_directory:
                rows.update(listing(lister, path))
        return rows

    fc = FilerClient(addr)
    store = SqliteStore(str(db))
    try:
        live = listing(lambda d: fc.filer.list_entries(d), "/")
        assert listing(lambda d: store.list_entries(d), "/") == live
        assert "/dst/tree/sub/deeper/c.json" in live
    finally:
        store.close()
        fc.close()


def _s3_call(port: int, method: str, path: str, body: bytes = b"",
             key=None, service: str = "s3", headers=None):
    """A request to a gateway or IAM API on `port`, signed with `key`
    (access, secret) by the port's SigV4 signer; (status, body)."""
    import http.client

    from seaweedfs_tpu_torch.s3 import auth
    headers = dict(headers or {})
    if key is not None:
        headers = auth.sign_request_v4(method,
                                       f"http://127.0.0.1:{port}{path}",
                                       headers, body, key[0], key[1],
                                       service=service)
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body or None, headers=headers)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _iam_call(port: int, params: dict, key=None):
    import urllib.parse
    return _s3_call(port, "POST", "/",
                    urllib.parse.urlencode(params).encode(), key, "iam",
                    {"Content-Type": "application/x-www-form-urlencoded"})


def test_filer_verb_refuses_s3_and_stops_cleanly(cluster, tmp_path):
    """`filer -s3 -iam` (the gateway once refused) serves S3 and the IAM
    API over the filer, the gateway open until an identity exists; an
    identity the IAM API makes signs an S3 request, and the filer stops
    on SIGTERM with rc 0."""
    import re
    port, s3port, iamport = (tc.free_port_pair() for _ in range(3))
    proc = _spawn("filer", "-master", cluster["master"].address, "-port",
                  str(port), "-store", "memory", "-noPeerMeta", "-s3",
                  "-s3Port", str(s3port), "-iam", "-iamPort", str(iamport))
    try:
        _wait_http(port, proc)
        tc.wait_until(lambda: _s3_call(s3port, "GET", "/")[0] == 200,
                      msg="the open gateway")
        assert _s3_call(s3port, "PUT", "/open")[0] == 200
        assert _iam_call(iamport, {"Action": "CreateUser",
                                   "UserName": "u"})[0] == 200
        assert _iam_call(iamport, {
            "Action": "PutUserPolicy", "UserName": "u", "PolicyName": "p",
            "PolicyDocument": json.dumps({"Statement": [{
                "Effect": "Allow", "Action": ["s3:*"],
                "Resource": ["arn:aws:s3:::*"]}]})})[0] == 200
        st, body = _iam_call(iamport, {"Action": "CreateAccessKey",
                                       "UserName": "u"})
        assert st == 200
        key = (re.search(rb"<AccessKeyId>([^<]*)<", body).group(1).decode(),
               re.search(rb"<SecretAccessKey>([^<]*)<", body).group(1)
               .decode())
        assert _s3_call(s3port, "GET", "/")[0] == 403
        assert _s3_call(s3port, "PUT", "/open/o.bin", b"abc", key)[0] == 200
        assert _s3_call(s3port, "GET", "/open/o.bin", b"", key) == \
            (200, b"abc")
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0].decode()
    assert proc.returncode == 0, out
    assert f"filer 127.0.0.1:{port} (grpc :{port + 10000}" in out
    assert f"s3 127.0.0.1:{s3port} over filer" in out
    assert f"iam 127.0.0.1:{iamport} over filer" in out


def test_s3_and_iam_verbs_over_a_filer(filer_verb, tmp_path):
    """The standalone `s3 -filer` and `iam -filer` over the filer daemon:
    s3.configure (the port's shell) stores an identity in the filer's /etc,
    which the running gateway reloads; the `iam` verb makes a user and key
    that persist there and that the gateway reloads too; `s3 -config`
    takes its identities from a file instead."""
    import re
    import time
    faddr = f"127.0.0.1:{filer_verb['port']}"
    s3port, iamport, cfgport = (tc.free_port_pair() for _ in range(3))
    cfg = tmp_path / "ids.json"
    cfg.write_text(json.dumps({"identities": [{
        "name": "f", "credentials": [{"accessKey": "FILEKEY",
                                      "secretKey": "filesecret"}],
        "actions": ["Admin"]}]}))
    procs = [_spawn("s3", "-filer", faddr, "-port", str(s3port)),
             _spawn("iam", "-filer", faddr, "-port", str(iamport)),
             _spawn("s3", "-filer", faddr, "-port", str(cfgport), "-config",
                    str(cfg))]
    admin = ("CLIADMIN", "cli-admin-secret")
    try:
        for port in (s3port, cfgport):
            tc.wait_until(lambda port=port: _s3_call(port, "GET", "/")[0]
                          in (200, 403), msg="the s3 verb")
        assert _s3_call(cfgport, "GET", "/")[0] == 403
        assert _s3_call(cfgport, "GET", "/", key=("FILEKEY",
                                                  "filesecret"))[0] == 200
        said = _verb("shell", "-master", "127.0.0.1:1", "-c",
                     f"s3.configure -filer {faddr} -user admin "
                     f"-access_key {admin[0]} -secret_key {admin[1]} "
                     "-actions Admin -apply")
        assert "saved /etc/iam/identity.json" in said
        tc.wait_until(lambda: _s3_call(s3port, "GET", "/")[0] == 403
                      and _s3_call(s3port, "GET", "/", key=admin)[0] == 200,
                      timeout=30, msg="the gateway to reload identity.json")
        # the iam verb read the filer's identities at its start, before
        # s3.configure wrote them: restart it so it holds them
        procs[1].terminate()
        procs[1].wait(timeout=30)
        procs[1] = _spawn("iam", "-filer", faddr, "-port", str(iamport))
        tc.wait_until(lambda: _iam_call(iamport, {"Action": "ListUsers"},
                                        admin)[0] == 200, timeout=30,
                      msg="the iam verb")
        assert _iam_call(iamport, {"Action": "ListUsers"})[0] == 403
        assert _iam_call(iamport, {"Action": "CreateUser", "UserName": "w"},
                         admin)[0] == 200
        assert _iam_call(iamport, {
            "Action": "PutUserPolicy", "UserName": "w", "PolicyName": "p",
            "PolicyDocument": json.dumps({"Statement": [{
                "Effect": "Allow", "Action": ["s3:Put*", "s3:Get*"],
                "Resource": ["arn:aws:s3:::vb/*"]}]})}, admin)[0] == 200
        st, body = _iam_call(iamport, {"Action": "CreateAccessKey",
                                       "UserName": "w"}, admin)
        assert st == 200
        key = (re.search(rb"<AccessKeyId>([^<]*)<", body).group(1).decode(),
               re.search(rb"<SecretAccessKey>([^<]*)<", body).group(1)
               .decode())
        assert _s3_call(s3port, "PUT", "/vb", key=admin)[0] == 200
        t = time.monotonic()
        tc.wait_until(lambda: _s3_call(s3port, "PUT", "/vb/o.bin", b"xyz",
                                       key)[0] == 200, timeout=30,
                      msg="the gateway to reload the iam verb's key")
        assert time.monotonic() - t < 30
        assert _s3_call(s3port, "GET", "/vb/o.bin", key=key) == (200, b"xyz")
        assert _s3_call(s3port, "PUT", "/other", key=key)[0] == 403
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0, 0, 0]


def test_server_verb_with_a_filer_serves_the_filer_verbs(tmp_path):
    """`server -filer -device cpu`: filer.copy into it and filer.cat out
    of it, byte for byte."""
    port, vport, fport = (tc.free_port_pair(), tc.free_port_pair(),
                          tc.free_port_pair())
    proc = _spawn("server", "-device", "cpu", "-dir", str(tmp_path / "d"),
                  "-port", str(port), "-volumePort", str(vport), "-filer",
                  "-filerPort", str(fport))
    try:
        _wait_http(fport, proc, timeout=90)
        src = tmp_path / "one.bin"
        src.write_bytes(np.random.default_rng(6).bytes(123_456))
        import time
        deadline = time.monotonic() + 60
        while True:  # the volume server's first heartbeat makes it writable
            r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                                "filer.copy", "-filer", f"127.0.0.1:{fport}",
                                str(src), "/s"], capture_output=True,
                               timeout=120, cwd=REPO)
            if r.returncode == 0 or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        assert r.returncode == 0, r.stderr[-2000:]
        r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                            "filer.cat", "-filer", f"127.0.0.1:{fport}",
                            "/s/one.bin"], capture_output=True, timeout=120,
                           cwd=REPO)
        assert r.returncode == 0 and r.stdout == src.read_bytes()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_s3_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """Phase 21 of chip_smoke.py on the CPU at a small size (two objects
    of 6 MiB by multipart in 3 MiB parts at -maxMB 1, so the parts stream;
    3 MiB signed and 2 MiB aws-chunked PUTs; 24 small objects; a 1 MB
    chunk cache, so the reads go to the servers; 16 KiB EC small blocks): every step's checks hold, the reads with r1 lost
    reconstruct, one K1 one-stripe call each, and the restarted filer+S3
    process serves the same listing to the same keys."""
    import chip_smoke
    import torch
    res = chip_smoke.s3_round_trip(np, torch, str(tmp_path), 9, "cpu", 2, 6,
                                   3, 2, 3, 2, 24, 4, 4, max_mb=1,
                                   cache_mb=1, device="cpu",
                                   small_block=1 << 14)
    assert res["reconstructs"] == len(res["widths"]) > 0
    assert res["multipart"] > 0 and res["restart"] > 0


def test_usage_lists_the_replication_verbs():
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch"],
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode == 2
    for verb in ("webdav", "filer.backup", "filer.sync", "geo.sync",
                 "filer.replicate", "mq.broker"):
        assert verb in r.stderr


@pytest.mark.parametrize("verb", ["mq.broker", "filer.replicate"])
def test_queue_verbs_take_the_references_flags(verb):
    """`mq.broker` and `filer.replicate` take exactly the reference's flags
    (those its run_* source adds, against the port's -h)."""
    import inspect
    import re

    from seaweedfs_tpu import __main__ as ref_cli
    fn = {"mq.broker": ref_cli.run_mq_broker,
          "filer.replicate": ref_cli.run_filer_replicate}[verb]
    ref_flags = re.findall(r'add_argument\("(-\w+)"', inspect.getsource(fn))
    assert ref_flags
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", verb,
                        "-h"], capture_output=True, text=True, timeout=60,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr
    got = set(re.findall(r"^  (-\w+)", r.stdout, re.M)) - {"-h"}
    assert got == set(ref_flags)


def _dav(port: int, method: str, path: str, body: bytes = b"",
         headers=None):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _stop(proc, sig=None) -> str:
    import signal
    proc.send_signal(sig or signal.SIGTERM)
    out = proc.communicate(timeout=30)[0]
    assert proc.returncode == 0, out
    return out.decode() if isinstance(out, bytes) else out


def _live(filer_verb) -> dict:
    """The copied files the filer still holds (another case of this module
    deletes one) with their bytes."""
    from seaweedfs_tpu_torch.client.filer_client import FilerClient
    fc = FilerClient(f"127.0.0.1:{filer_verb['port']}")
    try:
        return {p: d for p, d in filer_verb["want"].items()
                if fc.filer.find_entry(*p.rsplit("/", 1)) is not None}
    finally:
        fc.close()


def test_webdav_verb_over_the_filer_daemon(filer_verb):
    """`webdav -filer` serves the filer daemon's tree through a FilerClient:
    PROPFIND lists the copied tree, GETs return the copied bytes, a PUT
    reads back through filer.cat; SIGTERM ends it with rc 0."""
    import re
    import time
    addr = f"127.0.0.1:{filer_verb['port']}"
    port = tc.free_port_pair()
    proc = _spawn("webdav", "-filer", addr, "-port", str(port))
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None
            try:
                if _dav(port, "OPTIONS", "/")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline
            time.sleep(0.2)
        st, body = _dav(port, "PROPFIND", "/dst/tree/sub", headers={
            "Depth": "1"})
        assert st == 207
        hrefs = re.findall(rb"<D:href>([^<]*)</D:href>", body)
        assert hrefs == [b"/dst/tree/sub/", b"/dst/tree/sub/b.bin",
                         b"/dst/tree/sub/d.bin", b"/dst/tree/sub/deeper/"]
        live = _live(filer_verb)
        assert len(live) >= len(filer_verb["want"]) - 1
        for path, data in live.items():
            assert _dav(port, "GET", path) == (200, data)
        assert _dav(port, "PUT", "/dav-put/n.txt", b"through webdav")[0] \
            == 201
        assert _verb("filer.cat", "-filer", addr, "/dav-put/n.txt") == \
            "through webdav"
    finally:
        out = _stop(proc)
    assert f"webdav 127.0.0.1:{port} over filer {addr}" in out


def test_filer_backup_verb_mirrors_and_resumes(filer_verb, tmp_path):
    """`filer.backup -path /dst` mirrors the copied tree into a local
    directory byte for byte; started again after a new file, it resumes
    from the offset in the filer's kv and adds just that file."""
    import signal
    import time
    addr = f"127.0.0.1:{filer_verb['port']}"
    mirror = tmp_path / "mirror"

    def local():
        return {"/" + os.path.relpath(os.path.join(d, n), mirror): open(
            os.path.join(d, n), "rb").read()
            for d, _ds, ns in os.walk(mirror) for n in ns}

    want = _live(filer_verb)
    proc = _spawn("filer.backup", "-filer", addr, "-dir", str(mirror),
                  "-path", "/dst")
    try:
        tc.wait_until(lambda: local() == want, timeout=60,
                      msg="the mirror equals the filer's /dst")
    finally:
        _stop(proc, signal.SIGINT)
    src = tmp_path / "late.bin"
    src.write_bytes(b"late file")
    _verb("filer.copy", "-filer", addr, str(src), "/dst")
    want["/dst/late.bin"] = b"late file"
    t0 = time.time()
    proc = _spawn("filer.backup", "-filer", addr, "-dir", str(mirror),
                  "-path", "/dst")
    try:
        tc.wait_until(lambda: local() == want, timeout=60,
                      msg="the resumed mirror gains the late file")
        first = proc.stdout.readline().decode()
        assert "(since 0)" not in first and "backing up" in first
    finally:
        _stop(proc, signal.SIGINT)
    # the resumed run rewrote only the late file
    assert [p for p in want if os.path.getmtime(
        str(mirror) + p) >= t0] == ["/dst/late.bin"]


def test_filer_sync_and_geo_sync_verbs(cluster, tmp_path):
    """`filer.sync -a A -b B` (both ways) and `geo.sync -a A -b C
    -isActivePassive -path /g -lagBound 30` between port filers: B gets
    A's writes and A gets B's, with no echo; C gets A's /g only."""
    import time

    from seaweedfs_tpu_torch.filer.filer_server import FilerServer
    fss = [FilerServer(cluster["master"].address, store_spec="memory",
                       port=tc.free_port_pair(), chunk_size_mb=1).start()
           for _ in range(3)]
    a, b, c = fss
    procs = [_spawn("filer.sync", "-a", a.url, "-b", b.url),
             _spawn("geo.sync", "-a", a.url, "-b", c.url, "-isActivePassive",
                    "-path", "/g", "-lagBound", "30")]
    try:
        firsts = [p.stdout.readline().decode() for p in procs]
        assert firsts[0].startswith(f"syncing {a.url} -> {b.url}")
        assert firsts[1] == f"geo-replicating {a.url} -> {c.url} under /g " \
            "(lag bound 30.0s)\n"
        a.write_file("/s/from-a.bin", b"A" * 3000)
        b.write_file("/s/from-b.bin", b"B" * 4000)
        a.write_file("/g/geo.bin", b"G" * 5000)

        def tree(fs, d):
            return {e.name: fs.read_entry_bytes(e)
                    for e in fs.filer.list_entries(d) if not e.is_directory}
        want = {"from-a.bin": b"A" * 3000, "from-b.bin": b"B" * 4000}
        tc.wait_until(lambda: tree(a, "/s") == tree(b, "/s") == want,
                      timeout=60, msg="filer.sync both ways")
        tc.wait_until(lambda: tree(c, "/g") == {"geo.bin": b"G" * 5000},
                      timeout=60, msg="geo.sync of /g")
        time.sleep(1.0)
        assert c.filer.find_entry("/", "s") is None
        assert tree(a, "/s") == tree(b, "/s") == want
    finally:
        outs = [_stop(p) for p in procs]
        for fs in fss:
            fs.stop()
    assert f"syncing {b.url} -> {a.url}" in outs[0]  # not -isActivePassive


def test_replication_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """Phase 22 of chip_smoke.py on the CPU at a small size (16 WebDAV PUTs
    of 4 KiB-1 MiB and two of 2 MiB at -maxMB 1; a 1 MB chunk cache, so
    the reads go to the servers; 16 KiB EC small blocks): every step's
    checks hold, the reads with r1 lost reconstruct, one K1 one-stripe call
    each, and after the restarts B gains only the new file's events."""
    import chip_smoke
    import torch
    res = chip_smoke.replication_round_trip(np, torch, str(tmp_path), 9,
                                            "cpu", 16, 2, 2, max_mb=1,
                                            cache_mb=1, device="cpu",
                                            small_block=1 << 14)
    assert res["reconstructs"] == len(res["widths"]) > 0
    assert res["put"] > 0 and res["catch_up_s"] > 0 and res["restart"] > 0


# -- the last nine verbs: remote mounts, mount and fuse, ftp, scaffold,
# update, autocomplete and unautocomplete ----------------------------------
def test_verbs_and_shell_commands_equal_the_references():
    import subprocess as sp
    from seaweedfs_tpu_torch import __main__ as port_main
    assert set(port_main.VERBS) == set(ref_main.VERBS)
    assert len(port_main.VERBS) == 35
    code = ("import importlib, sys; pkg = sys.argv[1]; [importlib.import_"
            "module(f'{pkg}.shell.{m}') for m in ('ec_commands', "
            "'fs_commands', 'lifecycle_commands', 'mq_commands', "
            "'qos_commands', 'remote_commands', 'telemetry_commands', "
            "'volume_commands')]; c = importlib.import_module(f'{pkg}.shell."
            "commands'); print(sorted(c.COMMANDS))")
    names = [sp.run([sys.executable, "-c", code, pkg], capture_output=True,
                    text=True, timeout=120, cwd=REPO).stdout
             for pkg in ("seaweedfs_tpu_torch", "seaweedfs_tpu")]
    assert names[0] == names[1] and "remote.mount.buckets" in names[0]


def test_usage_lists_the_last_verbs():
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch"],
                       capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode == 2
    for verb in ("mount", "fuse", "filer.remote.sync",
                 "filer.remote.gateway", "ftp", "scaffold", "update",
                 "autocomplete", "unautocomplete"):
        assert verb in r.stderr


def test_scaffold_prints_and_writes_the_references_templates(tmp_path):
    from seaweedfs_tpu.utils import scaffold as ref_scaffold
    from seaweedfs_tpu_torch.utils import scaffold
    assert scaffold.TEMPLATES == ref_scaffold.TEMPLATES
    for name, body in scaffold.TEMPLATES.items():
        assert _verb("scaffold", "-config", name) == body + "\n"
    out = _verb("scaffold", "-config", "filer", "-output", str(tmp_path))
    assert out.strip() == f"wrote {tmp_path}/filer.toml"
    assert (tmp_path / "filer.toml").read_text() == \
        ref_scaffold.TEMPLATES["filer"]
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                        "scaffold", "-config", "nope"], capture_output=True,
                       text=True, timeout=60, cwd=REPO)
    assert r.returncode == 1 and "unknown config 'nope'" in r.stdout


def test_update_prints_and_downloads_nothing():
    assert _verb("update").strip() == (
        "update: this is a source installation; update with `git pull` in "
        "the repository checkout")


def test_autocomplete_install_remove_under_a_temporary_home(tmp_path):
    """The same line as the reference's, once; unautocomplete removes only
    it. Both write only the temporary HOME's .bashrc."""
    from seaweedfs_tpu_torch import __main__ as port_main
    home = tmp_path / "home"
    home.mkdir()
    (home / ".bashrc").write_text("export KEEP=1\n")
    env = {**os.environ, "HOME": str(home)}

    def run(verb):
        r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                            verb], capture_output=True, text=True,
                           timeout=60, cwd=REPO, env=env)
        assert r.returncode == 0, r.stderr
        return r.stdout.strip()

    assert run("autocomplete").startswith("bash completion installed")
    assert run("autocomplete") == "autocomplete already installed"
    lines = (home / ".bashrc").read_text().splitlines()
    assert lines[0] == "export KEEP=1" and len(lines) == 2
    assert lines[1] == (f'complete -W "{" ".join(sorted(ref_main.VERBS))}" '
                        f"-o default swtpu {ref_main.AUTOCOMPLETE_MARK}")
    assert port_main.AUTOCOMPLETE_MARK == ref_main.AUTOCOMPLETE_MARK
    assert run("unautocomplete") == "bash completion removed"
    assert (home / ".bashrc").read_text() == "export KEEP=1\n"
    assert run("unautocomplete") == "nothing to remove"
    assert sorted(p.name for p in home.iterdir()) == [".bashrc"]


def test_mount_and_fuse_verbs_serve_weedfs_without_a_mount(filer_verb,
                                                          tmp_path,
                                                          monkeypatch):
    """`mount` builds WeedFS over a FilerClient with the control socket up,
    and hands it to fuse_loop (replaced here by a stand-in, so nothing is
    mounted): the stand-in reads the filer's files through the handlers,
    writes one, and sets a quota with the shell's mount.configure, which
    statfs then shows. `fuse -o` maps its options onto mount's flags."""
    import io

    from seaweedfs_tpu_torch import __main__ as port_main
    from seaweedfs_tpu_torch.mount import fuse_binding
    from seaweedfs_tpu_torch.mount.control import mount_socket_path
    from seaweedfs_tpu_torch.shell import remote_commands  # noqa: F401
    from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
    mnt = str(tmp_path / "mnt")
    live = _live(filer_verb)
    seen = {}

    def fake_loop(wfs, mountpoint, allow_other=False, **kw):
        seen["args"] = (mountpoint, allow_other, wfs.chunk_size)
        for path, data in live.items():
            fh = wfs.open(path)
            seen[path] = wfs.read(fh, 0, len(data) + 1) == data
            wfs.release(fh)
        fh = wfs.create("/dst/from-mount.bin")
        wfs.write(fh, 0, b"written by the mount verb")
        wfs.release(fh)
        env = CommandEnv.__new__(CommandEnv)
        env.out, env.option = io.StringIO(), {}
        run_command(env, f"mount.configure -dir {mountpoint} -quotaMB 48")
        seen["said"] = env.out.getvalue()
        seen["statfs"] = wfs.statfs()["f_blocks"]
        return 0

    monkeypatch.setattr(fuse_binding, "fuse_loop", fake_loop)
    port = filer_verb["port"]
    assert port_main.main(["mount", "-filer", f"127.0.0.1:{port}", "-dir",
                           mnt, "-chunkSizeLimitMB", "2"]) == 0
    assert seen["args"] == (mnt, False, 2 << 20)
    assert all(seen[p] for p in live)
    assert seen["said"].strip() == f"{mnt}: collection capacity 48 MB"
    assert seen["statfs"] == 24
    assert not os.path.exists(mount_socket_path(mnt))  # stopped with it
    assert _verb("filer.cat", "-filer", f"127.0.0.1:{port}",
                 "/dst/from-mount.bin") == "written by the mount verb"
    assert port_main._fuse_mount_args(mnt, "filer=h:1,chunkSizeLimitMB=8,"
                                      "allowOthers") == [
        "-dir", mnt, "-filer", "h:1", "-chunkSizeLimitMB", "8",
        "-allowOther"]
    assert port_main._fuse_mount_args(mnt, "") == [
        "-dir", mnt, "-filer", "127.0.0.1:8888"]


def _ready(proc, word: bytes, timeout: float = 60) -> None:
    import select
    import time
    deadline = time.monotonic() + timeout
    buf = b""
    while word not in buf:
        left = deadline - time.monotonic()
        assert left > 0 and proc.poll() is None, buf[-2000:]
        if select.select([proc.stdout], [], [], left)[0]:
            buf += os.read(proc.stdout.fileno(), 1 << 16)


def test_filer_remote_sync_and_gateway_verbs(filer_verb, tmp_path):
    """`filer.remote.sync` writes a local create under a remote mount back
    to the remote and removes it on a delete; `filer.remote.gateway`
    creates a bucket on the remote when /buckets/<b> is made, mounts it,
    writes its files back, and deletes the bucket with the directory."""
    from seaweedfs_tpu_torch.client.filer_client import FilerClient
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.remote import mount_remote
    from seaweedfs_tpu_torch.remote.remote_mount import _load_mappings
    addr = f"127.0.0.1:{filer_verb['port']}"
    cloud = tmp_path / "cloud"
    (cloud / "data").mkdir(parents=True)
    (cloud / "data" / "seed.txt").write_bytes(b"seeded")
    buckets = tmp_path / "buckets"
    buckets.mkdir()
    fc = FilerClient(addr)
    procs = []
    try:
        mount_remote(fc, "/clouddata", f"local:{cloud}/data")
        procs.append(_spawn("filer.remote.sync", "-filer", addr, "-dir",
                            "/clouddata"))
        _ready(procs[-1], b"remote-sync watching")
        procs.append(_spawn("filer.remote.gateway", "-filer", addr,
                            "-createBucketAt", f"local:{buckets}"))
        _ready(procs[-1], b"remote-gateway:")
        fc.write_file("/clouddata/new.txt", b"written locally")
        fc.filer.create_entry("/buckets", fpb.Entry(name="bk1",
                                                    is_directory=True))
        tc.wait_until(lambda: (cloud / "data" / "new.txt").exists() and
                      (buckets / "bk1").is_dir(), timeout=30,
                      msg="the write-back and the bucket")
        assert (cloud / "data" / "new.txt").read_bytes() == b"written locally"
        tc.wait_until(lambda: "/buckets/bk1" in _load_mappings(fc),
                      timeout=30, msg="the bucket's mapping")
        fc.write_file("/buckets/bk1/obj.bin", b"into the bucket")
        tc.wait_until(lambda: (buckets / "bk1" / "obj.bin").exists(),
                      timeout=30, msg="the bucket's object")
        fc.filer.delete_entry("/clouddata", "new.txt")
        fc.filer.delete_entry("/buckets", "bk1", is_recursive=True)
        tc.wait_until(lambda: not (cloud / "data" / "new.txt").exists()
                      and not (buckets / "bk1").exists(), timeout=30,
                      msg="the remote delete and the bucket's")
        assert (cloud / "data" / "seed.txt").read_bytes() == b"seeded"
    finally:
        outs = [_stop(p) for p in procs]
        from seaweedfs_tpu_torch.remote import unmount_remote
        unmount_remote(fc, "/clouddata")
        fc.close()
    assert "upload new.txt" in outs[0] and "delete new.txt" in outs[0]
    assert "created bucket bk1" in outs[1] and "deleted bucket bk1" in outs[1]


def test_ftp_verb_over_the_filer_daemon(filer_verb):
    """`ftp -filer` serves the filer daemon's tree: RETR of every copied
    file equal, a STOR read back through filer.cat, LIST equal to the
    filer's listing; SIGTERM ends it with rc 0."""
    import ftplib
    import io
    port = tc.free_port_pair()
    addr = f"127.0.0.1:{filer_verb['port']}"
    proc = _spawn("ftp", "-filer", addr, "-port", str(port))
    try:
        _ready(proc, b"ftp 127.0.0.1:")
        c = ftplib.FTP()
        c.connect("127.0.0.1", port, timeout=30)
        c.login()
        live = _live(filer_verb)
        for path, data in live.items():
            buf = io.BytesIO()
            c.retrbinary(f"RETR {path}", buf.write)
            assert buf.getvalue() == data
        c.storbinary("STOR /dst/by-ftp.bin", io.BytesIO(b"ftp bytes" * 999))
        lines = []
        c.retrlines("LIST /dst", lines.append)
        c.quit()
    finally:
        _stop(proc)
    from seaweedfs_tpu_torch.client.filer_client import FilerClient
    fc = FilerClient(addr)
    try:
        want = sorted((e.name, e.is_directory, e.attributes.file_size)
                      for e in fc.filer.list_entries("/dst"))
    finally:
        fc.close()
    assert sorted((ln.split()[-1], ln[0] == "d",
                   0 if ln[0] == "d" else int(ln.split()[4]))
                  for ln in lines) == [
        (n, d, 0 if d else size) for n, d, size in want]
    assert ("by-ftp.bin", False, 8991) in want
    assert _verb("filer.cat", "-filer", addr, "/dst/by-ftp.bin") == \
        "ftp bytes" * 999
