"""The port's replication plane (seaweedfs_tpu_torch/replication/,
geo/replication.py, the AzureSink and GcsSink of remote/) against the JAX
package's, on the CPU.

One seeded event stream (creates, an update, renames of a file and a
directory, deletes) from a port Filer's meta log goes through each
package's Replicator into each sink: LocalSink trees, FilerSink targets
(the port's into a port filer, the reference's into a JAX filer), S3Sink
buckets in the port's gateway, AzureSink containers in the port's
mini_azure and GcsSink buckets in its mini_gcs end equal. FilerSync runs
from a JAX filer into a port filer and back, both ways at once with no
echo, over FilerClients too; a replicated delete frees the target's
needles; its offset resumes from a redis, mongo and etcd target store
with no replay, readable by the reference's FilerSync; failpoints drive
retry and dead-letter; GeoSync's lag gauge, bound and maintenance class
equal the reference's on the same stream.
"""

import os
import threading
import time

import numpy as np
import pytest

import torch_cluster as tc
from test_s3 import IAM_CONFIG

from seaweedfs_tpu import qos as ref_qos
from seaweedfs_tpu.filer.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.geo import replication as ref_geo
from seaweedfs_tpu.remote import azure as ref_azure
from seaweedfs_tpu.remote import gcs as ref_gcs
from seaweedfs_tpu.replication import filer_sync as ref_sync
from seaweedfs_tpu.replication import replicator as ref_replicator
from seaweedfs_tpu.replication import sink as ref_sink
from seaweedfs_tpu.stats import GEO_REPLICATION_LAG as REF_LAG
from seaweedfs_tpu_torch import qos as port_qos
from seaweedfs_tpu_torch.client.filer_client import FilerClient
from seaweedfs_tpu_torch.filer.filer import Filer
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.filer.store import MemoryStore
from seaweedfs_tpu_torch.geo import replication as port_geo
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.remote import azure as port_azure
from seaweedfs_tpu_torch.remote import gcs as port_gcs
from seaweedfs_tpu_torch.replication import filer_sync as port_sync
from seaweedfs_tpu_torch.replication import replicator as port_replicator
from seaweedfs_tpu_torch.replication import sink as port_sink
from seaweedfs_tpu_torch.stats import GEO_REPLICATION_LAG as PORT_LAG
from seaweedfs_tpu_torch.utils import failpoints
from seaweedfs_tpu_torch.utils.mini_azure import MiniAzure
from seaweedfs_tpu_torch.utils.mini_gcs import MiniGcs

PKG = {"ref": dict(replicator=ref_replicator, sink=ref_sink, sync=ref_sync,
                   geo=ref_geo, azure=ref_azure, gcs=ref_gcs, qos=ref_qos,
                   lag=REF_LAG, filer=RefFilerServer),
       "port": dict(replicator=port_replicator, sink=port_sink,
                    sync=port_sync, geo=port_geo, azure=port_azure,
                    gcs=port_gcs, qos=port_qos, lag=PORT_LAG,
                    filer=FilerServer)}


# -- one event stream, every sink --------------------------------------------

def _stream(tmp_path):
    """(directory, EventNotification) pairs of a seeded namespace history,
    file bytes inline in each entry's `content`."""
    rng = np.random.default_rng(19)
    f = Filer(MemoryStore(), str(tmp_path / "events.log"))

    def put(d, name, n):
        e = fpb.Entry(name=name, content=rng.bytes(n))
        e.attributes.file_size = n
        e.attributes.mime = "application/x-test"
        f.create_entry(d, e)

    for d in ("/r/docs", "/r/docs/deep", "/r/img", "/other"):
        put(d, "a.bin", int(rng.integers(1, 5000)))
        put(d, "b bin+%.bin", int(rng.integers(1, 5000)))
    put("/r/docs", "a.bin", 777)                 # an update
    f.rename("/r/docs", "b bin+%.bin", "/r/docs", "c.bin")
    f.rename("/r", "img", "/r", "pics")          # a directory
    f.delete_entry("/r/docs/deep", "a.bin")
    put("/r", "late.bin", 99)
    stop = threading.Event()
    stop.set()
    out = [(r.directory, r.event_notification)
           for r in f.meta_log.subscribe(0, stop)]
    f.meta_log.close()
    return out


def _content(entry) -> bytes:
    return bytes(entry.content)


def _replay(pkg, sink, events, prefix="/r"):
    rep = PKG[pkg]["replicator"].Replicator(sink, _content, prefix)
    for d, ev in events:
        rep.replicate(d, ev)


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for n in files:
            p = os.path.join(d, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_local_sink_trees_equal(tmp_path):
    events = _stream(tmp_path)
    trees = {}
    for pkg in PKG:
        root = tmp_path / pkg
        _replay(pkg, PKG[pkg]["sink"].LocalSink(str(root)), events)
        trees[pkg] = _tree(root)
    assert trees["port"] == trees["ref"]
    assert sorted(trees["port"]) == [
        "r/docs/a.bin", "r/docs/c.bin", "r/docs/deep/b bin+%.bin",
        "r/late.bin", "r/pics/a.bin", "r/pics/b bin+%.bin"]
    assert len(trees["port"]["r/docs/a.bin"]) == 777


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("replication-cluster"),
                 volume_size_limit_mb=64)
    yield c
    tc.stop(c)


def _filer(cls, cluster, store="memory"):
    return cls(cluster["master"].address, store_spec=store,
               port=tc.free_port_pair(), chunk_size_mb=1).start()


def _filer_tree(fs, root="/"):
    """path -> bytes of every file under `root` (directories as None)."""
    out = {}

    def walk(d):
        for e in fs.filer.list_entries(d):
            p = (d.rstrip("/") + "/" + e.name)
            if e.is_directory:
                out[p] = None
                walk(p)
            else:
                out[p] = fs.read_entry_bytes(e)
    walk(root)
    return out


def test_filer_sink_targets_equal(cluster, tmp_path):
    """The port's FilerSink into a port filer, the reference's into a JAX
    filer, under a dir prefix: the two trees are equal."""
    events = _stream(tmp_path)
    trees = {}
    for pkg in PKG:
        fs = _filer(PKG[pkg]["filer"], cluster)
        try:
            _replay(pkg, PKG[pkg]["sink"].FilerSink(fs, "/mirror"), events)
            trees[pkg] = _filer_tree(fs, "/mirror")
        finally:
            fs.stop()
    assert trees["port"] == trees["ref"]
    assert trees["port"]["/mirror/r/docs/a.bin"] is not None
    assert "/mirror/r/img" not in trees["port"]


def test_s3_sink_buckets_equal(cluster, tmp_path):
    """Each package's S3Sink into the port's gateway (signed by the
    admin's key), one bucket each: the same keys and bytes; the port's
    goes over the port's own HTTP client."""
    import requests

    from seaweedfs_tpu_torch.s3.auth import sign_request_v4
    from seaweedfs_tpu_torch.s3.s3_server import S3Gateway
    events = _stream(tmp_path)
    fs = _filer(FilerServer, cluster)
    gw = S3Gateway(fs, port=tc.free_port_pair(), iam_config=IAM_CONFIG).start()
    ep = f"http://{gw.url}"
    ak, sk = "AKIDEXAMPLE", "sEcReT"
    try:
        got = {}
        for pkg in PKG:
            url = f"{ep}/b-{pkg}"
            r = requests.put(url, headers=sign_request_v4("PUT", url, {}, b"",
                                                          ak, sk), timeout=10)
            assert r.status_code == 200
            _replay(pkg, PKG[pkg]["sink"].S3Sink(ep, f"b-{pkg}", ak, sk,
                                                 "pre"), events)
            got[pkg] = {p.split(f"/b-{pkg}/", 1)[1]: b for p, b in
                        _filer_tree(fs, f"/buckets/b-{pkg}").items()
                        if b is not None}
        assert got["port"] == got["ref"]
        assert "pre/r/docs/c.bin" in got["port"]
        assert "pre/r/docs/deep/a.bin" not in got["port"]
    finally:
        gw.stop()
        fs.stop()


@pytest.mark.parametrize("kind", ["azure", "gcs"])
def test_cloud_sinks_equal(kind, tmp_path):
    """AzureSink into the port's mini_azure and GcsSink into its mini_gcs,
    one container or bucket a package: the same keys and bytes."""
    events = _stream(tmp_path)
    srv = (MiniAzure() if kind == "azure" else MiniGcs()).start()
    try:
        got = {}
        for pkg in PKG:
            mod = PKG[pkg][kind]
            if kind == "azure":
                client = mod.parse_azure_spec(
                    f"{srv.endpoint}/c-{pkg}?{srv.account}:{srv.key_b64}")
                sink = mod.AzureSink(client, "pre")
            else:
                client = mod.parse_gcs_spec(f"{srv.endpoint}/b-{pkg}?"
                                            f"{srv.token}")
                sink = mod.GcsSink(client, "pre")
            _replay(pkg, sink, events)
            got[pkg] = {k: client.read_object(k, 0, client.object_size(k))
                        for k in client.list_keys()}
        assert got["port"] == got["ref"]
        assert "pre/r/pics/a.bin" in got["port"]
        assert "pre/r/docs/deep/a.bin" not in got["port"]
    finally:
        srv.stop()


def test_tier_clients_do_not_import_the_replication_plane():
    import subprocess
    import sys
    code = ("import sys\nsys.modules['jax'] = None\n"
            "import seaweedfs_tpu_torch.remote.azure, "
            "seaweedfs_tpu_torch.remote.gcs\n"
            "import seaweedfs_tpu_torch.storage.backend\n"
            "print(sorted(n for n in sys.modules if 'replication' in n))\n"
            "from seaweedfs_tpu_torch.remote.azure import AzureSink\n"
            "from seaweedfs_tpu_torch.remote.gcs import GcsSink\n"
            "print(AzureSink.__name__, GcsSink.__name__, "
            "AzureSink.__mro__[1].__module__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "[]", "AzureSink GcsSink seaweedfs_tpu_torch.replication.sink"]


# -- FilerSync across packages ------------------------------------------------

def _wait_tree(src, dst, root, timeout=30):
    tc.wait_until(lambda: _filer_tree(dst, root) == _filer_tree(src, root),
                  timeout=timeout, msg=f"{root} converged")


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_filer_sync_across_packages(cluster, direction):
    """The port's FilerSync from a JAX filer into a port filer, and from a
    port filer into a JAX filer: creates, an overwrite, a rename and a
    delete converge."""
    ref_fs, port_fs = _filer(RefFilerServer, cluster), _filer(FilerServer,
                                                             cluster)
    src, dst = ((ref_fs, port_fs) if direction == "jax-to-port"
                else (port_fs, ref_fs))
    sync = port_sync.FilerSync(src, dst, from_ns=time.time_ns()).start()
    try:
        rng = np.random.default_rng(3)
        for i in range(4):
            src.write_file(f"/x/f{i}.bin", rng.bytes(int(rng.integers(1, 3e6))))
        src.write_file("/x/f0.bin", b"overwritten")
        src.filer.rename("/x", "f1.bin", "/x", "g1.bin")
        src.filer.delete_entry("/x", "f2.bin")
        _wait_tree(src, dst, "/x")
        assert sync.applied >= 7 and sync.dead_lettered == 0
    finally:
        sync.stop()
        ref_fs.stop()
        port_fs.stop()


def test_bidirectional_sync_settles_without_echo(cluster):
    """JAX filer <-> port filer, one FilerSync each way (the verb without
    -isActivePassive): writes on both sides converge, each echo is
    skipped by the signature guard, and the applied counts then stay put."""
    a, b = _filer(RefFilerServer, cluster), _filer(FilerServer, cluster)
    now = time.time_ns()
    ab = port_sync.FilerSync(a, b, from_ns=now).start()
    ba = port_sync.FilerSync(b, a, from_ns=now).start()
    try:
        a.write_file("/bi/from-jax.bin", b"J" * 5000)
        b.write_file("/bi/from-port.bin", b"P" * 7000)
        a.write_file("/bi/from-jax.bin", b"J2")
        _wait_tree(a, b, "/bi")
        tc.wait_until(lambda: ab.skipped >= 1 and ba.skipped >= 1,
                      msg="both guards skipped an echo")
        settled = (ab.applied, ba.applied, ab.skipped, ba.skipped)
        time.sleep(1.5)
        assert (ab.applied, ba.applied, ab.skipped, ba.skipped) == settled
        assert _filer_tree(a, "/bi") == _filer_tree(b, "/bi") == {
            "/bi/from-jax.bin": b"J2", "/bi/from-port.bin": b"P" * 7000}
    finally:
        ab.stop()
        ba.stop()
        a.stop()
        b.stop()


def test_sync_over_filer_clients_and_delete_frees_needles(cluster):
    """FilerSync between two FilerClients (the verb's arrangement): a
    replicated delete goes through the target's filer with its data, so
    the target's chunks leave the volume servers."""
    a, b = _filer(FilerServer, cluster), _filer(FilerServer, cluster)
    fa, fb = FilerClient(a.url), FilerClient(b.url)
    sync = port_sync.FilerSync(fa, fb, from_ns=time.time_ns()).start()
    try:
        a.write_file("/d/big.bin", np.random.default_rng(1).bytes(3 << 20))
        _wait_tree(a, b, "/d")
        fids = [c.file_id for c in b.filer.find_entry("/d", "big.bin").chunks]
        assert len(fids) == 3
        a.filer.delete_entry("/d", "big.bin")
        tc.wait_until(lambda: b.filer.find_entry("/d", "big.bin") is None,
                      msg="delete replicated")
        tc.wait_until(lambda: all(tc.get(cluster["mc"], f)[0] == 404
                                  for f in fids), timeout=20,
                      msg="the target's chunks deleted")
    finally:
        sync.stop()
        fa.close()
        fb.close()
        a.stop()
        b.stop()


@pytest.fixture(scope="module")
def minis():
    from seaweedfs_tpu_torch.utils.mini_etcd import MiniEtcd
    from seaweedfs_tpu_torch.utils.mini_mongo import MiniMongo
    from seaweedfs_tpu_torch.utils.mini_redis import MiniRedis
    out = {"redis": MiniRedis(port=tc.free_port_pair()).start(),
           "mongo": MiniMongo(port=tc.free_port_pair()).start(),
           "etcd": MiniEtcd(port=tc.free_port_pair()).start()}
    yield out
    for s in out.values():
        s.stop()


@pytest.mark.parametrize("kind", ["redis", "mongo", "etcd"])
def test_offset_resumes_from_the_target_store(cluster, minis, kind):
    """FilerSync keeps its offset in the target's store kv: a sync started
    again on a redis, mongo or etcd target applies only the events after
    the first one's last, with no replay; the reference's FilerSync reads
    the same offset from the same store."""
    a = _filer(FilerServer, cluster)
    b = _filer(FilerServer, cluster, store=f"{kind}:{minis[kind].address}")
    try:
        s1 = port_sync.FilerSync(a, b).start()
        for i in range(3):
            a.write_file(f"/o/{kind}{i}.bin", b"x" * (i + 1))
        # the directory's create and the three files'
        tc.wait_until(lambda: s1.applied == 4, msg="first four applied")
        s1.stop()
        a.write_file(f"/o/{kind}9.bin", b"late")
        s2 = port_sync.FilerSync(a, b)
        ref = ref_sync.FilerSync(a, b)
        assert s2.from_ns == ref.from_ns > 0
        assert s2._offset_key == ref._offset_key
        s2.start()
        tc.wait_until(lambda: b.filer.find_entry("/o", f"{kind}9.bin")
                      is not None, msg="the late file replicated")
        time.sleep(0.5)
        assert (s2.applied, s2.skipped) == (1, 0)
        s2.stop()
    finally:
        a.stop()
        b.stop()


def test_failpoints_drive_retry_and_dead_letter(cluster):
    """The sink's failpoints: a transient create failure is retried and
    lands; a persistent one is dead-lettered after max_retries and the
    stream moves on past it."""
    a, b = _filer(FilerServer, cluster), _filer(FilerServer, cluster)
    sync = port_sync.FilerSync(a, b, from_ns=time.time_ns(), max_retries=3,
                               retry_base_delay=0.02).start()
    try:
        failpoints.configure("replication.sink.create", "times:2:error")
        a.write_file("/fp/retried.bin", b"lands")
        tc.wait_until(lambda: b.filer.find_entry("/fp", "retried.bin")
                      is not None, msg="retried create")
        assert sync.dead_lettered == 0
        failpoints.configure("replication.sink.create", "error")
        a.write_file("/fp/dead.bin", b"never")
        tc.wait_until(lambda: sync.dead_lettered == 1, msg="dead-lettered")
        failpoints.clear("replication.sink.create")
        a.write_file("/fp/after.bin", b"next")
        tc.wait_until(lambda: b.filer.find_entry("/fp", "after.bin")
                      is not None, msg="the stream moved on")
        assert b.filer.find_entry("/fp", "dead.bin") is None
    finally:
        failpoints.clear_all()
        sync.stop()
        a.stop()
        b.stop()


# -- GeoSync -------------------------------------------------------------------

class _MiniFS:
    """A filer stand-in for the sync machinery: a bare Filer of `pkg` (meta
    log, signature, kv store) and a blob dict in place of the volumes."""

    def __init__(self, pkg, path):
        if pkg == "ref":
            from seaweedfs_tpu.filer.filer import Filer as F
            from seaweedfs_tpu.filer.store import MemoryStore as M
            from seaweedfs_tpu.pb import filer_pb2 as pb
        else:
            F, M, pb = Filer, MemoryStore, fpb
        self.pb = pb
        self.filer = F(M(), path)
        self.blobs = {}

    def write_file(self, path, data, mime="", signatures=None):
        d, _, n = path.rpartition("/")
        e = self.pb.Entry(name=n)
        e.attributes.file_size = len(data)
        self.blobs[n] = bytes(data)
        self.filer.create_entry(d or "/", e, signatures=signatures)

    def read_entry_bytes(self, entry):
        return self.blobs.get(entry.name, b"")


def test_geo_sync_lag_bound_and_class_equal_reference(tmp_path):
    """On the same writes: both GeoSyncs replicate under the maintenance
    class, return the lag gauge to 0 after catching up, hold the bound;
    wedged, both report growing lag past a 0.05 s bound; their offset
    keys name the same namespace."""
    seen = {}
    for pkg in PKG:
        m = PKG[pkg]
        a = _MiniFS(pkg, str(tmp_path / f"{pkg}-a.log"))
        b = _MiniFS(pkg, str(tmp_path / f"{pkg}-b.log"))
        sync = m["geo"].GeoSync(a, b, peer=f"west-{pkg}", lag_bound_s=30.0)
        classes = []
        real = sync.replicator.replicate

        def spy(directory, ev, real=real, classes=classes, q=m["qos"]):
            classes.append(q.current_class())
            return real(directory, ev)

        sync.replicator.replicate = spy
        sync.start()
        try:
            for i in range(3):
                a.write_file(f"/geo/f{i}.txt", b"cross the dc" * (i + 1))
            # three files and their directory's create
            tc.wait_until(lambda: sync.applied == 4 and sync.lag_seconds()
                          == 0.0, msg="caught up")
            gauge = m["lag"].value(f"west-{pkg}")
            ok = sync.lag_ok()
        finally:
            sync.stop()
        wedged = m["geo"].GeoSync(a, b, peer=f"wedge-{pkg}",
                                  lag_bound_s=0.05, max_retries=1000,
                                  retry_base_delay=0.02)
        wedged.replicator.replicate = lambda *aa: (_ for _ in ()).throw(
            ConnectionError("link severed"))
        wedged.start()
        try:
            a.write_file("/geo/stuck.txt", b"z")
            tc.wait_until(lambda: wedged.lag_seconds() > 0.05,
                          msg="lag grows while the link is down")
            wedged_ok = wedged.lag_ok()
        finally:
            wedged.stop()
        seen[pkg] = (set(classes), sync.applied, gauge, ok, wedged_ok,
                     sorted(b.blobs), sync._offset_key.split(b".")[:3])
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == {"maintenance"}
    assert seen["port"][2:5] == (0.0, True, False)


class _StoreFS(_MiniFS):
    """_MiniFS over a sqlite store file and a meta log file that outlive
    the object: a filer that can be restarted on its namespace."""

    def __init__(self, pkg, root, tag):
        if pkg == "ref":
            from seaweedfs_tpu.filer.filer import Filer as F
            from seaweedfs_tpu.filer.store import SqliteStore as S
            from seaweedfs_tpu.pb import filer_pb2 as pb
        else:
            from seaweedfs_tpu_torch.filer.store import SqliteStore as S
            F, pb = Filer, fpb
        self.pb = pb
        self.filer = F(S(str(root / f"{tag}.db")), str(root / f"{tag}.log"))
        self.blobs = {}


def test_restarted_source_keeps_its_signature_and_the_sync_resumes(tmp_path):
    """A filer restarted on its store: the reference draws a new signature,
    so a FilerSync started again finds no offset and replays the source's
    whole meta log; the port's filer keeps the store's signature, so the
    sync resumes from its offset and applies only the new event."""
    got = {}
    for pkg in PKG:
        root = tmp_path / pkg
        root.mkdir()
        a, b = _StoreFS(pkg, root, "a"), _MiniFS(pkg, str(root / "b.log"))
        sig = a.filer.signature
        s1 = PKG[pkg]["sync"].FilerSync(a, b).start()
        for i in range(3):
            a.write_file(f"/r/f{i}.bin", b"x" * (i + 1))
        tc.wait_until(lambda: s1.applied >= 4, msg="first events applied")
        s1.stop()
        a.filer.meta_log.close()
        a.filer.store.close()
        a2 = _StoreFS(pkg, root, "a")  # the restart
        a2.blobs = a.blobs
        a2.write_file("/r/late.bin", b"late")
        s2 = PKG[pkg]["sync"].FilerSync(a2, b)
        resumed = s2.from_ns
        s2.start()
        tc.wait_until(lambda: "late.bin" in b.blobs, msg="late file synced")
        time.sleep(0.5)
        s2.stop()
        got[pkg] = (a2.filer.signature == sig, resumed > 0, s2.applied)
        a2.filer.meta_log.close()
        a2.filer.store.close()
    assert got["ref"] == (False, False, 5)  # dir + 3 files again + late
    assert got["port"] == (True, True, 1)
