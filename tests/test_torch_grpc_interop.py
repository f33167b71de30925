"""A mixed cluster over gRPC: the JAX package's MasterServer, one of its
VolumeServers and two of the port's volume servers behind
seaweedfs_tpu_torch/server/grpc_service.py (device="cpu"). The flow of
tests/test_cluster.py::test_ec_encode_spread_and_degraded_read, driven by
the reference's Stub and operation.submit: an EC volume spread over JAX and
port servers, healthy and degraded reads on every server (the port's fetch
shards from the JAX server, the JAX server's from the port's), the JAX
shell's ec.rebuild run on a port server and volume.scrub on a port server's
volume, and the CLI verb `python -m seaweedfs_tpu_torch volume -device cpu`
registering with the JAX master and serving a GET. Then the replicated data
plane: a "001" volume over the JAX server and a port server written by
operation.submit and submit_batch, read from both holders, through
read_batch on the port server and by proxy on the server with no copy,
deletes fanned out both ways; and a port server joining a master started
with a signing key (the gRPC cluster key and the write tokens). Last, the
control plane both ways: a JAX volume server joins the port's master and
is read through it, the JAX shell's ec.encode and ec.rebuild drive the
port's master, and the port's shell encodes and decodes on the JAX
master."""

import hashlib
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import requests

from conftest import free_port_pair, wait_cluster_up, wait_until
from seaweedfs_tpu.client import operation
from seaweedfs_tpu.client.master_client import MasterClient
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
from seaweedfs_tpu.master.master_server import MasterServer
from seaweedfs_tpu.pb import volume_server_pb2 as vpb
from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
from seaweedfs_tpu.shell import ec_commands, volume_commands  # noqa: F401 (register)
from seaweedfs_tpu.shell.commands import CommandEnv, run_command
from seaweedfs_tpu.storage.disk_location import DiskLocation as RefLocation
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu.utils.rpc import VOLUME_SERVICE, Stub
from seaweedfs_tpu_torch.ec import files
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.server.grpc_service import GrpcPeers, serve_volume
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import file_id
from seaweedfs_tpu_torch.utils import retry

REPO = pathlib.Path(__file__).resolve().parents[1]
D, P, LB, SB = 4, 2, 1 << 20, 1 << 14


class _RecordingPeers(GrpcPeers):
    """GrpcPeers that records which address each shard read went to."""

    def __init__(self, master):
        super().__init__(master)
        self.reads = []

    def read_shard(self, addr, vid, sid, offset, size):
        self.reads.append(addr)
        return super().read_shard(addr, vid, sid, offset, size)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    retry.reset_breakers()
    mport = free_port_pair()
    maddr = f"127.0.0.1:{mport}"
    master = MasterServer(port=mport, volume_size_limit_mb=64,
                          pulse_seconds=0.5)
    master.start()
    ref = served = None
    try:
        d = tmp_path_factory.mktemp("jax_vs")
        port = free_port_pair()
        store = RefStore("127.0.0.1", port, f"127.0.0.1:{port}",
                         [RefLocation(str(d), max_volume_count=10)],
                         ec_geometry=RefGeometry(D, P, large_block=LB,
                                                 small_block=SB),
                         coder_name="numpy")
        ref = RefServer(store, maddr, port=port, grpc_port=port + 10000,
                        pulse_seconds=0.5, rack="rack0")
        ref.start()
        served = []
        for i in (1, 2):
            d = tmp_path_factory.mktemp(f"port_vs{i}")
            port = free_port_pair()
            store = Store("127.0.0.1", port, f"127.0.0.1:{port}",
                          [DiskLocation(str(d), max_volume_count=10)],
                          ec_geometry=EcGeometry(D, P, large_block=LB,
                                                 small_block=SB),
                          coder_name="torch", device="cpu")
            # the first port server shares the JAX server's rack, so a
            # "001" volume spans the two; the second holds no copy
            vs = VolumeServer(store, "127.0.0.1", port,
                              rack="rack0" if i == 1 else "rack2",
                              pulse_seconds=0.5,
                              peers=_RecordingPeers(maddr))
            served.append(serve_volume(vs, port + 10000, master=maddr))
        servers = [ref] + [s.vs for s in served]
        wait_cluster_up(master, servers, timeout=20)
        mc = MasterClient(maddr).start()
        try:
            yield master, maddr, ref, [s.vs for s in served], mc
        finally:
            mc.stop()
    finally:
        for s in served or ():
            s.stop()
        if ref is not None:
            ref.stop()
        master.stop()
        retry.reset_breakers()


def _grpc(vs) -> str:
    return f"127.0.0.1:{vs.grpc_port}"


def _call(vs, method, req, resp_cls, timeout=60):
    return Stub(_grpc(vs), VOLUME_SERVICE).call(method, req, resp_cls,
                                                timeout=timeout)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _base(vs, vid, collection):
    return vs.store.locations[0].base_name(collection, vid)


def test_mixed_cluster_ec_spread_degraded_reads_and_shell_rebuild(cluster):
    master, maddr, ref, (p1, p2), mc = cluster
    rng = np.random.default_rng(1)
    blobs = {}
    for _ in range(30):
        data = rng.integers(0, 256, int(rng.integers(100, 20000)),
                            dtype=np.uint8).tobytes()
        blobs[operation.submit(mc, data, collection="ecol").fid] = data
    vid = int(next(iter(blobs)).split(",")[0])
    assert all(int(f.split(",")[0]) == vid for f in blobs)
    servers = (ref, p1, p2)
    src = next(vs for vs in servers if vs.store.find_volume(vid) is not None)
    _call(src, "VolumeMarkReadonly",
          vpb.VolumeMarkReadonlyRequest(volume_id=vid),
          vpb.VolumeMarkReadonlyResponse)
    _call(src, "VolumeEcShardsGenerate",
          vpb.VolumeEcShardsGenerateRequest(volume_id=vid, collection="ecol"),
          vpb.VolumeEcShardsGenerateResponse, timeout=120)
    sealed = {s: _sha(_base(src, vid, "ecol") + files.shard_ext(s))
              for s in range(D + P)}

    # the spread: the first port server holds 0-2, the JAX server 3-4, the
    # second port server 5
    spread = {p1: [0, 1, 2], ref: [3, 4], p2: [5]}
    for vs, sids in spread.items():
        if vs is not src:
            _call(vs, "VolumeEcShardsCopy", vpb.VolumeEcShardsCopyRequest(
                volume_id=vid, collection="ecol", shard_ids=sids,
                copy_ecx_file=True, copy_vif_file=True, copy_ecj_file=True,
                source_data_node=_grpc(src)), vpb.VolumeEcShardsCopyResponse)
        _call(vs, "VolumeEcShardsMount", vpb.VolumeEcShardsMountRequest(
            volume_id=vid, collection="ecol"), vpb.VolumeEcShardsMountResponse)
    _call(src, "VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection="ecol",
        shard_ids=[s for s in range(D + P) if s not in spread[src]]),
        vpb.VolumeEcShardsDeleteResponse)
    _call(src, "VolumeDelete", vpb.VolumeDeleteRequest(volume_id=vid),
          vpb.VolumeDeleteResponse)
    wait_until(lambda: {s: len(h) for s, h in
                        master.topo.ec_locations.get(vid, {}).items() if h}
               == dict.fromkeys(range(D + P), 1), timeout=15,
               msg="every shard registered once")

    served_by_port = []
    for vs in (p1, p2):
        real = vs.volume_ec_shard_read

        def counted(*a, _real=real, **kw):
            served_by_port.append(a[1])
            return _real(*a, **kw)
        vs.volume_ec_shard_read = counted

    def read_everywhere(tag):
        for vs in servers:
            for fid, data in blobs.items():
                r = requests.get(f"http://{vs.url}/{fid}", timeout=30)
                assert (r.status_code, r.content) == (200, data), (tag, vs.url)
        for fid, data in list(blobs.items())[:10]:
            assert operation.read(mc, fid) == data, tag

    read_everywhere("healthy")
    assert _grpc(ref) in p1.peers.reads + p2.peers.reads  # port <- JAX
    assert served_by_port                                 # JAX <- port

    # degraded: shard 0 lost on a port server, shard 3 on the JAX server
    _call(p1, "VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection="ecol", shard_ids=[0]),
        vpb.VolumeEcShardsDeleteResponse)
    _call(ref, "VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection="ecol", shard_ids=[3]),
        vpb.VolumeEcShardsDeleteResponse)
    wait_until(lambda: not master.topo.ec_locations[vid].get(0)
               and not master.topo.ec_locations[vid].get(3), timeout=15,
               msg="lost shards unregistered")
    p1.peers.reads.clear()
    before = sum(vs.read_stats.get("reconstructs", 0) for vs in (p1, p2))
    read_everywhere("degraded")
    assert sum(vs.read_stats.get("reconstructs", 0)
               for vs in (p1, p2)) > before
    assert _grpc(ref) in p1.peers.reads

    # the JAX shell's ec.rebuild: the first port server holds the most
    # shards, so it rebuilds (0, 3) from the JAX and port survivors
    out = io.StringIO()
    env = CommandEnv(maddr, out=out)
    try:
        run_command(env, "lock")
        run_command(env, f"ec.rebuild -volumeId {vid}")
        run_command(env, "unlock")
    finally:
        env.mc.stop()
    assert f"rebuilt [0, 3] on {p1.url}" in out.getvalue(), out.getvalue()
    for s in (0, 3):
        assert _sha(_base(p1, vid, "ecol") + files.shard_ext(s)) == sealed[s]
    assert sorted(p1.store.find_ec_volume(vid).shards) == [0, 1, 2, 3]
    read_everywhere("rebuilt")


def test_shell_volume_scrub_on_a_port_server(cluster):
    master, maddr, ref, (p1, p2), mc = cluster
    vid = 901
    _call(p2, "AllocateVolume", vpb.AllocateVolumeRequest(
        volume_id=vid, collection="scrub"), vpb.AllocateVolumeResponse)
    rng = np.random.default_rng(7)
    for i in range(1, 41):
        fid = file_id(vid, i, 0x1234)
        r = requests.post(f"http://{p2.url}/{fid}",
                          data=rng.bytes(int(rng.integers(1, 4000))),
                          timeout=10)
        assert r.status_code == 201
    v = p2.store.find_volume(vid)
    v.sync()
    off = v.nm.get(17).offset
    with open(v.file_name() + ".dat", "r+b") as f:
        f.seek(off + 16 + 4 + 1)
        b = f.read(1)
        f.seek(off + 16 + 4 + 1)
        f.write(bytes([b[0] ^ 0xFF]))
    wait_until(lambda: [n.url for n in master.topo.lookup(vid)] == [p2.url],
               timeout=10, msg="the volume in the master's topology")
    for device in ("auto", "off"):
        out = io.StringIO()
        env = CommandEnv(maddr, out=out)
        try:
            with pytest.raises(RuntimeError, match="1 corrupt needles"):
                run_command(env, f"volume.scrub -volumeId {vid} "
                                 f"-device {device}")
        finally:
            env.mc.stop()
        text = out.getvalue()
        mode = "device" if device == "auto" else "cpu"
        assert f"{p2.url} volume {vid}: 40 needles" in text, text
        assert f"[{mode}]" in text and "CORRUPT: ['0x11']" in text, text


def test_cli_volume_verb_joins_the_jax_master(cluster, tmp_path):
    master, maddr, ref, _, mc = cluster
    port = free_port_pair()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
         "-dir", str(tmp_path), "-port", str(port), "-mserver", maddr,
         "-device", "cpu", "-pulseSeconds", "0.5"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        me = f"127.0.0.1:{port}"
        wait_until(lambda: me in master.topo.nodes or proc.poll() is not None,
                   timeout=60, msg="the CLI server registered")
        assert proc.poll() is None, proc.stdout.read().decode()
        vid = 902
        Stub(f"127.0.0.1:{port + 10000}", VOLUME_SERVICE).call(
            "AllocateVolume", vpb.AllocateVolumeRequest(volume_id=vid),
            vpb.AllocateVolumeResponse, timeout=30)
        fid = file_id(vid, 5, 0xBEEF)
        body = b"served by the port's volume verb" * 40
        assert requests.post(f"http://{me}/{fid}", data=body,
                             timeout=10).status_code == 201
        r = requests.get(f"http://{me}/{fid}", timeout=10)
        assert (r.status_code, r.content) == (200, body)
        wait_until(lambda: [n.url for n in master.topo.lookup(vid)] == [me],
                   timeout=10, msg="the volume in the master's topology")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)
    assert proc.returncode == 0, proc.stdout.read().decode()


def _holders(master, fid):
    return {n.url for n in master.topo.lookup(int(fid.split(",")[0]))}


def test_replicated_volume_spans_jax_and_port_servers(cluster):
    from seaweedfs_tpu.utils import retry as ref_retry
    from seaweedfs_tpu_torch.stats import BULK_PUT_NEEDLES, BULK_READ_NEEDLES
    master, maddr, ref, (p1, p2), mc = cluster
    rng = np.random.default_rng(11)
    blobs = {}
    for _ in range(12):
        data = rng.bytes(int(rng.integers(1, 5000)))
        blobs[operation.submit(mc, data, collection="rep",
                               replication="001").fid] = data
    vid = int(next(iter(blobs)).split(",")[0])
    # writes with either holder as the primary
    for i, primary in enumerate((p1, ref, p1, ref)):
        fid = file_id(vid, (1 << 40) + i, 0xABC0 + i)
        blobs[fid] = rng.bytes(700 + i)
        r = requests.post(f"http://{primary.url}/{fid}", data=blobs[fid],
                          timeout=10)
        assert r.status_code == 201, r.text
    bulk0 = BULK_PUT_NEEDLES.count()
    batch = [rng.bytes(int(rng.integers(0, 3000))) for _ in range(150)]
    for res, data in zip(operation.submit_batch(
            mc, batch, collection="rep", replication="001"), batch):
        blobs[res.fid] = data
    assert BULK_PUT_NEEDLES.count() > bulk0  # frames or hops on p1
    # each copy enters the master's topology with its holder's next
    # heartbeat (0.5 s), which a loaded host can delay past the writes
    wait_until(lambda: all(_holders(master, fid) == {ref.url, p1.url}
                           for fid in blobs),
               timeout=30, msg="both holders of every fid registered")
    for fid in blobs:
        assert _holders(master, fid) == {ref.url, p1.url}, fid
    # every fid from both holders, and by proxy from the third server
    for fid, data in blobs.items():
        for vs in (ref, p1, p2):
            r = requests.get(f"http://{vs.url}/{fid}", timeout=10)
            assert (r.status_code, r.content) == (200, data), (fid, vs.url)
    r = requests.get(f"http://{p2.url}/{fid}", timeout=10,
                     headers={"Range": "bytes=1-10"})
    assert (r.status_code, r.content) == (206, data[1:11])

    # read_batch through the port holder: the JAX holder's breaker open
    fids = list(blobs)
    ref_retry.breaker(ref.url).trip()
    try:
        n0 = BULK_READ_NEEDLES.count()
        assert operation.read_batch(mc, fids) == [blobs[f] for f in fids]
        assert BULK_READ_NEEDLES.count() > n0
    finally:
        ref_retry.reset_breakers()

    # deletes fan out: through the port server to the JAX server, and back
    for primary, other in ((p1, ref), (ref, p1)):
        fid = fids.pop()
        r = requests.delete(f"http://{primary.url}/{fid}", timeout=10)
        assert r.status_code == 202
        assert requests.get(f"http://{other.url}/{fid}",
                            timeout=10).status_code == 404
        assert requests.get(f"http://{p2.url}/{fid}",
                            timeout=10).status_code == 404


@pytest.fixture(scope="module")
def secure_cluster(tmp_path_factory):
    """A JAX master started with a signing key and one port server with
    the same key; the process's cluster keys are cleared after."""
    from seaweedfs_tpu.security import Guard as RefGuard
    from seaweedfs_tpu.utils import rpc as ref_rpc
    from seaweedfs_tpu_torch.security import Guard
    from seaweedfs_tpu_torch.utils import rpc as port_rpc
    key = "interop-signing-key"
    mport = free_port_pair()
    maddr = f"127.0.0.1:{mport}"
    master = MasterServer(port=mport, volume_size_limit_mb=64,
                          pulse_seconds=0.5, guard=RefGuard(signing_key=key))
    master.start()
    served = None
    try:
        port = free_port_pair()
        store = Store("127.0.0.1", port, f"127.0.0.1:{port}",
                      [DiskLocation(str(tmp_path_factory.mktemp("secure")),
                                    max_volume_count=10)],
                      coder_name="torch", device="cpu")
        vs = VolumeServer(store, "127.0.0.1", port, pulse_seconds=0.5,
                          guard=Guard(signing_key=key))
        served = serve_volume(vs, port + 10000, master=maddr)
        wait_cluster_up(master, [vs], timeout=20)
        mc = MasterClient(maddr).start()
        try:
            yield master, vs, mc, key
        finally:
            mc.stop()
    finally:
        if served is not None:
            served.stop()
        master.stop()
        ref_rpc.set_cluster_key("")
        port_rpc.set_cluster_key("")


def test_port_server_joins_a_signed_cluster(secure_cluster):
    """The port server registers by heartbeat through the cluster token,
    takes a write with the master-minted token, refuses one without it
    with 401, and refuses a gRPC call without the cluster token."""
    import grpc
    from seaweedfs_tpu.utils import rpc as ref_rpc
    master, vs, mc, key = secure_cluster
    assert vs.url in master.topo.nodes
    data = b"a write the master signed" * 40
    res = operation.submit(mc, data)
    assert _holders(master, res.fid) == {vs.url}
    assert operation.read(mc, res.fid) == data
    vid = int(res.fid.split(",")[0])
    fid = file_id(vid, 1 << 40, 0x5157)
    r = requests.post(f"http://{vs.url}/{fid}", data=b"unsigned", timeout=10)
    assert r.status_code == 401
    ref_rpc.set_cluster_key("")  # a caller without the cluster token
    try:
        with pytest.raises(grpc.RpcError) as e:
            _call(vs, "Ping", vpb.PingRequest(), vpb.PingResponse, timeout=10)
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED
    finally:
        ref_rpc.set_cluster_key(key)
    assert _call(vs, "Ping", vpb.PingRequest(), vpb.PingResponse,
                 timeout=10).remote_time_ns > 0


# -- the maintenance plane: the JAX shell and client against port servers ----

def _shell(maddr, *commands):
    out = io.StringIO()
    env = CommandEnv(maddr, out=out)
    try:
        run_command(env, "lock")
        for c in commands:
            run_command(env, c)
        run_command(env, "unlock")
    finally:
        env.mc.stop()
    return out.getvalue()


def _fill(vs, vid, n, seed, collection="", replication=""):
    """Allocate `vid` on `vs` (any package) and POST n needles to it."""
    _call(vs, "AllocateVolume", vpb.AllocateVolumeRequest(
        volume_id=vid, collection=collection, replication=replication),
        vpb.AllocateVolumeResponse)
    rng = np.random.default_rng(seed)
    blobs = {}
    for i in range(1, n + 1):
        fid = file_id(vid, i, int(rng.integers(1, 1 << 32)))
        blobs[fid] = rng.bytes(int(rng.integers(1, 6000)))
        r = requests.post(f"http://{vs.url}/{fid}", data=blobs[fid],
                          timeout=10)
        assert r.status_code == 201, r.text
    return blobs


def _volume_info(master, url, vid):
    node = master.topo.nodes.get(url)
    return {v.id: v for v in node.all_volumes()}.get(vid) if node else None


def test_shell_volume_move_and_fix_replication_onto_port_servers(cluster):
    """volume.move from one port server to the other (VolumeCopy on the
    port target, CopyFile on the port source), then volume.fix.replication
    of a "001" volume held by the JAX server alone: the new copy lands on a
    port server through its VolumeCopy."""
    master, maddr, ref, (p1, p2), mc = cluster
    vid = 911
    blobs = _fill(p1, vid, 20, seed=91, collection="mv")
    wait_until(lambda: _holders(master, next(iter(blobs))) == {p1.url},
               timeout=10, msg="the volume on p1")
    out = _shell(maddr, f"volume.move -volumeId {vid} -source {p1.url} "
                        f"-target {p2.url}")
    assert f"moved volume {vid} {p1.url} -> {p2.url}" in out, out
    assert p1.store.find_volume(vid) is None
    wait_until(lambda: _holders(master, next(iter(blobs))) == {p2.url},
               timeout=10, msg="the volume moved to p2")
    for fid, data in blobs.items():
        r = requests.get(f"http://{p2.url}/{fid}", timeout=10)
        assert (r.status_code, r.content) == (200, data)

    vid = 912
    blobs = _fill(ref, vid, 12, seed=92, collection="fix", replication="001")
    wait_until(lambda: _holders(master, next(iter(blobs))) == {ref.url},
               timeout=10, msg="the volume on the JAX server")
    out = _shell(maddr, f"volume.fix.replication -volumeId {vid}")
    assert "replicated 1 volume copies" in out, out
    copies = [vs for vs in (p1, p2) if vs.store.find_volume(vid) is not None]
    assert len(copies) == 1
    wait_until(lambda: len(_holders(master, next(iter(blobs)))) == 2,
               timeout=10, msg="two holders")
    new = copies[0]
    ref.store.find_volume(vid).sync()
    assert _sha(ref.store.find_volume(vid).file_name() + ".dat") == \
        _sha(new.store.find_volume(vid).file_name() + ".dat")
    for fid, data in blobs.items():
        r = requests.get(f"http://{new.url}/{fid}", timeout=10)
        assert (r.status_code, r.content) == (200, data)


def test_shell_configure_replication_on_a_port_server(cluster):
    """volume.configure.replication rewrites a port holder's super block
    (VolumeConfigure) and the master sees the new placement by heartbeat."""
    master, maddr, ref, (p1, p2), mc = cluster
    vid = 913
    _fill(p1, vid, 3, seed=93, collection="cfg")
    wait_until(lambda: _volume_info(master, p1.url, vid) is not None,
               timeout=10, msg="the volume on p1")
    out = _shell(maddr, f"volume.configure.replication -volumeId {vid} "
                        "-replication 010")
    assert f"{p1.url}: ok" in out, out
    with open(p1.store.find_volume(vid).file_name() + ".dat", "rb") as f:
        assert f.read(2)[1] == 10
    wait_until(lambda: str(_volume_info(master, p1.url, vid)
                           .replica_placement) == "010",
               timeout=10, msg="the master sees the new placement")


def test_backup_batch_delete_and_query_against_a_port_server(cluster,
                                                             tmp_path):
    """The JAX client's incremental backup (VolumeSyncStatus, CopyFile,
    VolumeIncrementalCopy) of a port server's volume, its batched delete
    (BatchDelete) and its query (Query) with a filter and a projection."""
    import json as _json

    from seaweedfs_tpu.client.backup import backup_volume
    master, maddr, ref, (p1, p2), mc = cluster
    vid = 914
    rng = np.random.default_rng(94)
    _call(p2, "AllocateVolume", vpb.AllocateVolumeRequest(
        volume_id=vid, collection="bk"), vpb.AllocateVolumeResponse)
    docs = {}

    def post(i):
        fid = file_id(vid, i, 0xB0B0 + i)
        lines = [{"n": i * 10 + j, "even": (i + j) % 2 == 0,
                  "w": int(rng.integers(0, 100))} for j in range(6)]
        docs[fid] = lines
        body = "".join(_json.dumps(x) + "\n" for x in lines).encode()
        assert requests.post(f"http://{p2.url}/{fid}", data=body,
                             timeout=10).status_code == 201

    for i in range(1, 16):
        post(i)
    wait_until(lambda: mc.lookup(vid), timeout=10, msg="the volume known")
    dest = tmp_path / "backup"
    dest.mkdir()
    first = backup_volume(mc, vid, str(dest), collection="bk")
    assert first["mode"] == "full"
    for i in range(16, 24):
        post(i)
    second = backup_volume(mc, vid, str(dest), collection="bk")
    assert (second["mode"], second["records_applied"]) == ("incremental", 8)
    v = p2.store.find_volume(vid)
    v.sync()
    assert _sha(str(dest / f"bk_{vid}.dat")) == _sha(v.file_name() + ".dat")

    fids = list(docs)
    got = operation.query(mc, fids, field="w", op=">=", value="50",
                          projections=["n", "even"])
    want = "".join(_json.dumps([x["n"], x["even"]]) + "\n"
                   for fid in fids for x in docs[fid] if x["w"] >= 50)
    assert got.decode() == want and want

    assert operation.delete_batch(mc, fids[:5]) == 5
    for fid in fids[:5]:
        assert requests.get(f"http://{p2.url}/{fid}",
                            timeout=10).status_code == 404
    assert operation.delete_batch(mc, fids[:2]) == 0  # already gone: 404s


def test_shell_volume_server_leave_of_a_port_server(cluster, tmp_path):
    """volume.server.leave on a port server: its heartbeat stream ends, the
    master forgets it, and it still answers a direct GET."""
    master, maddr, ref, _, mc = cluster
    port = free_port_pair()
    store = Store("127.0.0.1", port, f"127.0.0.1:{port}",
                  [DiskLocation(str(tmp_path / "leaver"),
                                max_volume_count=4)],
                  coder_name="torch", device="cpu")
    vs = VolumeServer(store, "127.0.0.1", port, pulse_seconds=0.5,
                      rack="rack9")
    served = serve_volume(vs, port + 10000, master=maddr)
    try:
        wait_cluster_up(master, [vs], timeout=20)
        blobs = _fill(vs, 915, 2, seed=95)
        out = _shell(maddr, f"volume.server.leave -node {vs.url}")
        assert "left the cluster" in out, out
        wait_until(lambda: vs.url not in master.topo.nodes, timeout=15,
                   msg="the master forgot the server")
        for fid, data in blobs.items():
            r = requests.get(f"http://{vs.url}/{fid}", timeout=10)
            assert (r.status_code, r.content) == (200, data)
    finally:
        served.stop()


# -- the control plane: the port's master and shell with the JAX package's --

@pytest.fixture(scope="module")
def port_master_cluster(tmp_path_factory):
    """The port's MasterServer with a JAX volume server (rack0) and two
    port servers (rack1, rack2) heartbeating to it."""
    from seaweedfs_tpu_torch.master.master_server import \
        MasterServer as PortMaster
    retry.reset_breakers()
    mport, hport = free_port_pair(), free_port_pair()
    master = PortMaster(port=mport, http_port=hport, volume_size_limit_mb=64,
                        pulse_seconds=0.5, ec_parity_shards=P)
    master.start()
    maddr = master.address
    ref = None
    served = []
    try:
        d = tmp_path_factory.mktemp("pm_jax_vs")
        port = free_port_pair()
        store = RefStore("127.0.0.1", port, f"127.0.0.1:{port}",
                         [RefLocation(str(d), max_volume_count=10)],
                         ec_geometry=RefGeometry(D, P, large_block=LB,
                                                 small_block=SB),
                         coder_name="numpy")
        ref = RefServer(store, maddr, port=port, grpc_port=port + 10000,
                        pulse_seconds=0.5, rack="rack0")
        ref.start()
        for i in (1, 2):
            d = tmp_path_factory.mktemp(f"pm_port_vs{i}")
            port = free_port_pair()
            store = Store("127.0.0.1", port, f"127.0.0.1:{port}",
                          [DiskLocation(str(d), max_volume_count=10)],
                          ec_geometry=EcGeometry(D, P, large_block=LB,
                                                 small_block=SB),
                          coder_name="torch", device="cpu")
            vs = VolumeServer(store, "127.0.0.1", port, rack=f"rack{i}",
                              pulse_seconds=0.5)
            served.append(serve_volume(vs, port + 10000, master=maddr))
        wait_cluster_up(master, [ref] + [s.vs for s in served], timeout=20)
        mc = MasterClient(maddr).start()
        try:
            yield master, maddr, f"127.0.0.1:{hport}", ref, \
                [s.vs for s in served], mc
        finally:
            mc.stop()
    finally:
        for s in served:
            s.stop()
        if ref is not None:
            ref.stop()
        master.stop()
        retry.reset_breakers()


def test_jax_server_joins_the_port_master(port_master_cluster):
    """Volumes grown on the JAX server's rack by the port's master take
    the JAX client's writes; the JAX client reads them back through the
    port's lookups, and a port server proxies a GET to the JAX holder
    after asking the port's master where the volume lives."""
    master, maddr, http, ref, (p1, p2), mc = port_master_cluster
    r = requests.get(f"http://{http}/dir/assign",
                     params={"collection": "onjax", "rack": "rack0"},
                     timeout=30)
    assert r.status_code == 200, r.text
    rng = np.random.default_rng(21)
    blobs = {}
    for _ in range(12):
        data = rng.bytes(int(rng.integers(100, 9000)))
        blobs[operation.submit(mc, data, collection="onjax").fid] = data
    for fid, data in blobs.items():
        assert _holders(master, fid) == {ref.url}
        assert operation.read(mc, fid) == data
        r = requests.get(f"http://{p1.url}/{fid}", timeout=30)
        assert (r.status_code, r.content) == (200, data)


def test_jax_shell_encodes_and_rebuilds_on_the_port_master(
        port_master_cluster):
    master, maddr, http, ref, (p1, p2), mc = port_master_cluster
    rng = np.random.default_rng(22)
    blobs = {}
    for _ in range(20):
        data = rng.bytes(int(rng.integers(100, 9000)))
        blobs[operation.submit(mc, data, collection="jxec").fid] = data
    vid = int(next(iter(blobs)).split(",")[0])
    assert all(int(f.split(",")[0]) == vid for f in blobs)
    out = _shell(maddr, "ec.encode -collection jxec -fullPercent 0")
    assert "ec encoded 1 volumes" in out, out
    wait_until(lambda: sorted(s for s, h in master.topo.lookup_ec(vid).items()
                              if h) == list(range(D + P)), timeout=15,
               msg="every shard registered on the port's master")
    racks = {}
    for sid, nodes in master.topo.lookup_ec(vid).items():
        for n in nodes:
            racks.setdefault(n.rack.id, set()).add(sid)
    assert len(racks) == 3 and max(len(s) for s in racks.values()) <= P
    for fid, data in blobs.items():
        assert operation.read(mc, fid) == data

    # lose a shard on a port server; the JAX shell's ec.rebuild asks the
    # port's master where the survivors are and restores it
    victim = next(vs for vs in (p1, p2)
                  if vs.store.find_ec_volume(vid) is not None)
    sid = sorted(victim.store.find_ec_volume(vid).shards)[0]
    sealed = _sha(_base(victim, vid, "jxec") + files.shard_ext(sid))
    _call(victim, "VolumeEcShardsUnmount", vpb.VolumeEcShardsUnmountRequest(
        volume_id=vid, shard_ids=[sid]), vpb.VolumeEcShardsUnmountResponse)
    _call(victim, "VolumeEcShardsDelete", vpb.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection="jxec", shard_ids=[sid]),
        vpb.VolumeEcShardsDeleteResponse)
    wait_until(lambda: not master.topo.lookup_ec(vid).get(sid), timeout=15,
               msg="lost shard unregistered")
    out = _shell(maddr, f"ec.rebuild -volumeId {vid}")
    assert f"missing shards [{sid}]" in out, out
    wait_until(lambda: master.topo.lookup_ec(vid).get(sid), timeout=15,
               msg="rebuilt shard registered")
    host = next(vs for vs in (ref, p1, p2)
                if os.path.exists(_base(vs, vid, "jxec")
                                  + files.shard_ext(sid)))
    assert _sha(_base(host, vid, "jxec") + files.shard_ext(sid)) == sealed
    for fid, data in blobs.items():
        assert operation.read(mc, fid) == data


def test_port_shell_encodes_and_decodes_on_the_jax_master(cluster):
    """The port's shell (its CommandEnv and MasterClient) runs ec.encode
    and ec.decode against the JAX package's master and servers of both
    packages."""
    # registers the port's command tables (lock and unlock included)
    from seaweedfs_tpu_torch.shell import ec_commands as _ec  # noqa: F401
    from seaweedfs_tpu_torch.shell import volume_commands as _vol  # noqa: F401
    from seaweedfs_tpu_torch.shell.commands import CommandEnv as PortEnv
    from seaweedfs_tpu_torch.shell.commands import run_command as port_run
    master, maddr, ref, (p1, p2), mc = cluster
    rng = np.random.default_rng(23)
    blobs = {}
    for _ in range(20):
        data = rng.bytes(int(rng.integers(100, 9000)))
        blobs[operation.submit(mc, data, collection="portsh").fid] = data
    vid = int(next(iter(blobs)).split(",")[0])
    out = io.StringIO()
    env = PortEnv(maddr, out=out)
    try:
        for line in ("lock", "ec.encode -collection portsh -fullPercent 0",
                     "unlock"):
            port_run(env, line)
        wait_until(lambda: sorted(
            s for s, h in master.topo.ec_locations.get(vid, {}).items()
            if h) == list(range(D + P)), timeout=15,
            msg="every shard registered on the JAX master")
        assert master.topo.lookup(vid) == []
        for fid, data in blobs.items():
            assert operation.read(mc, fid) == data
        for line in ("lock", f"ec.decode -volumeId {vid}", "unlock"):
            port_run(env, line)
    finally:
        env.mc.stop()
    assert f"decoded ec volume {vid}" in out.getvalue(), out.getvalue()
    wait_until(lambda: master.topo.lookup(vid), timeout=15,
               msg="decoded volume registered")
    mc.vid_map.invalidate(vid)
    for fid, data in blobs.items():
        assert operation.read(mc, fid) == data
