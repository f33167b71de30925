"""The port's raft quorum (seaweedfs_tpu_torch/master/raft.py, follower.py
and the master's FSM seam) against the JAX package's: mixed quorums of
one JAX master and two port masters elect one leader and replicate the
FSM (MaxVolumeId, the sequencer's high-water mark, lease grants) to every
member, survive the leader's loss, serve lookups from the follower cache
and never hand out a fid below one handed out before; a state file and WAL
written by either package replays on the other, byte for byte; and a
3-master quorum of the port runs its lock order clean under
SWTPU_LOCKCHECK=1. Comparisons are exact."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import free_port_pair, wait_until
from torch_cluster import free_port_pair as low_port_pair
from seaweedfs_tpu.master import raft as ref_raft
from seaweedfs_tpu.master.master_server import MasterServer as RefMaster
from seaweedfs_tpu_torch.client import http_util
from seaweedfs_tpu_torch.client.master_client import MasterClient
from seaweedfs_tpu_torch.master import raft as port_raft
from seaweedfs_tpu_torch.master.master_server import MasterServer
from seaweedfs_tpu_torch.server.grpc_service import serve_volume
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAFT = {"jax": ref_raft, "port": port_raft}


def _leader(masters, timeout=15.0):
    """The one live leader that every live member agrees on."""
    out = []

    def agreed():
        live = [m for m in masters if not m._stop.is_set()]
        out[:] = [m for m in live if m.is_leader]
        return len(out) == 1 and all(m.leader_address == out[0].address
                                     for m in live)

    wait_until(agreed, timeout=timeout,
               msg=f"one agreed leader among {[m.address for m in masters]}")
    return out[0]


def _fsm(m) -> tuple:
    return (m.topo.max_volume_id, m.sequencer.peek, m.fid_leases.active())


def _log(m) -> list:
    with m.raft._lock:
        return [(e.term, e.command) for e in m.raft.log
                if "raft_members" not in e.command]


@pytest.fixture()
def mixed_quorum(tmp_path):
    """One JAX master and two port masters in one raft quorum, each with
    its HTTP API."""
    ports = [free_port_pair() for _ in range(3)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    masters = []
    try:
        for cls, p in zip((RefMaster, MasterServer, MasterServer), ports):
            ms = cls(port=p, http_port=free_port_pair(),
                     volume_size_limit_mb=64, pulse_seconds=0.5, peers=peers,
                     raft_state_path=str(tmp_path / f"raft-{p}.json"),
                     maintenance_scripts=[])
            ms.start()
            masters.append(ms)
        yield masters
    finally:
        for m in masters:
            m.stop()


def test_mixed_quorum_elects_one_leader_and_replicates(mixed_quorum):
    leader = _leader(mixed_quorum)
    assert leader.raft is not None and all(
        m.raft is not None for m in mixed_quorum)
    rng = np.random.default_rng(15)
    mvid = int(rng.integers(10, 1000))
    count = int(rng.integers(100, 5000))
    hwm = int(rng.integers(5000, 50000))
    assert leader.raft.propose({"max_volume_id": mvid})
    assert leader.raft.propose({"seq_hwm": hwm + count,
                                "lease": {"count": count, "ttl_s": 60.0}})
    want = (mvid, hwm + count, 1)
    wait_until(lambda: all(_fsm(m) == want for m in mixed_quorum),
               timeout=10, msg=f"every member's FSM at {want}")
    wait_until(lambda: len({json.dumps(_log(m)) for m in mixed_quorum}) == 1,
               timeout=10, msg="equal logs")
    assert [c for _, c in _log(leader)][-2:] == [
        {"max_volume_id": mvid},
        {"seq_hwm": hwm + count, "lease": {"count": count, "ttl_s": 60.0}}]


def test_mixed_quorum_survives_the_leaders_loss(mixed_quorum):
    """The survivors, of both packages whoever led, elect a new leader
    that commits on top of the old FSM; nothing regresses."""
    leader = _leader(mixed_quorum)
    assert leader.raft.propose({"max_volume_id": 77})
    assert leader.raft.propose({"seq_hwm": 9001})
    wait_until(lambda: all(_fsm(m)[:2] == (77, 9001) for m in mixed_quorum),
               timeout=10, msg="FSM replicated before the loss")
    leader.stop()
    rest = [m for m in mixed_quorum if m is not leader]
    new = _leader(rest)
    assert new is not leader
    assert new.raft.propose({"max_volume_id": 78})
    assert new.raft.propose({"seq_hwm": 12000})
    wait_until(lambda: all(_fsm(m)[:2] == (78, 12000) for m in rest),
               timeout=10, msg="the new leader's commits on both survivors")
    assert _log(rest[0]) == _log(rest[1])


def test_mixed_quorum_serves_lookups_and_never_regresses_a_fid(
        mixed_quorum, tmp_path):
    """A port volume server heartbeats to the quorum; assigns and a
    leased range go through whoever leads; a follower of either package
    answers /dir/lookup from its follower cache with the leader's hint;
    after the leader's loss the next assign's key lies above every key
    handed out before it."""
    leader = _leader(mixed_quorum)
    addrs = ",".join(m.address for m in mixed_quorum)
    port = free_port_pair()
    store = Store("127.0.0.1", port, "", [DiskLocation(
        str(tmp_path / "v"), max_volume_count=16)], coder_name="torch",
        device="cpu")
    vs = VolumeServer(store, "127.0.0.1", port, pulse_seconds=0.3)
    served = serve_volume(vs, port + 10000, master=addrs)
    mc = MasterClient(addrs).start()
    try:
        wait_until(lambda: len(leader.topo.nodes) == 1, timeout=20,
                   msg="the volume server registered with the leader")
        keys = []
        deadline = time.monotonic() + 30
        while True:
            try:
                a = mc.assign(collection="raft15")
                break
            except Exception:  # noqa: BLE001 — growth lags registration
                assert time.monotonic() < deadline
                time.sleep(0.2)
        vid = int(a.fid.split(",")[0])
        keys.append(int(a.fid.split(",")[1][:-8], 16))
        lease = mc.lease_fids(512, collection="raft15")
        keys.extend(range(lease.next_key, lease.end_key))
        assert http_util.send("POST", f"http://{a.location.url}/{a.fid}",
                              b"before the failover").status == 201
        for m in mixed_quorum:
            if m is leader:
                continue
            wait_until(lambda m=m: http_util.get(
                f"http://127.0.0.1:{m.http_port}/dir/lookup?volumeId={vid}"
            ).status == 200, timeout=10, msg=f"{m.address}'s follower cache")
            body = http_util.get(f"http://127.0.0.1:{m.http_port}"
                                 f"/dir/lookup?volumeId={vid}").json()
            assert body["leader"] == leader.address
            assert [loc["url"] for loc in body["locations"]] == [vs.url]
        assert max(_fsm(m)[1] for m in mixed_quorum) > max(keys)
        leader.stop()
        rest = [m for m in mixed_quorum if m is not leader]
        new = _leader(rest)
        wait_until(lambda: len(new.topo.nodes) == 1, timeout=20,
                   msg="the volume server re-registered")
        deadline = time.monotonic() + 30
        while True:
            try:
                b = mc.assign(collection="raft15")
                break
            except Exception:  # noqa: BLE001 — the client follows the leader
                assert time.monotonic() < deadline
                time.sleep(0.2)
        assert int(b.fid.split(",")[0]) >= vid
        assert int(b.fid.split(",")[1][:-8], 16) > max(keys)
        assert http_util.send("POST", f"http://{b.location.url}/{b.fid}",
                              b"after the failover").status == 201
        r = http_util.send("GET", f"http://{vs.url}/{a.fid}")
        assert (r.status, r.content) == (200, b"before the failover")
    finally:
        mc.stop()
        served.stop()


def _drive(mod, path: str, compact: bool) -> None:
    """One follower's persistent history: a vote, an adopted term, 40
    entries appended through the WAL; with `compact`, then a leader's
    snapshot of the first 30 (the log rewritten) and a conflicting
    append that truncates the tail."""
    members = ["a:1", "b:2", "c:3"]
    n = mod.RaftNode("a:1", members, lambda c: None, state_path=path)
    assert n._on_request_vote({"term": 3, "candidate": "b:2",
                               "last_log_index": -1,
                               "last_log_term": 0})["granted"]
    rng = np.random.default_rng(7)
    entries = []
    for i in range(40):
        cmd = ({"max_volume_id": int(rng.integers(1, 1 << 20))} if i % 3
               else {"seq_hwm": int(rng.integers(1, 1 << 40)),
                     "lease": {"count": int(rng.integers(1, 4096)),
                               "ttl_s": 30.0}})
        entries.append({"term": 3, "command": cmd})

    def append(prev, chunk, commit, snapshot=None, term=3):
        assert n._on_append_entries({
            "term": term, "leader": "b:2", "prev_log_index": prev,
            "prev_log_term": 3 if prev >= 0 else 0, "entries": chunk,
            "snapshot": snapshot, "leader_commit": commit})["success"]

    for i in range(0, 40, 16):
        append(i - 1, entries[i:i + 16], min(i + 15, 39) - 8)
    if compact:
        state = {}
        for e in entries[:30]:
            state = mod._fold(state, e["command"])
        append(29, entries[30:], 35, snapshot={
            "state": state, "last_index": 29, "last_term": 3})
        append(35, [{"term": 4, "command": {"max_volume_id": 1 << 21}}],
               36, term=4)
    n.stop()


def _state(mod, path: str) -> dict:
    n = mod.RaftNode("a:1", ["a:1", "b:2", "c:3"], lambda c: None,
                     state_path=path)
    try:
        return {"term": n.current_term, "vote": n.voted_for,
                "log_start": n.log_start, "snapshot": n.snapshot_state,
                "snapshot_term": n.snapshot_term,
                "log": [(e.term, e.command) for e in n.log]}
    finally:
        n.stop()


@pytest.mark.parametrize("compact", [False, True], ids=["wal", "snapshot"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_state_file_replays_on_the_other_package(tmp_path, writer, reader,
                                                 compact):
    """The state file and WAL one package writes replay on the other to
    the same term, vote, snapshot and log; the same history written by
    both gives byte-equal files."""
    path = str(tmp_path / f"{writer}.json")
    _drive(RAFT[writer], path, compact)
    assert _state(RAFT[reader], path) == _state(RAFT[writer], path)
    other = str(tmp_path / f"{reader}.json")
    _drive(RAFT[reader], other, compact)
    for suffix in ("", ".wal"):
        with open(path + suffix, "rb") as f, open(other + suffix, "rb") as g:
            assert f.read() == g.read(), suffix
    if compact:
        st = _state(RAFT[reader], path)
        assert st["log_start"] == 30 and st["snapshot"]
        assert st["log"][-1] == (4, {"max_volume_id": 1 << 21})


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_vote_is_durable_across_packages(tmp_path, writer, reader):
    """A vote granted by one package's node binds the other's after a
    crash replay over the same state file."""
    path = str(tmp_path / "raft.json")
    members = ["a:1", "b:2", "c:3"]
    n = RAFT[writer].RaftNode("a:1", members, lambda c: None,
                              state_path=path)
    assert n._on_request_vote({"term": 5, "candidate": "b:2",
                               "last_log_index": -1,
                               "last_log_term": 0})["granted"]
    n.stop()
    n2 = RAFT[reader].RaftNode("a:1", members, lambda c: None,
                               state_path=path)
    try:
        assert (n2.current_term, n2.voted_for) == (5, "b:2")
        assert not n2._on_request_vote({"term": 5, "candidate": "c:3",
                                        "last_log_index": 3,
                                        "last_log_term": 5})["granted"]
        assert n2._on_request_vote({"term": 5, "candidate": "b:2",
                                    "last_log_index": -1,
                                    "last_log_term": 0})["granted"]
    finally:
        n2.stop()


LOCK_SCRIPT = r'''
import json, os, sys, tempfile, time
import seaweedfs_tpu_torch  # installs the detector under SWTPU_LOCKCHECK=1
from seaweedfs_tpu_torch.utils import locktrack
from seaweedfs_tpu_torch.client.master_client import MasterClient
from seaweedfs_tpu_torch.master.master_server import MasterServer
from seaweedfs_tpu_torch.server.grpc_service import serve_volume
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store

ports = [int(p) for p in sys.argv[1:5]]
root = tempfile.mkdtemp()
peers = [f"127.0.0.1:{p}" for p in ports[:3]]
ms = []
for p in ports[:3]:
    m = MasterServer(port=p, volume_size_limit_mb=64, pulse_seconds=0.3,
                     peers=peers, raft_state_path=os.path.join(root, f"{p}.json"),
                     maintenance_scripts=[])
    m.start()
    ms.append(m)


def leader(live):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        lead = [m for m in live if m.is_leader]
        if len(lead) == 1:
            return lead[0]
        time.sleep(0.05)
    raise SystemExit("no leader")


lead = leader(ms)
vp = ports[3]
store = Store("127.0.0.1", vp, "", [DiskLocation(os.path.join(root, "v"),
              max_volume_count=16)], coder_name="torch", device="cpu")
vs = VolumeServer(store, "127.0.0.1", vp, pulse_seconds=0.3)
served = serve_volume(vs, vp + 10000, master=",".join(peers))
mc = MasterClient(",".join(peers)).start()
keys = []


def assigns(n):
    deadline = time.monotonic() + 30
    done = 0
    while done < n:
        try:
            lease = mc.lease_fids(64, collection="lk")
            keys.append(lease.end_key - 1)
            a = mc.assign(collection="lk")
            keys.append(int(a.fid.split(",")[1][:-8], 16))
            done += 1
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


assigns(20)
before = max(keys)
lead.stop()
rest = [m for m in ms if m is not lead]
leader(rest)
assigns(20)
f = locktrack.findings()
print(json.dumps({"cycles": f["cycles"], "tracked": f["locks_tracked"],
                  "edges": f["edges"], "monotonic": min(keys[40:]) > before}))
mc.stop()
served.stop()
for m in rest:
    m.stop()
'''


def test_port_quorum_lock_order_is_clean_under_the_detector():
    """raft._lock -> {topo.lock, sequencer._lock, the lease registry}: a
    3-master quorum of the port, assigns and leased ranges through the
    log, a failover and more of them, under SWTPU_LOCKCHECK=1 in a
    subprocess; the detector finds no cycle, and every key after the
    failover lies above every key before it."""
    ports = [free_port_pair() for _ in range(4)]
    env = {**os.environ, "SWTPU_LOCKCHECK": "1",
           "SWTPU_LOCKCHECK_MAX_LOCKS": "512", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", LOCK_SCRIPT,
                          *map(str, ports)], capture_output=True, text=True,
                         timeout=240, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["cycles"] == [], res
    assert res["tracked"] > 0 and res["edges"] > 0
    assert res["monotonic"] is True


WARM_SCRIPT = r'''
import sys
from seaweedfs_tpu_torch.master.master_server import MasterServer
port = int(sys.argv[1])
ms = MasterServer(port=port, peers=[f"127.0.0.1:{port}", "127.0.0.1:1"],
                  maintenance_interval_s=3600)
before = "torch" in sys.modules
ms.start()
print("WARM", before, "torch" in sys.modules, ms.raft is not None)
ms.stop()
'''


def test_quorum_master_imports_the_codec_registry_before_raft_starts():
    """A master in a quorum whose cron has scripts imports the codec
    registry (and torch) before its raft node starts: torch's first import
    inside a cron sweep held the GIL long enough to depose the leader."""
    out = subprocess.run([sys.executable, "-c", WARM_SCRIPT,
                          str(free_port_pair())], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "WARM False True True" in out.stdout, out.stdout


# -- heartbeats on a per-peer clock (a port-only repair) -------------------


def _stalled_pair(mod, monkeypatch):
    """Two live RaftNodes of one package and a third peer whose every RPC
    stalls 1 s and then fails; the nodes' append arrivals are recorded."""
    rpc = __import__(mod.__name__.rsplit(".", 2)[0] + ".utils.rpc",
                     fromlist=["serve"])
    ports = [low_port_pair() for _ in range(3)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    stalled = peers[2]
    nodes, servers, arrivals = [], [], {}
    for addr in peers[:2]:
        node = mod.RaftNode(addr, peers, apply_fn=lambda c: None)
        real_call, real_append = node._call, node._on_append_entries

        def call(peer, method, payload, _real=real_call):
            if peer == stalled:
                time.sleep(1.0)
                raise TimeoutError("stalled peer")
            return _real(peer, method, payload)

        def on_append(p, _real=real_append, _addr=addr):
            arrivals.setdefault(_addr, []).append(time.monotonic())
            return _real(p)

        monkeypatch.setattr(node, "_call", call)
        monkeypatch.setattr(node, "_on_append_entries", on_append)
        servers.append(rpc.serve(addr, [node.build_service()]))
        nodes.append(node)
    for node in nodes:
        node.start()
    return nodes, servers, arrivals


@pytest.mark.parametrize("package", ["jax", "port"])
def test_one_stalled_peer_does_not_space_the_heartbeats(package, monkeypatch):
    """With one peer's AppendEntries stalled 1 s, the reference's leader
    waits on it before each heartbeat (gaps past the 0.4 s minimum election
    timeout); the port's healthy pair holds one term for 5 s."""
    nodes, servers, arrivals = _stalled_pair(RAFT[package], monkeypatch)
    try:
        wait_until(lambda: sum(n.is_leader for n in nodes) == 1, timeout=10,
                   msg="a leader of the live pair")
        leader = next(n for n in nodes if n.is_leader)
        follower = next(n for n in nodes if n is not leader)
        term = leader.current_term
        t0 = time.monotonic()
        time.sleep(5.0)
        times = [t for t in arrivals.get(follower.address, []) if t >= t0]
        gaps = np.diff(times) if len(times) > 1 else np.array([5.0])
        if package == "jax":
            assert gaps.max() > 0.4
        else:
            assert (leader.current_term, follower.current_term) == \
                (term, term) and leader.is_leader
            assert np.median(gaps) < 0.2 and len(times) >= 20
    finally:
        for n in nodes:
            n.stop()
        for s in servers:
            s.stop(grace=0.1)


# -- leadership inside long cron lines (a port-only repair) ----------------

def _deposing_env(leader):
    from types import SimpleNamespace as NS
    vol = lambda vid: NS(id=vid, collection="c", size=1 << 30)  # noqa: E731
    servers = [{"id": f"s{i}:8080", "grpc_port": 18080 + i, "dc": "dc1",
                "rack": f"r{i}", "disks": {"": NS(volume_infos=[vol(i + 1)])}}
               for i in range(3)]
    return NS(mc=NS(volume_list=lambda: NS(volume_size_limit_mb=64)),
              collect_volume_servers=lambda: servers,
              should_stop=lambda: not leader[0], option={},
              println=lambda *a: None)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_deposed_leader_runs_no_further_volume_of_its_line(package,
                                                           monkeypatch):
    """A cron line (ec.encode over three servers' volumes, a lifecycle plan
    of three transitions) whose leader is deposed during its first volume:
    the reference runs the rest of the line, the port none of it."""
    import importlib
    root = {"jax": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}[package]
    ec = importlib.import_module(root + ".shell.ec_commands")
    lc = importlib.import_module(root + ".lifecycle")
    planner = importlib.import_module(root + ".lifecycle.planner")
    leader = [True]
    encoded = []

    def encode_on_server(env, srv, vols, opt):
        encoded.append(vols[0][0])
        leader[0] = False  # deposed while the first volume encodes
        return 1

    monkeypatch.setattr(ec, "_encode_on_server", encode_on_server)
    ec.cmd_ec_encode(_deposing_env(leader), ["-collection", "c"])

    leader[0] = True
    moved = []
    ex = lc.LifecycleExecutor(_deposing_env(leader), max_concurrent=1)

    def dispatch(t):
        moved.append(t.vid)
        leader[0] = False
        return 1

    monkeypatch.setattr(ex, "_dispatch", dispatch)
    plan = lc.LifecyclePlan(transitions=[
        lc.Transition(planner.KIND_ENCODE, vid, "c", 1 << 20, "cold")
        for vid in (1, 2, 3)])
    summary = ex.execute(plan)
    if package == "jax":
        assert encoded == [1, 2, 3] and moved == [1, 2, 3]
    else:
        assert encoded == [1] and moved == [1]
        assert [s["reason"] for s in summary["skipped"]] == \
            ["leadership lost"] * 2


def test_concurrent_proposals_under_per_peer_appends():
    """Eight threads proposing at once on a port quorum of three, with a
    short switch interval: every proposal commits, and the three logs hold
    the same entries, in one order (the per-peer sends and their answers
    share the leader's indexes under its lock)."""
    from seaweedfs_tpu_torch.utils import rpc
    ports = [low_port_pair() for _ in range(3)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    applied = {p: [] for p in peers}
    nodes = [port_raft.RaftNode(p, peers, apply_fn=applied[p].append)
             for p in peers]
    servers = [rpc.serve(n.address, [n.build_service()]) for n in nodes]
    old = sys.getswitchinterval()
    try:
        for n in nodes:
            n.start()
        wait_until(lambda: sum(n.is_leader for n in nodes) == 1, timeout=10,
                   msg="a leader")
        leader = next(n for n in nodes if n.is_leader)
        sys.setswitchinterval(1e-5)
        results = []

        def propose(t):
            for i in range(20):
                results.append(leader.propose({"k": f"{t}-{i}"}, timeout=10))

        import threading
        threads = [threading.Thread(target=propose, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        sys.setswitchinterval(old)
        assert len(results) == 160 and all(results)
        wait_until(lambda: all(len(a) == 160 for a in applied.values()),
                   timeout=20, msg="every node applied the 160 entries")
        orders = [[c["k"] for c in a] for a in applied.values()]
        assert orders[0] == orders[1] == orders[2]
        assert sorted(orders[0]) == sorted(f"{t}-{i}" for t in range(8)
                                           for i in range(20))
    finally:
        sys.setswitchinterval(old)
        for n in nodes:
            n.stop()
        for s in servers:
            s.stop(grace=0.1)
