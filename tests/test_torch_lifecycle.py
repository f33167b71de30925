"""The port's lifecycle plane (seaweedfs_tpu_torch/lifecycle/ and
shell/lifecycle_commands.py) against the JAX package's: policies parse
alike (and refuse alike), `build_lifecycle_plan` gives an equal plan from
the same seeded topology and heat, and the executor's budget, cooldown,
lock and dry-run decisions are equal on the same plan. On live clusters
the JAX shell's `lifecycle.apply` walks a volume of a port cluster hot ->
EC -> remote -> EC, and the port's shell does the same on a JAX cluster,
every blob read back byte for byte after each move; and the two shells
print the same `lifecycle.status`, `cluster.top`, `qos.status` and
`cluster.raft.ps` on one cluster of port masters in a raft quorum.
Plans, decisions and outputs are compared exactly."""

import dataclasses
import io
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import free_port_pair, wait_until
from seaweedfs_tpu import lifecycle as ref_lc
from seaweedfs_tpu.lifecycle import planner as ref_planner
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu.shell import (ec_commands,  # noqa: F401 (register)
                                 lifecycle_commands, qos_commands,
                                 telemetry_commands, volume_commands)
from seaweedfs_tpu_torch import lifecycle as port_lc
from seaweedfs_tpu_torch.client import http_util
from seaweedfs_tpu_torch.client.master_client import MasterClient
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.lifecycle import planner as port_planner
from seaweedfs_tpu_torch.master.master_server import MasterServer
from seaweedfs_tpu_torch.server.grpc_service import serve_volume
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import commands as port_commands
from seaweedfs_tpu_torch.shell import (  # noqa: F401 (register)
    ec_commands as port_ec_commands,
    lifecycle_commands as port_lifecycle_commands,
    qos_commands as port_qos_commands,
    telemetry_commands as port_telemetry_commands,
    volume_commands as port_volume_commands)
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.store import Store

LC = {"jax": ref_lc, "port": port_lc}
PLANNER = {"jax": ref_planner, "port": port_planner}


# -- policy -------------------------------------------------------------------

POLICIES = [
    {"rules": [{"collection": "logs", "ec_after_s": 10},
               {"collection": "*", "ec_after_s": 100, "remote_after_s": 200,
                "remote": "local:/tmp/x", "promote_reads": 4,
                "ttl_s": 300}]},
    {"rules": [{"collection": "a", "ec_after_s": 0, "remote_after_s": 0,
                "remote": "local:/r", "min_size_bytes": 5},
               {"collection": "b", "ttl_s": 1.5}]},
    {"rules": [{"remote_after_s": 5}]},
    {"rules": [{"ec_after": 5}]},
    {"rules": [{"ec_after_s": -1}]},
    {"rules": "nope"},
]


@pytest.mark.parametrize("doc", POLICIES, ids=range(len(POLICIES)))
def test_policy_parses_and_refuses_like_reference(doc):
    got = {}
    for name, mod in LC.items():
        try:
            pol = mod.parse_policy(doc)
        except ValueError as e:
            got[name] = ("error", str(e))
            continue
        got[name] = (pol.to_doc(), [
            (c, rule and dataclasses.asdict(rule))
            for c in ("logs", "a", "b", "", "other")
            for rule in [pol.rule_for(c)]])
    assert got["port"] == got["jax"]


# -- planner ------------------------------------------------------------------

def _topology(seed: int):
    """A seeded collect_volume_servers() dump and its heat reports: hot
    volumes of a few collections on 1-3 holders, EC volumes with local and
    offloaded shards, read and write ages, DestroyTimes, missing reports."""
    rng = np.random.default_rng(seed)
    ids = [f"10.0.0.{i}:8080" for i in range(int(rng.integers(2, 7)))]
    vols = {sid: [] for sid in ids}
    ecs = {sid: [] for sid in ids}
    heat = {sid: {"volumes": {}, "ec_volumes": {},
                  "uptime_s": float(rng.uniform(10, 5000))} for sid in ids}
    cols = ["cool", "logs", "hot", ""]
    for vid in range(1, int(rng.integers(5, 25))):
        col = cols[int(rng.integers(0, len(cols)))]
        holders = rng.choice(ids, int(rng.integers(1, min(3, len(ids)) + 1)),
                             replace=False)
        if rng.random() < 0.5:
            size = int(rng.integers(0, 1 << 30))
            for sid in holders:
                vols[sid].append(SimpleNamespace(id=vid, collection=col,
                                                 size=size))
                heat[sid]["volumes"][str(vid)] = {
                    "last_write_age_s": (None if rng.random() < 0.1 else
                                         float(rng.uniform(0, 400))),
                    "last_read_age_s": (None if rng.random() < 0.3 else
                                        float(rng.uniform(0, 400))),
                    "tiered": bool(rng.random() < 0.1), "size": size,
                    "reads": int(rng.integers(0, 100))}
        else:
            offloaded = rng.random() < 0.5
            for sid in holders:
                ecs[sid].append(SimpleNamespace(id=vid, collection=col))
                shards = sorted(int(s) for s in rng.choice(
                    14, int(rng.integers(1, 5)), replace=False))
                heat[sid]["ec_volumes"][str(vid)] = {
                    "local_shards": [] if offloaded else shards,
                    "remote_shards": shards if offloaded else [],
                    "last_read_age_s": float(rng.uniform(0, 900)),
                    "remote_reads": int(rng.integers(0, 10)),
                    "destroy_time": (float(rng.uniform(1e9, 2e9))
                                     if rng.random() < 0.2 else 0),
                    "shard_size": int(rng.integers(1, 1 << 26)),
                    "reads": int(rng.integers(0, 100))}
    for sid in ids:
        if rng.random() < 0.15:
            heat.pop(sid)  # an unreachable server vetoes its volumes
    servers = [{"id": sid, "grpc_port": 18080, "disks": {"hdd":
               SimpleNamespace(volume_infos=vols[sid],
                               ec_shard_infos=ecs[sid])}} for sid in ids]
    return servers, heat


PLAN_POLICY = {"rules": [
    {"collection": "cool", "ec_after_s": 60, "remote_after_s": 300,
     "remote": "local:/tmp/r", "promote_reads": 3, "min_size_bytes": 100},
    {"collection": "logs", "ec_after_s": 10, "ttl_s": 3600},
    {"collection": "*", "ec_after_s": 200, "remote_after_s": 600,
     "remote": "local:/tmp/s", "promote_reads": 5, "ttl_s": 86400}]}


def _plan_doc(plan) -> dict:
    return {"transitions": [
        (t.kind, t.vid, t.collection, t.bytes_est, t.reason,
         [s["id"] for s in t.servers], t.remote, t.ttl_s, t.from_tier,
         t.to_tier) for t in plan.transitions],
        "pending_reaps": plan.pending_reaps,
        "skipped_no_heat": plan.skipped_no_heat,
        "total_bytes": plan.total_bytes}


@pytest.mark.parametrize("seed", range(6))
def test_plan_equals_reference(seed):
    servers, heat = _topology(seed)
    now = 1.7e9 + seed
    plans = {}
    for name, mod in LC.items():
        env = SimpleNamespace(collect_volume_servers=lambda: servers)
        plan = mod.build_lifecycle_plan(env, mod.parse_policy(PLAN_POLICY),
                                        heat=heat, servers=servers, now=now)
        lines = []
        plan.render(lines.append)
        plans[name] = (_plan_doc(plan), lines)
    assert plans["port"] == plans["jax"]


# -- executor -----------------------------------------------------------------

def _tr(mod, vid, kind="offload", nbytes=100, ttl_s=None):
    return mod.Transition(kind, vid, "c", nbytes, reason="test", ttl_s=ttl_s)


SCENARIOS = {
    "budget_cheapest_first": ({"max_bytes": 35, "max_concurrent": 1},
                              [(1, "offload", 10), (2, "offload", 20),
                               (3, "offload", 1000)], None),
    "oversized_untouched_budget": ({"max_bytes": 35},
                                   [(9, "offload", 10_000),
                                    (1, "offload", 10)], None),
    "count_budget": ({"max_transitions": 1},
                     [(1, "promote", 5), (2, "encode", 7)], None),
    "cooldown": ({"cooldown_s": 30.0}, [(5, "offload", 10)], "fail"),
    "lock": ({"max_concurrent": 2}, [(4, "offload", 10), (5, "promote", 10)],
             "held"),
    "stamp_without_holders": ({}, [(9, "stamp_ttl", 0)], None),
    "dry_run": ({}, [(1, "encode", 10), (2, "offload", 20)], "dry"),
}


def _decisions(name: str, kw: dict, trs, mode) -> list:
    mod = LC[name]
    ex = mod.LifecycleExecutor(SimpleNamespace(
        collect_volume_servers=lambda: []), **kw)
    ran = []

    def dispatch(t):
        ran.append((t.kind, t.vid))
        if mode == "fail":
            raise RuntimeError("remote tier down")
        return t.bytes_est

    if not any(k == "stamp_ttl" for _, k, _ in trs):
        ex._dispatch = dispatch
    if mode == "held":  # another sweep is moving volume 4
        assert ex._lock_for(("lifecycle", 4)).acquire(blocking=False)
    plan = PLANNER[name].LifecyclePlan()
    plan.transitions.extend(_tr(PLANNER[name], v, k, b, ttl_s=60 if
                                k == "stamp_ttl" else None)
                            for v, k, b in trs)

    def norm(res):
        return {k: sorted((json.dumps({a: b for a, b in d.items()
                                       if a not in ("seconds",
                                                    "retry_in_s")},
                                      sort_keys=True) for d in v))
                for k, v in res.items()}

    out = [norm(ex.execute(plan, dry_run=mode == "dry"))]
    if mode == "fail":
        out.append(norm(ex.execute(plan)))  # the cooling volume waits
    return out + [sorted(ran)]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_executor_decisions_equal_reference(scenario):
    kw, trs, mode = SCENARIOS[scenario]
    assert _decisions("port", kw, trs, mode) == \
        _decisions("jax", kw, trs, mode)


# -- live clusters ------------------------------------------------------------

GEO = (4, 2)


def _port_cluster(root, masters=1, qos=None, slo=None):
    """Port masters (a raft quorum when more than one) with their HTTP
    APIs and one port volume server on the CPU."""
    ports = [free_port_pair() for _ in range(masters)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    ms = []
    for p in ports:
        m = MasterServer(port=p, http_port=free_port_pair(),
                         volume_size_limit_mb=64, pulse_seconds=0.3,
                         peers=peers, maintenance_scripts=[],
                         ec_parity_shards=GEO[1], slo_policy=slo or "",
                         telemetry_interval_s=3600.0,
                         raft_state_path=(os.path.join(root, f"raft-{p}.json")
                                          if masters > 1 else None))
        m.start()
        ms.append(m)
    vport = free_port_pair()
    store = Store("127.0.0.1", vport, "", [DiskLocation(
        os.path.join(root, "v"), max_volume_count=16)],
        ec_geometry=EcGeometry(*GEO, large_block=1 << 20,
                               small_block=1 << 14),
        coder_name="torch", device="cpu")
    vs = VolumeServer(store, "127.0.0.1", vport, pulse_seconds=0.3,
                      qos_policy=qos)
    served = serve_volume(vs, vport + 10000, master=",".join(peers))

    def stop():
        served.stop()
        for m in ms:
            m.stop()
    return ms, vs, stop


def _jax_cluster(root):
    from seaweedfs_tpu.ec.locate import EcGeometry as RefGeometry
    from seaweedfs_tpu.master.master_server import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefServer
    from seaweedfs_tpu.storage.disk_location import DiskLocation as RefLoc
    from seaweedfs_tpu.storage.store import Store as RefStore
    m = RefMaster(port=free_port_pair(), http_port=free_port_pair(),
                  volume_size_limit_mb=64, pulse_seconds=0.3,
                  maintenance_scripts=[], ec_parity_shards=GEO[1])
    m.start()
    vport = free_port_pair()
    store = RefStore("127.0.0.1", vport, "", [RefLoc(
        os.path.join(root, "v"), max_volume_count=16)],
        ec_geometry=RefGeometry(*GEO, large_block=1 << 20,
                                small_block=1 << 14), coder_name="numpy")
    vs = RefServer(store, m.address, port=vport, grpc_port=vport + 10000,
                   pulse_seconds=0.3)
    vs.start()

    def stop():
        vs.stop()
        m.stop()
    return [m], vs, stop


def _write(mc, n: int, collection: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    blobs = {}
    deadline = time.monotonic() + 30
    while len(blobs) < n:
        try:
            a = mc.assign(collection=collection)
        except Exception:  # noqa: BLE001 — growth lags registration
            assert time.monotonic() < deadline
            time.sleep(0.2)
            continue
        data = rng.bytes(int(rng.integers(1000, 3000)))
        assert http_util.send("POST", f"http://{a.location.url}/{a.fid}",
                              data).status == 201
        blobs[a.fid] = data
    return blobs


def _read_all(url: str, blobs: dict) -> None:
    for fid, data in blobs.items():
        r = http_util.send("GET", f"http://{url}/{fid}")
        assert (r.status, r.content) == (200, data), fid


def _run(commands, env, line: str) -> str:
    env.out = io.StringIO()
    commands.run_command(env, line)
    return env.out.getvalue()


@pytest.mark.parametrize("shell,cluster", [("jax", "port"), ("port", "jax")])
def test_lifecycle_apply_moves_a_volume_of_the_other_package(
        tmp_path, shell, cluster):
    """One shell's lifecycle.apply drives the other package's master and
    volume server: hot -> EC, EC -> remote, and back on heat."""
    ms, vs, stop = (_port_cluster if cluster == "port" else _jax_cluster)(
        str(tmp_path))
    maddr = ms[0].address
    remote = tmp_path / "remote"
    remote.mkdir()
    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps({"rules": [{
        "collection": "cool", "ec_after_s": 0, "remote_after_s": 0,
        "remote": f"local:{remote}", "promote_reads": 3}]}))
    commands = ref_commands if shell == "jax" else port_commands
    mc = MasterClient(maddr).start()
    env = commands.CommandEnv(maddr, out=io.StringIO())
    try:
        wait_until(lambda: len(ms[0].topo.nodes) == 1, timeout=20,
                   msg="the volume server registered")
        blobs = _write(mc, 18, "cool", seed=15)
        vid = int(next(iter(blobs)).split(",")[0])
        wait_until(lambda: any(v.size for n in ms[0].topo.all_nodes()
                               for v in n.all_volumes()), timeout=10,
                   msg="a size heartbeat")
        _run(commands, env, "lock")
        text = _run(commands, env, f"lifecycle.apply -policy {policy} "
                                   "-dryRun")
        assert "hot->ec" in text and "dry run" in text, text
        assert vs.store.find_ec_volume(vid) is None
        text = _run(commands, env, f"lifecycle.apply -policy {policy}")
        assert "1 done" in text, text
        assert vs.store.find_volume(vid) is None
        wait_until(lambda: ms[0].topo.lookup_ec(vid), timeout=10,
                   msg="the EC shards registered")
        _read_all(vs.url, blobs)
        text = _run(commands, env, f"lifecycle.apply -policy {policy}")
        assert "1 done" in text, text
        ev = vs.store.find_ec_volume(vid)
        assert ev.remote_shard_ids() == sorted(ev.shards) and os.listdir(
            remote)
        _read_all(vs.url, blobs)
        assert ev.remote_reads() >= 3
        text = _run(commands, env, f"lifecycle.apply -policy {policy}")
        assert "1 done" in text, text
        assert vs.store.find_ec_volume(vid).remote_shard_ids() == []
        _read_all(vs.url, blobs)
        _run(commands, env, "unlock")
    finally:
        env.mc.stop()
        mc.stop()
        stop()


def test_shells_print_the_same_on_one_cluster(tmp_path, monkeypatch):
    """A raft quorum of three port masters with an SLO policy and one
    port volume server with QoS admission on: the JAX shell and the
    port's print the same lifecycle.status, cluster.top, qos.status and
    cluster.raft.ps, the collector's cycle and the clock held still."""
    slo = json.dumps({"slos": [{"name": "get-latency", "kind": "latency",
                                "verb": "get", "threshold_s": 0.001,
                                "objective": 0.9}]})
    ms, vs, stop = _port_cluster(str(tmp_path), masters=3, slo=slo,
                                 qos={"tenants": {"cool": {"rps": 1000}}})
    addrs = ",".join(m.address for m in ms)
    mc = MasterClient(addrs).start()
    envs = {}
    try:
        wait_until(lambda: sum(m.is_leader for m in ms) == 1
                   and all(m.leader_address for m in ms), timeout=15,
                   msg="one leader")
        leader = next(m for m in ms if m.is_leader)
        wait_until(lambda: len(leader.topo.nodes) == 1, timeout=20,
                   msg="the volume server registered")
        blobs = _write(mc, 12, "cool", seed=3)
        _read_all(vs.url, blobs)
        leader.telemetry.trigger()
        follower = next(m for m in ms if not m.is_leader)
        url = f"http://127.0.0.1:{follower.http_port}"  # a 421 to follow
        lines = [f"lifecycle.status -url {url}",
                 f"cluster.top -url {url} -noTrigger", "qos.status",
                 "cluster.raft.ps"]
        for mod in (telemetry_commands, port_telemetry_commands):
            monkeypatch.setattr(mod, "time", SimpleNamespace(
                time=lambda: 2e9, sleep=time.sleep))
        out = {}
        for name, commands in (("jax", ref_commands),
                               ("port", port_commands)):
            envs[name] = commands.CommandEnv(leader.address,
                                             out=io.StringIO())
            out[name] = [_run(commands, envs[name], line) for line in lines]
        assert out["port"] == out["jax"]
        text = "".join(out["port"])
        assert f"leader: {leader.address}" in text
        assert "tier census: 1 hot volume copies" in text
        assert "get-latency" in text and "qos enabled" in text
    finally:
        for env in envs.values():
            env.mc.stop()
        mc.stop()
        stop()


def test_lifecycle_round_trip_of_chip_smoke_on_cpu(tmp_path):
    """chip_smoke.py's phase 18 (the lifecycle under a raft quorum of three
    port masters, the leader killed between the encode and the offload)
    on the CPU at a 32 MB limit, its checks as fatal as on the card."""
    import chip_smoke
    res = chip_smoke.lifecycle_round_trip(
        np, str(tmp_path), 18, "cpu", limit_mb=32, fill=0.95, small=512,
        lease=256, frame=64, gets=128, promote_gets=64, hot_needles=256,
        ec_after_s=2.0, remote_after_s=8.0, device="cpu")
    assert sorted(len(s) for s in res["spread"].values()) == [3, 3, 4, 4]
    assert res["elect_s"] > 0 and res["encode"] > 0 and res["offload"] > 0
    assert res["promote"] > 0 and len(res["degraded"]) == 128
