"""A cluster of the port alone (seaweedfs_tpu_torch only, device="cpu"):
the port's master with four port volume servers in racks r1-r4 over gRPC
(tests/torch_cluster.py), through the operator's EC flow in order: writes
and `lock; ec.encode; unlock` with the rack-capped spread; rack r1 lost,
DEGRADED with exactly its shards missing, degraded reads, one
AdminCron.trigger() back to OK with byte-equal rebuilt shards;
volume.scrub finding exactly the damage; ec.decode. Then the options
and routes of the master's last planes (a raft quorum, SLO and telemetry
options, a lifecycle policy, /cluster/telemetry and /debug/lifecycle),
and the shell and cron lines of commands still unported."""

import time

import pytest

import torch_cluster as tc
from seaweedfs_tpu_torch.client import http_util
from seaweedfs_tpu_torch.master.master_server import MasterServer
from seaweedfs_tpu_torch.shell import mq_commands  # noqa: F401 (register)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("port_cluster"))
    try:
        yield c
    finally:
        tc.stop(c)


def test_writes_encode_and_rack_capped_spread(cluster):
    tc.write_and_encode(cluster)


def test_rack_loss_degrades_then_cron_repairs(cluster):
    tc.lose_rack_and_repair(cluster)


def test_volume_scrub_finds_exactly_the_damage(cluster):
    tc.scrub(cluster)


def test_ec_decode_round_trip(cluster):
    tc.decode(cluster)


@pytest.mark.parametrize("kwargs,needs", [
    ({"peers": ["127.0.0.1:1", "127.0.0.1:2"]}, "master/raft.py"),
    ({"slo_policy": '{"objectives": []}'}, "telemetry/"),
    ({"telemetry_interval_s": 15.0}, "telemetry/"),
    ({"lifecycle_policy": "policy.json"}, "lifecycle/"),
])
def test_unported_master_options_refuse(kwargs, needs):
    """The options the port's master once refused now run: it starts,
    reports the option through the module it needs, and stops. A quorum
    whose peers cannot be reached elects no one and says so."""
    ms = MasterServer(port=tc.free_port_pair(),
                      http_port=tc.free_port_pair(), **kwargs)
    ms.start()
    try:
        base = f"http://127.0.0.1:{ms.http_port}"
        if needs == "master/raft.py":
            assert ms.raft is not None and ms._follower is not None
            time.sleep(1.0)  # past two election timeouts
            st = http_util.get(f"{base}/cluster/status").json()
            assert st["IsLeader"] is False and not st["leader"]
            assert st["Peers"] == kwargs["peers"]
            assert http_util.get(f"{base}/cluster/telemetry").status == 421
        elif needs == "telemetry/":
            snap = http_util.get(f"{base}/cluster/telemetry?trigger=1").json()
            assert snap["leader"] is True and snap["cycles"] >= 1
            assert snap["interval_s"] == kwargs.get("telemetry_interval_s",
                                                    15.0)
            assert [(t["node"], t["stale"]) for t in snap["targets"]] == [
                (f"master@{ms.address}", False)]
            assert (ms.slo_policy_source or None) == kwargs.get("slo_policy")
            assert ms.health.extra_items == ms.telemetry.health_items
        else:
            assert ms.admin_cron.scripts[-1] == \
                "lifecycle.apply -policy policy.json"
            doc = http_util.get(f"{base}/debug/lifecycle").json()
            assert doc["source"] == "policy.json" and doc["policy"] is None
            assert "policy.json" in doc["policy_error"]
    finally:
        ms.stop()


def test_single_peer_quorum_is_a_plain_master():
    ms = MasterServer(port=19333, peers=["127.0.0.1:19333"])
    assert ms.raft is None and ms.is_leader


@pytest.fixture
def mount_socket(tmp_path):
    """A mount's control socket over a stand-in that keeps the quota; the
    mount directory."""
    from seaweedfs_tpu_torch.mount.control import (mount_socket_path,
                                                   serve_mount_control)

    class Quota:
        collection_capacity = 0

        def configure(self, cap):
            self.collection_capacity = cap

    mnt = str(tmp_path / "mnt")
    stop = serve_mount_control(Quota(), mount_socket_path(mnt))
    yield mnt
    stop()


def test_unported_routes_and_commands_are_absent(cluster, mount_socket):
    """/cluster/telemetry and /debug/lifecycle answer on the port's
    master; cluster.check runs (it pings the volume servers, and the
    filers and brokers the master lists: none here); mq.balance runs and
    finds no broker; mount.configure (ported last) reaches a mount's
    control socket; a line of a command neither package has prints
    "unknown command" in the shell and in the cron."""
    from seaweedfs_tpu_torch.shell import remote_commands  # noqa: F401
    c, mnt = cluster, mount_socket
    snap = http_util.get(f"http://{c['http']}/cluster/telemetry").json()
    assert snap["leader"] is True
    doc = http_util.get(f"http://{c['http']}/debug/lifecycle").json()
    assert doc["policy"] is None and "recent" in doc
    assert http_util.get(f"http://{c['http']}/cluster/linkcosts").ok
    quota = f"mount.configure -dir {mnt} -quotaMB 8"
    out = tc.shell(c, "cluster.check -failOn never", "remote.nosuch", quota,
                   "lifecycle.status", "mq.balance")
    assert "unknown command 'remote.nosuch'" in out
    assert f"{mnt}: collection capacity 8 MB" in out
    assert "no live broker in the cluster" in out
    assert " volume servers healthy" in out
    assert "cluster verdict: " in out
    assert "unknown command 'cluster.check'" not in out
    assert "unknown command 'lifecycle.status'" not in out
    assert "tier census" in out
    # the cron's script lines resolve in the port's tables alike
    cron = c["master"].admin_cron
    saved, fetch = cron.scripts, cron.health_fetch
    cron.scripts, cron.health_fetch = ["remote.nosuch", quota,
                                       "mq.balance"], None
    try:
        cron.trigger()
    finally:
        cron.scripts, cron.health_fetch = saved, fetch
    assert "unknown command 'remote.nosuch'" in cron.last_output
    assert f"{mnt}: collection capacity 8 MB" in cron.last_output
    assert "no live broker in the cluster" in cron.last_output
