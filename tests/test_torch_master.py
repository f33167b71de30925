"""A cluster of the port alone (seaweedfs_tpu_torch only, device="cpu"):
the port's master with four port volume servers in racks r1-r4 over gRPC
(tests/torch_cluster.py), through the operator's EC flow in order: writes
and `lock; ec.encode; unlock` with the rack-capped spread; rack r1 lost,
DEGRADED with exactly its shards missing, degraded reads, one
AdminCron.trigger() back to OK with byte-equal rebuilt shards;
volume.scrub finding exactly the damage; ec.decode. Then the loud
refusals of what is not ported: a raft quorum, SLO and telemetry options,
a lifecycle policy, the HTTP routes that need them, and the shell and
cron lines of unported commands."""

import pytest

import torch_cluster as tc
from seaweedfs_tpu_torch.client import http_util
from seaweedfs_tpu_torch.master.master_server import MasterServer


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
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 3") as e:
        MasterServer(port=tc.free_port_pair(), **kwargs)
    assert needs in str(e.value)


def test_single_peer_quorum_is_a_plain_master():
    ms = MasterServer(port=19333, peers=["127.0.0.1:19333"])
    assert ms.raft is None and ms.is_leader


def test_unported_routes_and_commands_are_absent(cluster):
    c = cluster
    for route in ("/cluster/telemetry", "/debug/lifecycle"):
        assert http_util.get(f"http://{c['http']}{route}").status == 404
    assert http_util.get(f"http://{c['http']}/cluster/linkcosts").ok
    out = tc.shell(c, "cluster.check", "fs.ls /", "lifecycle.apply")
    for name in ("cluster.check", "fs.ls", "lifecycle.apply"):
        assert f"unknown command {name!r}" in out
    # the cron's script lines resolve in the port's tables alike
    cron = c["master"].admin_cron
    saved, fetch = cron.scripts, cron.health_fetch
    cron.scripts, cron.health_fetch = ["mq.topic.list"], None
    try:
        cron.trigger()
    finally:
        cron.scripts, cron.health_fetch = saved, fetch
    assert "unknown command 'mq.topic.list'" in cron.last_output
