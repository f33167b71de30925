"""The port's message queue (seaweedfs_tpu_torch/mq/, shell/mq_commands.py,
the `mq.broker` verb) against the JAX package's, on the CPU.

Pure parts on the same seeded inputs: the ring math at 1-16 partitions,
sticky balancing over membership changes, schema inference, encoding,
`schema_bytes` and the columnar path, and the segment files each
package's PartitionLog writes over LocalSegmentStore from the same
(key, value, ts) appends — byte-equal, replayed to the same offsets by
either package. Live parts over a cluster of the port (tests/
torch_cluster.py) with a port FilerServer: the reference's TestPubSub and
TestGroupConsume cases against the port's broker, publishers and
subscribers of either package against brokers of either, the mq.* shell
commands printing what the reference's print, the standalone verb durable
across a restart, and a topic whose segments sit in EC volumes with four
shards lost replayed equal through the port's plain coder.

Every stream read runs under a deadline (`torch_cluster.bounded`), every
join and subprocess wait has a timeout, and ports come from
torch_cluster."""

import hashlib
import io
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.client.master_client import MasterClient as RefMC
from seaweedfs_tpu.mq import broker as ref_broker
from seaweedfs_tpu.mq import client as ref_client
from seaweedfs_tpu.mq import schema as ref_schema
from seaweedfs_tpu.mq import sub_coordinator as ref_coord
from seaweedfs_tpu.mq import topic as ref_topic
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu.shell import mq_commands as ref_mq_commands  # noqa: F401
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.mq import broker as port_broker
from seaweedfs_tpu_torch.mq import client as port_client
from seaweedfs_tpu_torch.mq import consumer as port_consumer
from seaweedfs_tpu_torch.mq import schema as port_schema
from seaweedfs_tpu_torch.mq import sub_coordinator as port_coord
from seaweedfs_tpu_torch.mq import topic as port_topic
from seaweedfs_tpu_torch.pb import mq_pb2 as mq
from seaweedfs_tpu_torch.shell import commands as port_commands
from seaweedfs_tpu_torch.shell import fs_commands, mq_commands  # noqa: F401
from seaweedfs_tpu_torch.utils.rpc import MQ_SERVICE, Stub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BROKER = {"ref": ref_broker, "port": port_broker}
CLIENT = {"ref": ref_client, "port": port_client}


def _sub(pkg, addr, ns, topic, timeout=60.0, **kw):
    return tc.bounded(lambda: list(CLIENT[pkg].subscribe(addr, ns, topic,
                                                       **kw)), timeout)


# -- pure parts, the same seeded inputs through both packages ---------------

def _keys(seed: int, n: int = 400) -> "list[bytes]":
    rng = np.random.default_rng(seed)
    return [b""] + [rng.bytes(int(rng.integers(1, 40))) for _ in range(n)]


@pytest.mark.parametrize("count", range(1, 17))
def test_ring_math_equals_reference(count):
    parts = {pkg: m.split_ring(count) for pkg, m in
             (("ref", ref_topic), ("port", port_topic))}
    assert [(p.range_start, p.range_stop, p.ring_size)
            for p in parts["port"]] == [
        (p.range_start, p.range_stop, p.ring_size) for p in parts["ref"]]
    assert parts["port"][-1].range_stop == port_topic.RING_SIZE == 4096
    for key in _keys(count):
        assert port_topic.key_slot(key) == ref_topic.key_slot(key)
        a = port_topic.partition_for_key(key, parts["port"])
        b = ref_topic.partition_for_key(key, parts["ref"])
        assert (a.range_start, a.range_stop) == (b.range_start, b.range_stop)
    with pytest.raises(ValueError):
        port_topic.split_ring(0)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_balance_sticky_equals_reference_over_membership_changes(seed):
    """A seeded walk of joins, leaves and partition-count changes: each
    step's sticky assignment (fed the previous one) is the reference's."""
    rng = np.random.default_rng(seed)
    prev = {"ref": None, "port": None}
    members: "list[str]" = []
    n = int(rng.integers(1, 9))
    for _ in range(40):
        op = rng.integers(0, 4)
        if op == 0 or not members:
            members.append(f"c{int(rng.integers(0, 100))}")
        elif op == 1:
            members.pop(int(rng.integers(0, len(members))))
        elif op == 2:
            n = int(rng.integers(1, 9))
        ids = sorted(set(members))
        out = {}
        for pkg, m in (("ref", ref_coord), ("port", port_coord)):
            slots = [m.PartitionSlot(p.range_start, p.range_stop, p.ring_size,
                                     f"b{i % 2}")
                     for i, p in enumerate(ref_topic.split_ring(n))]
            out[pkg] = m.balance_sticky(slots, ids, prev[pkg])
            prev[pkg] = out[pkg]
        assert [(s.range_start, s.range_stop, s.broker,
                 s.assigned_instance_id) for s in out["port"]] == [
            (s.range_start, s.range_stop, s.broker, s.assigned_instance_id)
            for s in out["ref"]]


def _records(seed: int, n: int = 24) -> "list[dict]":
    rng = np.random.default_rng(seed)
    return [{"user": f"u{int(rng.integers(0, 1000))}",
             "score": float(rng.normal()),
             "visits": int(rng.integers(0, 1 << 20)),
             "big": int(rng.integers(1 << 33, 1 << 40)),
             "ok": bool(rng.integers(0, 2)),
             "blob": rng.bytes(int(rng.integers(0, 16))),
             "tags": [f"t{int(x)}" for x in rng.integers(0, 9, 3)],
             "samples": [int(x) for x in
                         rng.integers(-5, 5, int(rng.integers(1, 5)))],
             "pos": {"x": int(rng.integers(0, 99)),
                     "y": float(rng.normal())}} for _ in range(n)]


def test_schema_bytes_encoding_and_columns_equal_reference():
    recs = _records(7)
    ref = ref_schema.Schema.infer(recs[0])
    port = port_schema.Schema.infer(recs[0])
    assert port.schema_bytes() == ref.schema_bytes()
    assert port_schema.infer_record_type(recs[0]).SerializeToString() == \
        ref_schema.infer_record_type(recs[0]).SerializeToString()
    built = {pkg: (m.record_type_begin().with_field("a", m.TypeInt32)
                   .with_list_field("l", m.TypeDouble)
                   .with_record_field("r", m.record_type_begin()
                                      .with_field("s", m.TypeString))
                   .build().SerializeToString())
             for pkg, m in (("ref", ref_schema), ("port", port_schema))}
    assert built["port"] == built["ref"]
    for rec in recs:
        blob = port.encode(rec)
        assert blob == ref.encode(rec)
        assert port.decode(blob) == ref.decode(blob) == rec
    assert port_schema.Schema.from_bytes(ref.schema_bytes()).record_type == \
        port.record_type
    cols = {"port": port.to_columnar(recs), "ref": ref.to_columnar(recs)}
    assert sorted(cols["port"]) == sorted(cols["ref"])
    for k, a in cols["port"].items():
        b = cols["ref"][k]
        assert a.dtype == b.dtype, k
        assert a.tolist() == b.tolist(), k
    assert port.from_columnar(cols["port"]) == ref.from_columnar(
        cols["ref"]) == recs
    for bad in ({"user": "x"}, {**recs[0], "extra": 1}):
        with pytest.raises(KeyError):
            port.encode(bad)
        with pytest.raises(KeyError):
            ref.encode(bad)


def _appends(seed: int, n: int):
    rng = np.random.default_rng(seed)
    ts = 1_700_000_000_000_000_000
    return [(rng.bytes(int(rng.integers(0, 24))),
             rng.bytes(int(rng.integers(0, 300))),
             ts + i * 1_000 + int(rng.integers(0, 999))) for i in range(n)]


def _tree(root: str) -> "dict[str, bytes]":
    out = {}
    for d, _ds, names in os.walk(root):
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


def test_segment_files_equal_reference_and_replay_across(tmp_path):
    """The same (key, value, ts) appends through each package's
    PartitionLog over its LocalSegmentStore: the sealed segments and the
    flushed partial tail are byte-equal files, the offsets are equal, and
    each package replays the other's directory to the same offsets and
    records (timestamps are given, not stamped)."""
    tref = port_topic.TopicRef("seg", "t")
    part = port_topic.split_ring(4)[2]
    rpart = ref_topic.Partition(part.range_start, part.range_stop)
    msgs = _appends(5, 2345)
    logs = {"ref": ref_broker.PartitionLog(
                ref_topic.TopicRef("seg", "t"), rpart,
                ref_broker.LocalSegmentStore(str(tmp_path / "ref"))),
            "port": port_broker.PartitionLog(
                tref, part,
                port_broker.LocalSegmentStore(str(tmp_path / "port")))}
    offs = {pkg: [lg.append(*m) for m in msgs] for pkg, lg in logs.items()}
    assert offs["port"] == offs["ref"] == list(range(len(msgs)))
    for lg in logs.values():
        lg.flush_tail()
    trees = {pkg: _tree(str(tmp_path / pkg)) for pkg in logs}
    assert trees["port"] == trees["ref"]
    assert sorted(trees["port"]) == [
        f"topics/seg/t/2048-3072/seg-{n:06d}" for n in range(3)]
    for pkg, store_pkg in (("port", "ref"), ("ref", "port")):
        store = BROKER[pkg].LocalSegmentStore(str(tmp_path / store_pkg))
        mtopic = ref_topic if pkg == "ref" else port_topic
        again = BROKER[pkg].PartitionLog(
            mtopic.TopicRef("seg", "t"),
            mtopic.Partition(part.range_start, part.range_stop), store)
        assert again.next_offset == len(msgs)
        assert again.base_offset == 2000 and len(again.messages) == 345
        got = []
        off = 0
        while off < len(msgs):
            batch = again.read(off)
            assert batch, off
            got += batch
            off = batch[-1][0] + 1
        assert got == [(i, k, v, ts) for i, (k, v, ts) in enumerate(msgs)]


def test_replayed_tail_is_not_uploaded_again(tmp_path):
    """Queue 3: the reference's broker, replaying a partition whose last
    segment is partial, writes that segment again, unchanged, at its
    first tail flush (the flusher's tick or stop()); the port's writes
    nothing, and both replay the same records afterwards."""
    writes = {}
    for pkg in ("ref", "port"):
        m, mtopic = BROKER[pkg], (ref_topic if pkg == "ref" else port_topic)

        class Counting(m.LocalSegmentStore):
            def write_file(self, path, data, **kw):
                writes[pkg] = writes.get(pkg, 0) + 1
                return super().write_file(path, data, **kw)

        root = str(tmp_path / pkg)
        lg = m.PartitionLog(mtopic.TopicRef("q3", "t"),
                            mtopic.Partition(0, 4096), Counting(root))
        for k, v, ts in _appends(9, 1205):
            lg.append(k, v, ts)
        lg.flush_tail()
        before = _tree(root)
        writes[pkg] = 0
        again = m.PartitionLog(mtopic.TopicRef("q3", "t"),
                               mtopic.Partition(0, 4096), Counting(root))
        again.flush_tail()
        again.flush_tail()
        assert _tree(root) == before
        assert again.next_offset == 1205
    assert writes == {"ref": 1, "port": 0}


# -- a live cluster of the port ---------------------------------------------

def _cluster(tmp_path_factory, name):
    root = tmp_path_factory.mktemp(name)
    c = tc.start(root, volume_size_limit_mb=64)
    fs = FilerServer(c["master"].address, store_spec="memory",
                     port=tc.free_port_pair(), chunk_size_mb=1,
                     chunk_cache_mb=1).start()
    return c, fs


def _live(ms_addr, ctype="broker"):
    from seaweedfs_tpu_torch.pb import master_pb2 as mpb
    from seaweedfs_tpu_torch.utils.rpc import MASTER_SERVICE
    nodes = Stub(ms_addr, MASTER_SERVICE).call(
        "ListClusterNodes", mpb.ListClusterNodesRequest(client_type=ctype),
        mpb.ListClusterNodesResponse, timeout=5).cluster_nodes
    return sorted(n.address for n in nodes)


@pytest.fixture(scope="module")
def lone_master():
    """A port master of no volume server, for brokers that must be the
    only live broker (ownership hashes over every live broker of a
    master); each such test waits for `_alone` first."""
    from seaweedfs_tpu_torch.master.master_server import MasterServer
    ms = MasterServer(port=tc.free_port_pair(), pulse_seconds=0.3,
                      maintenance_scripts=[])
    ms.start()
    yield ms
    ms.stop()


def _alone(ms_addr: str, broker=None, addr: str = "") -> None:
    """Wait until the master lists exactly this broker (brokers stopped by
    earlier tests drop off within ~1 s) and its own view agrees."""
    addr = addr or broker.address
    tc.wait_until(lambda: _live(ms_addr) == [addr], timeout=20,
                  msg=f"{addr} the only live broker")
    if broker is not None:
        broker._broker_cache = (0.0, [])
        tc.wait_until(lambda: broker.live_brokers() == [addr], timeout=10,
                      msg="the broker's own view")


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    c, fs = _cluster(tmp_path_factory, "mq")
    broker = port_broker.BrokerServer(c["master"].address,
                                      port=tc.free_port_pair(),
                                      filer_server=fs).start()
    yield {"c": c, "ms": c["master"], "fs": fs, "broker": broker}
    broker.stop()
    fs.stop()
    tc.stop(c)


class TestPubSub:
    """The reference's tests/test_mq.py TestPubSub against the port."""

    def test_publish_subscribe_roundtrip(self, stack):
        b = stack["broker"]
        pub = port_client.Publisher(b.address, "chat", "room1")
        offsets = tc.bounded(lambda: [pub.publish(f"k{i}".encode(),
                                                f"msg-{i}".encode())
                                    for i in range(10)])
        assert offsets == list(range(10))
        pub.close()
        got = _sub("port", b.address, "chat", "room1", start_offset=0)
        assert [(o, v) for o, _, v in got] == \
            [(i, f"msg-{i}".encode()) for i in range(10)]

    def test_subscribe_follow_tail(self, stack):
        b = stack["broker"]
        pub = port_client.Publisher(b.address, "chat", "live")
        pub.publish(b"k", b"old")
        received = []
        done = threading.Event()

        def consumer():
            for _off, _k, v in port_client.subscribe(
                    b.address, "chat", "live", start_offset=0, follow=True):
                received.append(v)
                if v == b"stop":
                    done.set()
                    return

        t = threading.Thread(target=consumer, daemon=True)
        t.start()
        time.sleep(0.3)
        tc.bounded(lambda: (pub.publish(b"k", b"new1"),
                          pub.publish(b"k", b"stop")))
        assert done.wait(10), f"got {received}"
        t.join(10)
        assert received == [b"old", b"new1", b"stop"]
        pub.close()

    def test_multi_partition_routing(self, stack):
        b = stack["broker"]
        pub = port_client.Publisher(b.address, "metrics", "cpu",
                                    partition_count=4)
        assert len(pub.partitions) == 4
        tc.bounded(lambda: [pub.publish(f"host-{i}".encode(), f"v{i}".encode())
                          for i in range(40)])
        pub.close()
        total = sum(len(_sub("port", b.address, "metrics", "cpu",
                             start_offset=0, partition=p))
                    for p in port_topic.split_ring(4))
        assert total == 40

    def test_segments_persist_and_replay(self, stack):
        b, fs = stack["broker"], stack["fs"]
        pub = port_client.Publisher(b.address, "logs", "app")
        tc.bounded(lambda: [pub.publish(b"k", f"line-{i}".encode())
                          for i in range(1500)], 120)
        pub.close()
        segs = [e.name for e in fs.filer.list_entries(
            "/topics/logs/app/0000-4096")]
        assert any(s.startswith("seg-") for s in segs)
        b2 = port_broker.BrokerServer(stack["ms"].address,
                                      port=tc.free_port_pair(),
                                      filer_server=fs).start()
        try:
            got = _sub("port", b2.address, "logs", "app", start_offset=0)
            assert len(got) >= 1000
            assert got[0][2] == b"line-0" and got[999][2] == b"line-999"
        finally:
            b2.stop()

    def test_acked_tail_survives_restart(self, stack):
        fs, ms = stack["fs"], stack["ms"]
        b1 = port_broker.BrokerServer(ms.address, port=tc.free_port_pair(),
                                      filer_server=fs).start()
        pub = port_client.Publisher(b1.address, "audit", "trail")
        tc.bounded(lambda: [pub.publish(b"k", f"ev-{i}".encode())
                          for i in range(1205)], 120)
        pub.close()
        lg = next(lg for key, lg in b1.logs.items() if "audit" in key[0])
        assert lg.base_offset == 1000 and len(lg.messages) == 205
        b1.stop()
        b2 = port_broker.BrokerServer(ms.address, port=tc.free_port_pair(),
                                      filer_server=fs).start()
        try:
            got = _sub("port", b2.address, "audit", "trail", start_offset=0)
            assert len(got) == 1205 and got[-1][2] == b"ev-1204"
            old = _sub("port", b2.address, "audit", "trail",
                       start_offset=500)
            assert old[0][0] == 500 and old[0][2] == b"ev-500"
        finally:
            b2.stop()

    def test_lookup_unknown_topic(self, stack):
        import grpc
        with pytest.raises(grpc.RpcError):
            _sub("port", stack["broker"].address, "nope", "nope")


@pytest.mark.parametrize("broker_pkg,client_pkg", [
    ("ref", "port"), ("port", "ref"), ("ref", "ref"), ("port", "port")])
def test_publishers_and_subscribers_across_packages(lone_master, tmp_path,
                                                    broker_pkg, client_pkg):
    """Publisher and subscribe of one package against the broker of the
    other (and each against its own): offsets, keys and values equal, in
    four partitions, with a sealed segment read back from the broker's
    store."""
    b = BROKER[broker_pkg].BrokerServer(
        lone_master.address, port=tc.free_port_pair(),
        data_dir=str(tmp_path / "segs")).start()
    try:
        _alone(lone_master.address, b)
        pub = CLIENT[client_pkg].Publisher(b.address, "x", "pkg",
                                           partition_count=4)
        rng = np.random.default_rng(3)
        sent = [(f"key-{int(rng.integers(0, 64))}".encode(), rng.bytes(64))
                for _ in range(1300)]
        acks = tc.bounded(lambda: [pub.publish(k, v) for k, v in sent], 120)
        pub.close()
        by_part: "dict[int, list]" = {}
        for (k, v), off in zip(sent, acks):
            p = port_topic.partition_for_key(k, port_topic.split_ring(4))
            by_part.setdefault(p.range_start, []).append((off, k, v))
        for p in port_topic.split_ring(4):
            got = _sub(client_pkg, b.address, "x", "pkg", start_offset=0,
                       partition=p)
            assert got == by_part.get(p.range_start, [])
            assert [o for o, _, _ in got] == list(range(len(got)))
    finally:
        b.stop()


def _shell_envs(stack):
    ref_mc = RefMC(stack["ms"].address).start()
    ref_mc.wait_connected(10)
    return ref_mc, {
        "ref": ref_commands.CommandEnv(stack["ms"].address, mc=ref_mc,
                                       out=io.StringIO()),
        "port": port_commands.CommandEnv(stack["ms"].address,
                                         mc=stack["c"]["mc"],
                                         out=io.StringIO())}


def test_mq_shell_commands_print_as_the_reference(stack):
    """mq.topic.configure / list / desc (with a consumer group and its
    committed offsets) and mq.balance, each line through the JAX shell
    and then the port's, against the port's broker: equal output."""
    b = stack["broker"]
    pub = port_client.Publisher(b.address, "shellns", "t1")
    tc.bounded(lambda: [pub.publish(f"k{i}".encode(), b"v") for i in range(6)])
    pub.close()
    got = tc.bounded(lambda: port_consumer.group_consume(
        b.address, "shellns", "t1", "g1", "m1", 6, timeout=30), 60)
    assert len(got) == 6
    tc.wait_until(lambda: _live(stack["ms"].address) == [b.address],
                  timeout=20, msg="one live broker")
    ref_mc, envs = _shell_envs(stack)
    try:
        for line in (f"mq.topic.configure -broker {b.address} "
                     "-topic shellns/t2 -partitions 2",
                     f"mq.topic.list -broker {b.address}",
                     f"mq.topic.desc -broker {b.address} -topic shellns/t2",
                     f"mq.topic.desc -broker {b.address} -topic shellns/t1",
                     "mq.topic.describe -topic shellns/t1",
                     "mq.balance",
                     "mq.topic.list"):
            outs = {}
            for pkg, mod in (("ref", ref_commands), ("port", port_commands)):
                envs[pkg].out = io.StringIO()
                tc.bounded(lambda: mod.run_command(envs[pkg], line))
                outs[pkg] = envs[pkg].out.getvalue()
            assert outs["port"] == outs["ref"], line
            assert outs["port"].strip(), line
        assert "shellns/t2" in outs["port"]
    finally:
        ref_mc.stop()


def test_cluster_check_pings_the_broker(stack):
    tc.wait_until(lambda: _live(stack["ms"].address) ==
                  [stack["broker"].address], timeout=20,
                  msg="one live broker")
    out = tc.shell(stack["c"], "cluster.check")
    assert f"broker {stack['broker'].address}: ok" in out, out


def test_standalone_broker_verb_is_durable_across_a_restart(lone_master,
                                                           tmp_path):
    """`python -m seaweedfs_tpu_torch mq.broker -dir D`: 1,200 messages
    published, SIGTERM (a clean stop flushes the tail), the verb started
    again over D serves all 1,200; D holds the reference's layout."""
    port = tc.free_port_pair()
    addr = f"127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "seaweedfs_tpu_torch", "mq.broker",
           "-port", str(port), "-master", lone_master.address,
           "-dir", str(tmp_path / "mq")]

    def start():
        p = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        tc.wait_until(lambda: Stub(addr, MQ_SERVICE).call(
            "Ping", mq.PingRequest(), mq.PingResponse, timeout=2),
            timeout=60, msg="the mq.broker verb")
        _alone(lone_master.address, addr=addr)
        return p

    def stop(p):
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=30)
        assert p.returncode == 0, out
        return out

    p = start()
    try:
        pub = port_client.Publisher(addr, "dur", "p1")
        tc.bounded(lambda: [pub.publish(b"k", f"m-{i}".encode())
                          for i in range(1200)], 120)
        pub.close()
    finally:
        said = stop(p)
    assert f"mq broker {addr}" in said
    assert sorted(os.listdir(tmp_path / "mq/topics/dur/p1/0000-4096")) == [
        "seg-000000", "seg-000001"]
    p = start()
    try:
        got = _sub("port", addr, "dur", "p1", start_offset=0)
        assert len(got) == 1200
        assert got[0][2] == b"m-0" and got[-1][2] == b"m-1199"
    finally:
        stop(p)


# -- consumer groups over two brokers ---------------------------------------

@pytest.fixture(scope="module")
def groups_stack(tmp_path_factory):
    c, fs = _cluster(tmp_path_factory, "mq-groups")
    yield {"c": c, "ms": c["master"], "fs": fs}
    fs.stop()
    tc.stop(c)


@pytest.fixture()
def two_brokers(groups_stack):
    """Two port brokers sharing the port filer (segments and committed
    offsets live there), each seeing exactly the two live brokers."""
    ms = groups_stack["ms"]
    brokers = [port_broker.BrokerServer(ms.address, port=tc.free_port_pair(),
                                        filer_server=groups_stack["fs"],
                                        rebalance_delay_s=0.2)
               for _ in range(2)]
    for b in brokers:
        b.membership_poll_s = 0.2
        b.start()
    want = sorted(b.address for b in brokers)

    def settled():
        for b in brokers:
            b._broker_cache = (0.0, [])
        return all(b.live_brokers() == want for b in brokers)
    tc.wait_until(settled, timeout=20, msg="two live brokers")
    yield brokers
    for b in brokers:
        if not b._stop.is_set():
            b.stop()


def _drain(consumers, want: int, commit: bool = True, timeout: float = 30.0,
           seen=None):
    """The reference's _drain: round-robin poll until `want` new
    (partition, offset) pairs, no duplicate allowed."""
    got = {}
    seen = seen if seen is not None else set()
    deadline = time.monotonic() + timeout
    while len(got) < want and time.monotonic() < deadline:
        for c in consumers:
            rec = c.poll(timeout=0.2)
            if rec is None:
                continue
            key = (rec.partition.range_start, rec.offset)
            assert key not in seen, f"duplicate delivery {key}"
            seen.add(key)
            got[key] = rec.value
            if commit:
                c.commit(rec)
    return got


class TestGroupConsume:
    """The reference's tests/test_mq_groups.py TestGroupConsume against the
    port's brokers and consumer."""

    def test_two_members_split_partitions_and_rebalance(self, two_brokers):
        addrs = [b.address for b in two_brokers]
        pub = port_client.Publisher(addrs, "grp", "orders",
                                    partition_count=4)
        tc.bounded(lambda: [pub.publish(f"k{i}".encode(), f"v{i}".encode())
                          for i in range(40)])
        c1 = port_consumer.GroupConsumer(addrs, "grp", "orders", "w", "w1")
        c2 = port_consumer.GroupConsumer(addrs, "grp", "orders", "w", "w2")
        try:
            assert c1.wait_assigned(30) and c2.wait_assigned(30)
            tc.wait_until(lambda: len(c1.assigned) == len(c2.assigned) == 2,
                          timeout=30, msg="a 2/2 split")
            assert set(c1.assigned).isdisjoint(c2.assigned)
            seen = set()
            got = _drain([c1, c2], 40, seen=seen)
            assert sorted(got.values()) == sorted(
                f"v{i}".encode() for i in range(40))
            c2.close()
            tc.wait_until(lambda: len(c1.assigned) == 4, timeout=30,
                          msg="the survivor owns all four")
            tc.bounded(lambda: [pub.publish(f"k{i}".encode(),
                                          f"v{i}".encode())
                              for i in range(40, 60)])
            got2 = _drain([c1], 20, seen=seen)
            assert sorted(got2.values()) == sorted(
                f"v{i}".encode() for i in range(40, 60))
        finally:
            pub.close()
            c1.close()
            c2.close()

    def test_broker_killed_mid_stream_group_resumes(self, two_brokers):
        b1, b2 = two_brokers
        addrs = [b1.address, b2.address]
        pub = port_client.Publisher(addrs, "grp", "events",
                                    partition_count=4)
        tc.bounded(lambda: [pub.publish(f"k{i}".encode(), f"v{i}".encode())
                          for i in range(100)])
        for b in (b1, b2):
            for lg in list(b.logs.values()):
                lg.flush_tail()
        c1 = port_consumer.GroupConsumer(addrs, "grp", "events", "r", "r1")
        c2 = port_consumer.GroupConsumer(addrs, "grp", "events", "r", "r2")
        try:
            assert c1.wait_assigned(30) and c2.wait_assigned(30)
            seen = set()
            got = _drain([c1, c2], 60, seen=seen)
            b1.kill()
            got.update(_drain([c1, c2], 40, seen=seen))
            assert sorted(got.values()) == sorted(
                f"v{i}".encode() for i in range(100))
            tc.bounded(lambda: [pub.publish(f"k{i}".encode(),
                                          f"v{i}".encode())
                              for i in range(100, 150)])
            got3 = _drain([c1, c2], 50, seen=seen)
            assert sorted(got3.values()) == sorted(
                f"v{i}".encode() for i in range(100, 150))
            for _p, leader in b2._group_partitions("grp.events"):
                assert leader == b2.address
        finally:
            pub.close()
            c1.close()
            c2.close()

    def test_describe_groups_and_typed_records(self, two_brokers):
        """DescribeConsumerGroups names one coordinator with the member,
        its four partitions and committed offsets covering every record; a
        schema registered through one broker is served by the other, and
        typed records read back decoded by the reference's Schema too."""
        addrs = [b.address for b in two_brokers]
        pub = port_client.Publisher(addrs, "vis", "events", partition_count=4)
        tc.bounded(lambda: [pub.publish(f"k{i}".encode(), f"v{i}".encode())
                          for i in range(8)])
        pub.close()
        c1 = port_consumer.GroupConsumer(addrs, "vis", "events", "viewers",
                                         "v1")
        try:
            assert c1.wait_assigned(30)
            _drain([c1], 8)
            merged = []
            for addr in addrs:
                merged.extend(Stub(addr, MQ_SERVICE).call(
                    "DescribeConsumerGroups",
                    mq.DescribeConsumerGroupsRequest(
                        topic=mq.Topic(namespace="vis", name="events")),
                    mq.DescribeConsumerGroupsResponse, timeout=5).groups)
        finally:
            c1.close()
        assert len(merged) == 1
        g = merged[0]
        assert g.name == "viewers" and g.generation >= 1
        assert sum(po.committed + 1 for po in g.offsets
                   if po.committed >= 0) == 8

        schema = port_schema.Schema.infer({"device": "d0", "temp": 0.0,
                                           "n": 0})
        tpub = port_client.Publisher(addrs, "typed", "metrics",
                                     partition_count=2, schema=schema)
        rows = [{"device": f"d{i % 2}", "temp": i * 1.5, "n": i}
                for i in range(6)]
        tc.bounded(lambda: [tpub.publish_record(r["device"].encode(), r)
                          for r in rows])
        tpub.close()
        fetched = port_client.topic_schema(addrs[1], "typed", "metrics")
        assert fetched.schema_bytes() == schema.schema_bytes()
        ref_fetched = ref_client.topic_schema(addrs[0], "typed", "metrics")
        got = []
        for p in tpub.partitions:
            lead = tpub._leaders.get(p.range_start, addrs[0])
            for _, _, v in _sub("port", lead, "typed", "metrics",
                                start_offset=0, partition=p):
                assert ref_fetched.decode(v) == fetched.decode(v)
                got.append(fetched.decode(v))
        assert sorted(got, key=lambda r: r["n"]) == rows
        port_client.Publisher(addrs, "typed", "raw").close()
        assert port_client.topic_schema(addrs[0], "typed", "raw") is None


def test_closed_member_releases_its_subscribe_streams(lone_master,
                                                     monkeypatch):
    """Queue 3: a GroupConsumer closed on a quiet topic. The reference's
    partition workers notice their stop only at the next record, so their
    Subscribe streams stay open and keep a broker worker thread each
    (its handler polls the log every 0.5 s) until the broker stops; the
    port's cancel theirs, and the broker's handlers end."""
    from seaweedfs_tpu.mq import consumer as ref_consumer
    b = port_broker.BrokerServer(lone_master.address,
                                 port=tc.free_port_pair(),
                                 rebalance_delay_s=0.1).start()
    try:
        _alone(lone_master.address, b)
        pub = port_client.Publisher(b.address, "quiet", "t",
                                    partition_count=2)
        tc.bounded(lambda: [pub.publish(f"k{i}".encode(), b"v")
                          for i in range(8)])
        pub.close()
        calls: "list[float]" = []
        real = port_broker.PartitionLog.wait_for

        def counting(self, offset, timeout):
            calls.append(time.monotonic())
            return real(self, offset, timeout)
        monkeypatch.setattr(port_broker.PartitionLog, "wait_for", counting)
        held = {}
        for pkg, mod in (("port", port_consumer), ("ref", ref_consumer)):
            c = mod.GroupConsumer(b.address, "quiet", "t", f"g-{pkg}", "m1")
            try:
                assert c.wait_assigned(30)
                got = _drain([c], 8, commit=False)
                assert len(got) == 8
            finally:
                c.close()
            time.sleep(1.0)
            t = time.monotonic()
            time.sleep(1.5)
            held[pkg] = sum(1 for x in calls if x > t)
        assert held["port"] == 0 and held["ref"] > 0, held
    finally:
        b.stop()


# -- a topic on EC volumes with four shards lost ----------------------------

def test_topic_replays_from_ec_volumes_with_four_shards_lost(stack,
                                                            lone_master):
    """A topic in collection mqec (fs.configure -locationPrefix /topics/),
    its broker stopped cleanly; the volumes sealed at RS(10,4) by the
    port's shell, shards 0, 5, 10 and 13 unmounted on every holder: a new
    broker replays every partition equal to what was published (sha256
    over offset, key and value), the servers reconstructing through the
    port's plain coder on the CPU."""
    c, fs = stack["c"], stack["fs"]
    out = tc.shell(c, f"fs.configure -filer {fs.url} -locationPrefix "
                      "/topics/ec/ -collection mqec -apply")
    assert "applied" in out, out
    b = port_broker.BrokerServer(lone_master.address,
                                 port=tc.free_port_pair(),
                                 filer_server=fs).start()
    _alone(lone_master.address, b)
    rng = np.random.default_rng(23)
    sent = [(f"dev-{int(rng.integers(0, 32))}".encode(), rng.bytes(1024))
            for _ in range(2600)]
    try:
        pub = port_client.Publisher(b.address, "ec", "t", partition_count=2)
        acks = tc.bounded(lambda: [pub.publish(k, v) for k, v in sent], 180)
        pub.close()
    finally:
        b.stop()
    want: "dict[int, hashlib._Hash]" = {}
    for (k, v), off in zip(sent, acks):
        p = port_topic.partition_for_key(k, port_topic.split_ring(2))
        want.setdefault(p.range_start, hashlib.sha256()).update(
            off.to_bytes(8, "little") + k + v)
    for served in c["served"].values():
        served.vs.heartbeat_flush()
    vids = set()
    tc.wait_until(lambda: vids.update(
        v.id for dc in c["mc"].volume_list().topology_info.data_center_infos
        for rk in dc.rack_infos for dn in rk.data_node_infos
        for d in dn.disk_infos.values() for v in d.volume_infos
        if v.collection == "mqec" and v.size > 8) or vids,
        msg="mqec volumes")
    out = tc.shell(c, "lock", *[f"ec.encode -volumeId {v}"
                                for v in sorted(vids)], "unlock")
    assert "error" not in out.lower(), out
    for v in vids:
        tc.wait_until(lambda v=v: len(c["mc"].lookup_ec(v)) == 14,
                      timeout=30, msg=f"volume {v}'s shards")
    for served in c["served"].values():
        for v in vids:
            if served.vs.store.find_ec_volume(v) is not None:
                served.vs.volume_ec_shards_unmount(v, [0, 5, 10, 13])
    r0 = sum(s.vs.read_stats.get("reconstructs", 0)
             for s in c["served"].values())
    b2 = port_broker.BrokerServer(lone_master.address,
                                  port=tc.free_port_pair(),
                                  filer_server=fs).start()
    try:
        _alone(lone_master.address, b2)
        total = 0
        for p in port_topic.split_ring(2):
            got = _sub("port", b2.address, "ec", "t", start_offset=0,
                       partition=p, timeout=120)
            h = hashlib.sha256()
            for off, k, v in got:
                h.update(off.to_bytes(8, "little") + k + v)
            assert h.hexdigest() == want[p.range_start].hexdigest()
            total += len(got)
        assert total == len(sent)
    finally:
        b2.stop()
    assert sum(s.vs.read_stats.get("reconstructs", 0)
               for s in c["served"].values()) > r0
