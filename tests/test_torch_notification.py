"""The port's notification queues (seaweedfs_tpu_torch/notification/,
utils/mini_kafka.py, the shell's fs.meta.notify and the `filer.replicate`
verb) against the JAX package's, on the CPU.

MemoryQueue fan-out; LogFileQueue files written by each package's Filer for
the same seeded operations, equal once the fields the filer stamps itself
are masked: the `mtime` and `crtime` of the directories it makes on its
own (both filers get one signature, so nothing else differs);
`open_queue`'s specs and errors; Kafka RecordBatches byte-equal with the
clock pinned (`time.time`, the batch's first and max timestamps); each
package's KafkaQueue into each package's MiniKafka (no CRC failure, a
corrupt batch refused by both); the `mq:` queue into the port's broker;
fs.meta.notify printing and queueing what the reference's does; the
`filer.replicate` verb mirroring a notified tree into a local sink and
resuming from its offset. Phase 23 of chip_smoke.py runs at a small size
in tests/test_torch_mq_smoke.py.

Every wait is bounded and every port comes from torch_cluster."""

import io
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_cluster as tc
from seaweedfs_tpu.client.master_client import MasterClient as RefMC
from seaweedfs_tpu.filer import filer as ref_filer
from seaweedfs_tpu.filer import store as ref_store
from seaweedfs_tpu.notification import kafka as ref_kafka
from seaweedfs_tpu.notification import queues as ref_queues
from seaweedfs_tpu.pb import filer_pb2 as ref_fpb
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu.shell import fs_commands as ref_fs  # noqa: F401
from seaweedfs_tpu.utils import mini_kafka as ref_mini
from seaweedfs_tpu_torch.filer import filer as port_filer
from seaweedfs_tpu_torch.filer import store as port_store
from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.mq import broker as port_broker
from seaweedfs_tpu_torch.mq import client as port_client
from seaweedfs_tpu_torch.notification import kafka as port_kafka
from seaweedfs_tpu_torch.notification import queues as port_queues
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.shell import commands as port_commands
from seaweedfs_tpu_torch.shell import fs_commands  # noqa: F401
from seaweedfs_tpu_torch.utils import mini_kafka as port_mini

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUES = {"ref": ref_queues, "port": port_queues}
KAFKA = {"ref": ref_kafka, "port": port_kafka}
MINI = {"ref": ref_mini, "port": port_mini}
FPB = {"ref": ref_fpb, "port": fpb}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_memory_queue_fans_out_to_every_subscriber(pkg):
    q = QUEUES[pkg].MemoryQueue()
    got: "dict[int, list]" = {0: [], 1: []}
    q.subscribe(lambda k, ev: got[0].append((k, ev.new_entry.name)))
    q.subscribe(lambda k, ev: 1 / 0)  # a failing subscriber is logged
    q.subscribe(lambda k, ev: got[1].append(k))
    for i in range(3):
        ev = FPB[pkg].EventNotification()
        ev.new_entry.name = f"f{i}.txt"
        q.send(f"/dir/f{i}.txt", ev)
    assert got[0] == [(f"/dir/f{i}.txt", f"f{i}.txt") for i in range(3)]
    assert got[1] == [f"/dir/f{i}.txt" for i in range(3)]


def _filer_ops(pkg: str, path: str) -> None:
    """Seeded namespace operations on one package's Filer, its events into
    a LogFileQueue at `path`."""
    f_mod = ref_filer if pkg == "ref" else port_filer
    s_mod = ref_store if pkg == "ref" else port_store
    pb = FPB[pkg]
    q = QUEUES[pkg].LogFileQueue(path)
    f = f_mod.Filer(s_mod.MemoryStore(), signature=12345,
                    notification_queue=q)
    rng = np.random.default_rng(17)
    for d in ("/n/a", "/n/a/deep", "/n/b"):
        for i in range(3):
            e = pb.Entry(name=f"f{i}.bin", content=rng.bytes(
                int(rng.integers(1, 200))))
            e.attributes.file_size = len(e.content)
            e.attributes.mtime = 1_700_000_000 + i
            e.attributes.mime = "application/x-test"
            f.create_entry(d, e)
    e = pb.Entry(name="f1.bin", content=b"updated")
    e.attributes.file_size = 7
    e.attributes.mtime = 1_700_000_100
    f.update_entry("/n/a", e)
    f.rename("/n/a", "f2.bin", "/n/b", "moved.bin")
    f.delete_entry("/n/b", "f0.bin", is_delete_data=False)
    f.delete_entry("/n/a", "deep", is_delete_data=False, is_recursive=True)
    q.close()
    f.close()


def _masked(path: str) -> "list[bytes]":
    out = []
    for _off, rec in port_queues.LogFileQueue(path).read(0):
        ev = rec.event_notification
        for e in (ev.old_entry, ev.new_entry):
            if e.is_directory:
                e.attributes.mtime = 0
                e.attributes.crtime = 0
        out.append(rec.SerializeToString())
    return out


def test_logfile_queue_records_equal_reference(tmp_path):
    """Each package's Filer feeds its LogFileQueue the same seeded
    creates, an update, a rename and deletes (one recursive): the records
    are equal, byte for byte, once the made directories' mtime and crtime
    (the filer's clock) are masked; reads resume from any record's
    offset."""
    paths = {pkg: str(tmp_path / pkg / "notify.log") for pkg in QUEUES}
    for pkg, p in paths.items():
        _filer_ops(pkg, p)
    recs = {pkg: _masked(p) for pkg, p in paths.items()}
    assert recs["port"] == recs["ref"]
    assert len(recs["port"]) >= 15
    whole = list(port_queues.LogFileQueue(paths["ref"]).read(0))
    ref_whole = list(ref_queues.LogFileQueue(paths["port"]).read(0))
    assert [o for o, _ in whole] == [o for o, _ in ref_whole]
    rest = list(port_queues.LogFileQueue(paths["ref"]).read(whole[4][0]))
    assert [r.directory for _, r in rest] == \
        [r.directory for _, r in whole[5:]]


@pytest.mark.parametrize("spec,raises", [
    ("memory", None), ("logfile:{tmp}/q.log", None),
    ("mq:127.0.0.1:1/ns/t", None), ("mq:127.0.0.1:1", None),
    ("kafka:127.0.0.1:1/topic", OSError), ("aws_sqs:whatever", RuntimeError),
    ("gcp_pub_sub:x", RuntimeError), ("gocdk_pub_sub:x", RuntimeError),
    ("carrier-pigeon", ValueError)])
def test_open_queue_specs_and_errors_equal_reference(tmp_path, spec,
                                                     raises):
    spec = spec.format(tmp=tmp_path)
    if raises is None:
        qs = {pkg: m.open_queue(spec) for pkg, m in QUEUES.items()}
        assert qs["port"].name == qs["ref"].name
        assert type(qs["port"]).__name__ == type(qs["ref"]).__name__
        assert vars(qs["port"]).keys() == vars(qs["ref"]).keys()
        if qs["port"].name == "mq":
            assert (qs["port"].broker_address, qs["port"].namespace,
                    qs["port"].topic) == (qs["ref"].broker_address,
                                          qs["ref"].namespace,
                                          qs["ref"].topic)
        for q in qs.values():
            q.close()
        return
    errs = {}
    for pkg, m in QUEUES.items():
        with pytest.raises(raises) as ei:
            m.open_queue(spec)
        errs[pkg] = str(ei.value)
    if raises is not OSError:
        assert errs["port"] == errs["ref"]


def test_record_batch_bytes_equal_reference(monkeypatch):
    """encode_record_batch with the clock pinned (its first and max
    timestamps read time.time()): byte-equal batches; the varints and
    records too, zigzag round-trips included."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_123.456)
    rng = np.random.default_rng(5)
    for n in (1, 2, 17):
        recs = [(rng.bytes(int(rng.integers(0, 40))),
                 rng.bytes(int(rng.integers(0, 3000)))) for _ in range(n)]
        a = port_kafka.encode_record_batch(recs)
        assert a == ref_kafka.encode_record_batch(recs)
        assert struct.unpack(">q", a[:8])[0] == 0 and a[16] == 2
    for v in (0, 1, -1, 63, -64, 64, 300, -300, 1 << 40, -(1 << 40)):
        enc = port_kafka._varint(v)
        assert enc == ref_kafka._varint(v)
        assert port_kafka.read_varint(enc, 0) == (v, len(enc))
    assert port_kafka.encode_record(b"k", b"v", 3) == \
        ref_kafka.encode_record(b"k", b"v", 3)


@pytest.mark.parametrize("queue_pkg,kafka_pkg", [
    ("port", "ref"), ("ref", "port"), ("port", "port")])
def test_kafka_queue_into_either_mini_kafka(queue_pkg, kafka_pkg):
    """Each package's KafkaQueue produces filer events into the other's
    MiniKafka over the wire: no CRC failure, the events arrive in order;
    a batch corrupted after its CRC is answered CORRUPT_MESSAGE (2) and
    dropped by both stand-ins."""
    srv = MINI[kafka_pkg].MiniKafka(port=tc.free_port_pair()).start()
    try:
        q = QUEUES[queue_pkg].open_queue(f"kafka:{srv.address}/filer-events")
        pb = FPB[queue_pkg]
        for i in range(6):
            ev = pb.EventNotification()
            ev.new_entry.name = f"file-{i}.txt"
            tc.bounded(lambda: q.send(f"/dir/file-{i}.txt", ev), 30)
        msgs = srv.messages["filer-events"]
        assert srv.crc_failures == 0 and len(msgs) == 6
        for i, (key, value) in enumerate(msgs):
            assert key == f"/dir/file-{i}.txt".encode()
            assert fpb.EventNotification.FromString(value).new_entry.name \
                == f"file-{i}.txt"
        km = KAFKA[queue_pkg]
        kq = km.KafkaQueue(srv.address, topic="corrupt-topic")
        batch = bytearray(km.encode_record_batch([(b"k", b"value-bytes")]))
        batch[-1] ^= 0xFF
        body = (km._str(None) + struct.pack(">hi", 1, 10_000)
                + struct.pack(">i", 1) + km._str("corrupt-topic")
                + struct.pack(">i", 1) + struct.pack(">i", 0)
                + km._bytes(bytes(batch)))
        resp = tc.bounded(lambda: kq._conn().request(km.API_PRODUCE, 3, body),
                        30)
        pos = 4 + 2 + len("corrupt-topic") + 4 + 4
        assert struct.unpack(">h", resp[pos:pos + 2])[0] == 2
        assert srv.crc_failures == 1
        assert srv.messages.get("corrupt-topic", []) == []
        kq.close()
        q.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("queue_pkg", ["ref", "port"])
def test_mq_queue_into_the_ports_broker(tmp_path, queue_pkg):
    """A Filer whose notification queue is `mq:<port broker>/notif/events`
    (either package's MqQueue): every event arrives as a message keyed by
    the entry's full path, its value the EventNotification."""
    from seaweedfs_tpu_torch.master.master_server import MasterServer
    ms = MasterServer(port=tc.free_port_pair(), pulse_seconds=0.3,
                      maintenance_scripts=[])
    ms.start()
    b = port_broker.BrokerServer(ms.address, port=tc.free_port_pair()).start()
    try:
        f_mod = ref_filer if queue_pkg == "ref" else port_filer
        s_mod = ref_store if queue_pkg == "ref" else port_store
        q = QUEUES[queue_pkg].open_queue(f"mq:{b.address}/notif/events")
        filer = f_mod.Filer(s_mod.MemoryStore(),
                            meta_log_path=str(tmp_path / "meta.log"),
                            notification_queue=q)
        e = FPB[queue_pkg].Entry(name="hello.txt")
        e.attributes.file_size = 42
        tc.bounded(lambda: (filer.create_entry("/watched", e),
                          filer.delete_entry("/watched", "hello.txt",
                                             is_delete_data=False)))
        q.close()
        filer.close()
        got = tc.bounded(lambda: list(port_client.subscribe(
            b.address, "notif", "events", start_offset=0)))
        keys = [k.decode() for _off, k, _v in got]
        assert keys == ["/watched", "/watched/hello.txt",
                        "/watched/hello.txt"]
        ev = fpb.EventNotification.FromString(got[1][2])
        assert ev.new_entry.name == "hello.txt"
        assert ev.new_entry.attributes.file_size == 42
        assert fpb.EventNotification.FromString(got[2][2]).old_entry.name \
            == "hello.txt"
    finally:
        b.stop()
        ms.stop()


# -- over a cluster of the port ---------------------------------------------

@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    root = tmp_path_factory.mktemp("notify")
    c = tc.start(root, volume_size_limit_mb=64)
    fs = FilerServer(c["master"].address, store_spec="memory",
                     port=tc.free_port_pair(), chunk_size_mb=1).start()
    rng = np.random.default_rng(41)
    files = {}
    for path, n in (("/rep/a.txt", 5), ("/rep/sub/b.bin", 3000),
                    ("/rep/sub/deep/c.bin", (1 << 20) + 77),
                    ("/rep/d.bin", 0), ("/other/x.bin", 10)):
        files[path] = rng.bytes(n)
        fs.write_file(path, files[path])
    yield {"c": c, "fs": fs, "files": files}
    fs.stop()
    tc.stop(c)


def test_fs_meta_notify_prints_and_queues_as_the_reference(stack, tmp_path):
    """fs.meta.notify -dir /rep through the JAX shell and the port's
    shell against one port filer: the same line printed, byte-equal
    logfile queues, and the same keys and events in a MiniKafka topic."""
    c, fs = stack["c"], stack["fs"]
    ref_mc = RefMC(c["master"].address).start()
    ref_mc.wait_connected(10)
    envs = {"ref": ref_commands.CommandEnv(c["master"].address, mc=ref_mc,
                                           out=io.StringIO()),
            "port": port_commands.CommandEnv(c["master"].address, mc=c["mc"],
                                             out=io.StringIO())}
    srv = port_mini.MiniKafka(port=tc.free_port_pair()).start()
    try:
        outs, logs = {}, {}
        for pkg, mod in (("ref", ref_commands), ("port", port_commands)):
            env = envs[pkg]
            env.option["filer"] = fs.url
            logs[pkg] = str(tmp_path / f"{pkg}.log")
            env.out = io.StringIO()
            tc.bounded(lambda: mod.run_command(
                env, f"fs.meta.notify -dir /rep -queue logfile:{logs[pkg]}"))
            tc.bounded(lambda: mod.run_command(
                env, f"fs.meta.notify -dir /rep -queue "
                     f"kafka:{srv.address}/{pkg}"))
            outs[pkg] = env.out.getvalue()
        assert outs["port"] == outs["ref"] == \
            "notified 2 directories, 4 files\n" * 2
        with open(logs["ref"], "rb") as f1, open(logs["port"], "rb") as f2:
            assert f1.read() == f2.read()
        keys = [r.directory for _, r in
                port_queues.LogFileQueue(logs["port"]).read(0)]
        assert sorted(keys) == ["/rep/a.txt", "/rep/d.bin", "/rep/sub",
                                "/rep/sub/b.bin", "/rep/sub/deep",
                                "/rep/sub/deep/c.bin"]
        assert srv.messages["port"] == srv.messages["ref"]
        assert [k.decode() for k, _ in srv.messages["port"]] == keys
        assert srv.crc_failures == 0
    finally:
        srv.stop()
        ref_mc.stop()


def test_filer_replicate_verb_mirrors_a_logfile_queue(stack, tmp_path):
    """The copy of the reference's tests/test_cli_verbs.py
    test_filer_replicate_logfile_queue: events captured by fs.meta.notify
    into a logfile queue replay through `python -m seaweedfs_tpu_torch
    filer.replicate` into a local sink; the offset file ends at the
    queue's end, and a second run from it applies nothing again."""
    c, fs, files = stack["c"], stack["fs"], stack["files"]
    qpath = tmp_path / "events.log"
    out = tc.shell(c, f"fs.meta.notify -filer {fs.url} -dir /rep "
                      f"-queue logfile:{qpath}")
    assert "4 files" in out, out
    mirror = tmp_path / "mirror"
    cmd = [sys.executable, "-m", "seaweedfs_tpu_torch", "filer.replicate",
           "-filer", fs.url, "-queue", f"logfile:{qpath}",
           "-sink", f"local:{mirror}"]

    def mirrored():
        for path, data in files.items():
            if path.startswith("/rep/") and \
                    (mirror / path[1:]).read_bytes() != data:
                return False
        return True

    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        tc.wait_until(mirrored, timeout=60, msg="the mirror populated")
        tc.wait_until(lambda: int((tmp_path / "events.log.offset")
                                  .read_text() or 0) == qpath.stat().st_size,
                      timeout=30, msg="the offset at the queue's end")
    finally:
        proc.terminate()
        said, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, said
    assert "(offset 0)" in said
    assert not (mirror / "other").exists()
    (mirror / "rep/a.txt").write_bytes(b"changed locally")
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        time.sleep(2.0)
    finally:
        proc.terminate()
        said, _ = proc.communicate(timeout=30)
    assert f"(offset {qpath.stat().st_size})" in said, said
    assert (mirror / "rep/a.txt").read_bytes() == b"changed locally"


def test_filer_replicate_refuses_a_queue_it_cannot_resume():
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                        "filer.replicate", "-queue", "mq:127.0.0.1:1",
                        "-sink", "local:/nonexistent"], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 1
    assert "consumes a durable queue" in r.stderr

