"""MQ broker daemon (reference weed/mq/broker).

gRPC service `swtpu.mq.Broker`: ConfigureTopic / LookupTopicBrokers /
ListTopics / Publish (stream) / Subscribe (stream). Partition logs are
in-memory lists with length-prefixed segment flushes into the filer at
/topics/<ns>/<topic>/<range>/seg-<n> (reference persists segments via
the filer the same way, broker_server.go) — a broker restart replays
persisted segments. Multiple brokers register in the master cluster
(client_type "broker", reference cluster.go:104); partition ownership is
deterministic over the sorted live-broker list so every broker answers
lookups identically (pub_balancer/balancer.go re-designed without the
coordinator: ownership = hash-ordered assignment).

The port's copy of seaweedfs_tpu/mq/broker.py. It persists through the
port's FilerServer (or LocalSegmentStore), registers through the port's
MasterClient, and takes the service name MQ_SERVICE from the port's
utils/rpc, where cluster.check reads it too. Segment files, offset files
and topic.conf are byte-equal to the reference's for the same appends. One
fix of the port's (ROADMAP Queue 3): a replayed partial tail counts as
flushed, so a restarted broker does not re-upload every partition's tail
segment, unchanged, at its first flush tick and at its stop.
"""

from __future__ import annotations

import os
import struct
import threading
import time

import hashlib

from ..client.master_client import MasterClient
from ..pb import mq_pb2 as mq
from ..utils import fsutil
from ..utils.log import logger
from ..utils.rpc import MASTER_SERVICE, MQ_SERVICE, RpcService, Stub, serve
from .sub_coordinator import Coordinator
from .topic import Partition, TopicRef, split_ring

log = logger("mq.broker")

SEGMENT_FLUSH_COUNT = 1000  # messages per persisted segment


def _stable_hash(s: str) -> int:
    """Deterministic across processes (unlike hash()) so every broker
    ranks the same owner for a partition or group. blake2b, not md5:
    md5 raises on FIPS-enforcing builds (usedforsecurity defaults True)
    and this is placement hashing, not cryptography."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")


class PartitionLog:
    """One partition's message log: bounded in-memory tail + filer segments.

    Only the un-sealed tail (< SEGMENT_FLUSH_COUNT messages) lives in
    memory; sealed segments are dropped after persisting and reads of old
    offsets come back from the filer. The partial tail is re-written by
    `flush_tail` (periodic + on broker stop) so a restart loses at most
    the last flush interval, not 999 acked messages. Without a filer the
    log is memory-only and unbounded (standalone dev mode)."""

    def __init__(self, topic: TopicRef, partition: Partition, filer=None):
        self.topic = topic
        self.partition = partition
        self.filer = filer
        self.messages: list[tuple[bytes, bytes, int]] = []  # un-sealed tail
        self.base_offset = 0  # offset of messages[0] == sealed message count
        self._full_segments = 0
        self._seg_cache: tuple[int, list] | None = None  # last parsed seg
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # serializes segment WRITES so the out-of-lock periodic tail flush
        # can never clobber a just-sealed full segment with a stale partial
        self._io_mu = threading.Lock()
        self._max_sealed = -1  # highest segment index written as full
        self._last_tail_flush = (-1, -1)  # (segment idx, length) persisted
        if filer is not None:
            self._replay()

    # -- persistence ---------------------------------------------------------
    @property
    def _dir(self) -> str:
        return (f"/topics/{self.topic.namespace}/{self.topic.name}/"
                f"{self.partition.range_start:04d}-"
                f"{self.partition.range_stop:04d}")

    def _segment_path(self, n: int) -> str:
        return f"{self._dir}/seg-{n:06d}"

    @staticmethod
    def _parse_records(data: bytes) -> list[tuple[bytes, bytes, int]]:
        out = []
        pos = 0
        while pos + 4 <= len(data):
            (ln,) = struct.unpack_from("<I", data, pos)
            pos += 4
            rec = data[pos:pos + ln]
            pos += ln
            klen = struct.unpack_from("<I", rec, 0)[0]
            key = rec[4:4 + klen]
            ts = struct.unpack_from("<q", rec, 4 + klen)[0]
            value = rec[12 + klen:]
            out.append((key, value, ts))
        return out

    def _read_segment(self, n: int) -> list[tuple[bytes, bytes, int]]:
        from ..filer.filer import split_path
        d, name = split_path(self._segment_path(n))
        entry = self.filer.filer.find_entry(d, name)
        if entry is None:
            return []
        return self._parse_records(self.filer.read_entry_bytes(entry))

    def _replay(self) -> None:
        """Restore offsets on broker restart: count sealed segments by
        existence (no payload fetch), parse only the trailing segment and
        keep it in memory as the tail if partial."""
        from ..filer.filer import split_path
        n = 0
        while True:
            d, name = split_path(self._segment_path(n))
            if self.filer.filer.find_entry(d, name) is None:
                break
            n += 1
        tail: list[tuple[bytes, bytes, int]] = (
            self._read_segment(n - 1) if n else [])
        if n and len(tail) < SEGMENT_FLUSH_COUNT:
            self._full_segments = n - 1
            self.messages = tail
        else:
            self._full_segments = n
            self.messages = []
        self.base_offset = self._full_segments * SEGMENT_FLUSH_COUNT
        self._max_sealed = self._full_segments - 1
        if self.messages:
            # the partial tail just read is what the filer holds: counted
            # as flushed, a restart writes nothing into the topic's
            # (possibly sealed) volumes until the tail grows
            self._last_tail_flush = (self._full_segments, len(self.messages))
        if n:
            log.info("%s %s: replayed %d segments (next offset %d)",
                     self.topic, self.partition, n,
                     self.base_offset + len(self.messages))

    def _write_segment(self, n: int,
                       batch: list[tuple[bytes, bytes, int]]) -> None:
        blob = bytearray()
        for key, value, ts in batch:
            rec = (struct.pack("<I", len(key)) + key
                   + struct.pack("<q", ts) + value)
            blob += struct.pack("<I", len(rec)) + rec
        self.filer.write_file(self._segment_path(n), bytes(blob),
                              mime="application/octet-stream")

    def flush_tail(self) -> None:
        """Persist the partial tail segment (re-written in place as it
        grows; sealed for good once full). The filer write runs OUTSIDE
        the partition lock so the periodic flusher doesn't stall appends
        and in-memory reads for a whole upload."""
        if self.filer is None:
            return
        with self._io_mu:
            with self._lock:
                n, batch = self._full_segments, list(self.messages)
            # never write MORE than a segment's worth: a crash would make
            # _replay mis-count the oversized file as exactly one sealed
            # segment, orphaning the excess and reusing their offsets
            batch = batch[:SEGMENT_FLUSH_COUNT]
            if not batch or n <= self._max_sealed:
                return  # nothing new, or that index already sealed full
            if self._last_tail_flush == (n, len(batch)):
                return  # idle partition: skip the redundant re-upload
            self._write_segment(n, batch)
            self._last_tail_flush = (n, len(batch))

    def _seal_full_segments(self) -> None:
        """Persist full segments; memory is trimmed only AFTER each file
        write so readers never hit a window where a sealed offset is
        neither in memory nor on the filer."""
        with self._io_mu:
            while True:
                with self._lock:
                    if len(self.messages) < SEGMENT_FLUSH_COUNT:
                        return
                    n = self._full_segments
                    batch = self.messages[:SEGMENT_FLUSH_COUNT]
                self._write_segment(n, batch)
                with self._lock:
                    self._full_segments = n + 1
                    self.messages = self.messages[SEGMENT_FLUSH_COUNT:]
                    self.base_offset += SEGMENT_FLUSH_COUNT
                self._max_sealed = max(self._max_sealed, n)

    # -- log ops -------------------------------------------------------------
    def append(self, key: bytes, value: bytes, ts_ns: int) -> int:
        with self._lock:
            self.messages.append((key, value, ts_ns))
            offset = self.base_offset + len(self.messages) - 1
            need_seal = (self.filer is not None
                         and len(self.messages) >= SEGMENT_FLUSH_COUNT)
            self._cv.notify_all()
        if need_seal:
            self._seal_full_segments()
        return offset

    @property
    def next_offset(self) -> int:
        with self._lock:
            return self.base_offset + len(self.messages)

    def read(self, offset: int, max_count: int = 256
             ) -> list[tuple[int, bytes, bytes, int]]:
        with self._lock:
            if offset >= self.base_offset:
                start = offset - self.base_offset
                return [(self.base_offset + start + i, k, v, ts)
                        for i, (k, v, ts) in enumerate(
                            self.messages[start:start + max_count])]
            filer = self.filer
        if filer is None:
            return []
        # old offset: serve from the sealed segment that contains it,
        # keeping the last-parsed segment around — a replaying subscriber
        # reads each 1000-record segment in ~4 ×256 batches
        seg = offset // SEGMENT_FLUSH_COUNT
        base = seg * SEGMENT_FLUSH_COUNT
        cached = self._seg_cache
        if cached is None or cached[0] != seg:
            cached = (seg, self._read_segment(seg))
            self._seg_cache = cached
        records = cached[1]
        lo = offset - base
        return [(base + lo + i, k, v, ts)
                for i, (k, v, ts) in enumerate(
                    records[lo:lo + max_count])]

    def wait_for(self, offset: int, timeout: float) -> bool:
        with self._cv:
            if self.base_offset + len(self.messages) > offset:
                return True
            self._cv.wait(timeout)
            return self.base_offset + len(self.messages) > offset


class LocalSegmentStore:
    """Duck-typed stand-in for an in-process FilerServer: persists broker
    segments to a local directory so the STANDALONE `mq.broker` verb is
    durable too (not memory-only and unbounded).
    Exposes exactly the three calls PartitionLog uses: .filer.find_entry,
    .read_entry_bytes, .write_file."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.filer = self  # PartitionLog dials `filer.filer.find_entry`

    def _path(self, directory: str, name: str = "") -> str:
        return os.path.join(self.root, directory.lstrip("/"), name)

    def find_entry(self, directory: str, name: str):
        p = self._path(directory, name)
        return p if os.path.exists(p) else None

    def read_entry_bytes(self, entry: str) -> bytes:
        with open(entry, "rb") as f:
            return f.read()

    def write_file(self, path: str, data: bytes, **_kw) -> None:
        from ..filer.filer import split_path
        d, name = split_path(path)
        os.makedirs(self._path(d), exist_ok=True)
        tmp = self._path(d, name) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(d, name))
        # the flush path acks the batch once this entry lands: pin the
        # rename so a crash can't un-publish acked messages
        fsutil.fsync_dir(self._path(d, name))


class BrokerServer:
    def __init__(self, master_address: str, ip: str = "127.0.0.1",
                 port: int = 17777, filer_server=None,
                 data_dir: str | None = None,
                 rebalance_delay_s: float | None = None):
        self.ip, self.port = ip, port
        # segment persistence: an in-process filer, or a local directory
        # for the standalone verb, or memory-only (tests)
        if filer_server is None and data_dir:
            filer_server = LocalSegmentStore(data_dir)
        self.filer = filer_server  # optional persistence
        self.mc = MasterClient(master_address, client_type="broker",
                               client_address=f"{ip}:{port}")
        self.topics: dict[str, list[Partition]] = {}
        # configure-time leader assignment: topic -> {range_start: broker}
        self.topic_leaders: dict[str, dict[int, str]] = {}
        # topic -> serialized RecordType (mq_schema.proto); b"" = schemaless
        self.topic_schemas: dict[str, bytes] = {}
        self.logs: dict[tuple[str, int], PartitionLog] = {}
        self._lock = threading.Lock()
        self._grpc = None
        self._stop = threading.Event()
        self.flush_interval = 2.0  # partial-tail persistence cadence (s)
        # consumer-group coordination (sub_coordinator.py); leadership and
        # coordinator placement both hash over the live-broker ring below
        self.coordinator = Coordinator(self._group_partitions,
                                       rebalance_delay_s)
        self._broker_cache: tuple[float, list[str]] = (0.0, [self.address])
        self._last_membership: list[str] = [self.address]
        self.membership_poll_s = 0.5
        # committed offsets: (topic_name, range_start, group) -> offset;
        # memory cache over the filer-persisted offset files
        self._offsets: dict[tuple[str, int, str], int] = {}

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> "BrokerServer":
        self.mc.start()
        self._grpc = serve(f"{self.ip}:{self.port}", [self._build_service()])
        if self.filer is not None:
            threading.Thread(target=self._flusher, daemon=True,
                             name=f"mq-flush-{self.port}").start()
        threading.Thread(target=self._membership_watch, daemon=True,
                         name=f"mq-members-{self.port}").start()
        log.info("mq broker %s up", self.address)
        return self

    def stop(self) -> None:
        self._stop.set()
        self.coordinator.shutdown()
        # stop accepting publishes BEFORE the final flush — an append acked
        # after its partition's flush would be lost despite a clean stop
        if self._grpc:
            self._grpc.stop(grace=0.5).wait()
        for lg in list(self.logs.values()):
            try:
                lg.flush_tail()
            except Exception as e:  # noqa: BLE001
                log.warning("flush tail of %s %s: %s",
                            lg.topic, lg.partition, e)
        self.mc.stop()

    def kill(self) -> None:
        """Abrupt death for failover tests: drop the gRPC plane and the
        master registration WITHOUT the final tail flush a clean stop()
        performs — acked-but-unflushed tails are lost, like a crash."""
        self._stop.set()
        self.coordinator.shutdown()
        if self._grpc:
            self._grpc.stop(grace=0).wait()
        self.mc.stop()

    # -- live-broker ring ----------------------------------------------------
    def live_brokers(self) -> list[str]:
        """Sorted live broker addresses from the master cluster list
        (cluster.go:104 membership), ~0.5 s cached; always includes self
        so a broker is usable before/without master registration."""
        now = time.monotonic()
        ts, cached = self._broker_cache
        if now - ts < 0.5:
            return cached
        addrs = {self.address}
        try:
            from ..pb import master_pb2 as mpb
            resp = Stub(self.mc.leader, MASTER_SERVICE).call(
                "ListClusterNodes",
                mpb.ListClusterNodesRequest(client_type="broker"),
                mpb.ListClusterNodesResponse, timeout=2)
            addrs.update(n.address for n in resp.cluster_nodes)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (masterless dev mode: self only)
            pass
        out = sorted(addrs)
        self._broker_cache = (now, out)
        return out

    def leader_for(self, topic_name: str, partition: Partition) -> str:
        """Partition→broker ownership: the assignment RECORDED at
        configure time (reference pub_balancer/allocate.go picks brokers
        and the assignment sticks) as long as that broker is alive;
        otherwise a deterministic hash over the live ring, so a broker
        death re-homes exactly its partitions and every broker answers
        lookups identically."""
        brokers = self.live_brokers()
        assigned = self.topic_leaders.get(topic_name, {}).get(
            partition.range_start)
        if assigned in brokers:
            return assigned
        h = _stable_hash(f"{topic_name}:{partition.range_start}")
        return brokers[h % len(brokers)]

    def coordinator_for(self, topic_name: str, group: str) -> str:
        brokers = self.live_brokers()
        h = _stable_hash(f"{topic_name}/{group}")
        return brokers[h % len(brokers)]

    def _group_partitions(self, topic_name: str
                          ) -> list[tuple[Partition, str]]:
        """Coordinator callback: the topic's partitions with their CURRENT
        leaders (fed into every rebalance)."""
        ns, _, name = topic_name.partition(".")
        parts = self._topic_partitions(TopicRef(ns, name)) or []
        return [(p, self.leader_for(topic_name, p)) for p in parts]

    def _membership_watch(self) -> None:
        """React to broker join/death: when the live ring changes, every
        consumer group rebalances onto the new partition leadership
        (reference OnPartitionChange / OnSubRemoveBroker)."""
        while not self._stop.wait(self.membership_poll_s):
            self._broker_cache = (0.0, self._broker_cache[1])  # force renew
            live = self.live_brokers()
            if live == self._last_membership:
                continue
            log.info("broker membership %s -> %s", self._last_membership,
                     live)
            self._last_membership = live
            for t in self.coordinator.topic_names():
                self.coordinator.on_partition_change(t)

    # -- committed offsets ---------------------------------------------------
    def _offset_path(self, topic_name: str, p: Partition, group: str) -> str:
        ns, _, name = topic_name.partition(".")
        return (f"/topics/{ns}/{name}/{p.range_start:04d}-"
                f"{p.range_stop:04d}/offset.{group}")

    def commit_offset(self, topic_name: str, p: Partition, group: str,
                      offset: int) -> None:
        self._offsets[(topic_name, p.range_start, group)] = offset
        if self.filer is not None:
            self.filer.write_file(self._offset_path(topic_name, p, group),
                                  struct.pack("<q", offset),
                                  mime="application/octet-stream")

    def fetch_offset(self, topic_name: str, p: Partition, group: str) -> int:
        """Highest committed offset, -1 if the group never committed.
        Reads through to the filer so a freshly failed-over broker sees
        commits made via its dead peer."""
        if self.filer is not None:
            from ..filer.filer import split_path
            d, n = split_path(self._offset_path(topic_name, p, group))
            entry = self.filer.filer.find_entry(d, n)
            if entry is not None:
                data = self.filer.read_entry_bytes(entry)
                if len(data) >= 8:
                    off = struct.unpack("<q", data[:8])[0]
                    self._offsets[(topic_name, p.range_start, group)] = off
                    return off
            return self._offsets.get((topic_name, p.range_start, group), -1)
        return self._offsets.get((topic_name, p.range_start, group), -1)

    def _flusher(self) -> None:
        while not self._stop.wait(self.flush_interval):
            for lg in list(self.logs.values()):
                try:
                    lg.flush_tail()
                except Exception as e:  # noqa: BLE001
                    log.warning("periodic flush of %s %s: %s",
                                lg.topic, lg.partition, e)

    # -- topic/partition state ----------------------------------------------
    def _log_for(self, tref: TopicRef, partition: Partition) -> PartitionLog:
        key = (str(tref), partition.range_start)
        with self._lock:
            lg = self.logs.get(key)
            if lg is None:
                lg = PartitionLog(tref, partition, self.filer)
                self.logs[key] = lg
            return lg

    def configure_topic(self, tref: TopicRef, partition_count: int,
                        record_type: bytes = b"") -> list[Partition]:
        """Create (or re-read) a topic. First configuration assigns each
        partition a leader round-robin over the live ring STARTING at
        this broker (reference pub_balancer allocates to brokers and the
        assignment sticks in the topic conf); reconfiguring an existing
        topic with the same count keeps its assignment. `record_type` is
        the serialized schema (mq_schema.proto RecordType) persisted with
        the topic conf — reference ConfigureTopicRequest.record_type."""
        tname = str(tref)
        existing = self._topic_partitions(tref)
        if existing is not None and len(existing) == max(1, partition_count):
            if record_type and self.topic_schemas.get(tname) != record_type:
                with self._lock:
                    self.topic_schemas[tname] = record_type
                self._persist_topic_conf(tref)
            return existing
        parts = split_ring(max(1, partition_count))
        ring = self.live_brokers()
        start = ring.index(self.address) if self.address in ring else 0
        leaders = {p.range_start: ring[(start + i) % len(ring)]
                   for i, p in enumerate(parts)}
        with self._lock:
            self.topics[tname] = parts
            self.topic_leaders[tname] = leaders
            if record_type:
                self.topic_schemas[tname] = record_type
        self._persist_topic_conf(tref)
        return parts

    def _topic_schema(self, tref: TopicRef) -> bytes:
        """Read-through schema lookup: a broker that cached the topic
        BEFORE another broker registered a schema must still see it (the
        conf lives in the shared filer)."""
        tname = str(tref)
        schema = self.topic_schemas.get(tname, b"")
        if not schema and self.filer is not None:
            import base64
            import json

            from ..filer.filer import split_path
            d, n = split_path(
                f"/topics/{tref.namespace}/{tref.name}/topic.conf")
            entry = self.filer.filer.find_entry(d, n)
            if entry is not None:
                conf = json.loads(self.filer.read_entry_bytes(entry))
                if conf.get("record_type_b64"):
                    schema = base64.b64decode(conf["record_type_b64"])
                    with self._lock:
                        self.topic_schemas[tname] = schema
        return schema

    def _persist_topic_conf(self, tref: TopicRef) -> None:
        if self.filer is None:
            return
        import base64
        import json
        tname = str(tref)
        with self._lock:
            parts = self.topics.get(tname, [])
            leaders = dict(self.topic_leaders.get(tname, {}))
            schema = self.topic_schemas.get(tname, b"")
        conf = {"partition_count": len(parts),
                "leaders": {str(k): v for k, v in leaders.items()}}
        if schema:
            conf["record_type_b64"] = base64.b64encode(schema).decode()
        self.filer.write_file(
            f"/topics/{tref.namespace}/{tref.name}/topic.conf",
            json.dumps(conf).encode(), mime="application/json")

    def _topic_partitions(self, tref: TopicRef) -> list[Partition] | None:
        parts = self.topics.get(str(tref))
        if parts is not None:
            return parts
        if self.filer is not None:
            import json

            from ..filer.filer import split_path
            d, n = split_path(
                f"/topics/{tref.namespace}/{tref.name}/topic.conf")
            entry = self.filer.filer.find_entry(d, n)
            if entry is not None:
                import base64
                conf = json.loads(self.filer.read_entry_bytes(entry))
                parts = split_ring(conf["partition_count"])
                with self._lock:
                    self.topics[str(tref)] = parts
                    self.topic_leaders[str(tref)] = {
                        int(k): v
                        for k, v in conf.get("leaders", {}).items()}
                    if conf.get("record_type_b64"):
                        self.topic_schemas[str(tref)] = base64.b64decode(
                            conf["record_type_b64"])
                return parts
        return None

    # -- gRPC ----------------------------------------------------------------
    def _build_service(self) -> RpcService:
        svc = RpcService(MQ_SERVICE)
        broker = self

        def tref_of(t: mq.Topic) -> TopicRef:
            return TopicRef(t.namespace or "default", t.name)

        def part_of(p: mq.Partition) -> Partition:
            return Partition(p.range_start, p.range_stop,
                             p.ring_size or 4096)

        def fill_assignments(resp, tref: TopicRef, parts: list[Partition]):
            tname = str(tref)
            for p in parts:
                a = resp.assignments.add(
                    leader_broker=broker.leader_for(tname, p))
                a.partition.range_start = p.range_start
                a.partition.range_stop = p.range_stop
                a.partition.ring_size = p.ring_size

        @svc.unary("ConfigureTopic", mq.ConfigureTopicRequest,
                   mq.ConfigureTopicResponse)
        def configure(req, ctx):
            tref = tref_of(req.topic)
            parts = broker.configure_topic(tref, req.partition_count or 1,
                                           bytes(req.record_type))
            resp = mq.ConfigureTopicResponse()
            fill_assignments(resp, tref, parts)
            return resp

        @svc.unary("GetTopicConfiguration",
                   mq.GetTopicConfigurationRequest,
                   mq.GetTopicConfigurationResponse)
        def get_topic_configuration(req, ctx):
            """Reference GetTopicConfiguration: partitions + the topic's
            registered schema (subscribers fetch it to decode records)."""
            tref = tref_of(req.topic)
            parts = broker._topic_partitions(tref)
            if parts is None:
                ctx.abort(5, f"topic {tref} not found")
            resp = mq.GetTopicConfigurationResponse(
                partition_count=len(parts),
                record_type=broker._topic_schema(tref))
            resp.topic.CopyFrom(req.topic)
            fill_assignments(resp, tref, parts)
            return resp

        @svc.unary("LookupTopicBrokers", mq.LookupTopicBrokersRequest,
                   mq.LookupTopicBrokersResponse)
        def lookup(req, ctx):
            tref = tref_of(req.topic)
            parts = broker._topic_partitions(tref)
            if parts is None:
                ctx.abort(5, f"topic {tref} not found")
            resp = mq.LookupTopicBrokersResponse()
            resp.topic.CopyFrom(req.topic)
            fill_assignments(resp, tref, parts)
            return resp

        @svc.unary("Ping", mq.PingRequest, mq.PingResponse)
        def ping(req, ctx):
            return mq.PingResponse(remote_time_ns=time.time_ns())

        @svc.unary("BalanceTopics", mq.BalanceTopicsRequest,
                   mq.BalanceTopicsResponse)
        def balance_topics(req, ctx):
            """Reference mq.proto BalanceTopics (shell mq.balance): re-derive
            every topic's partition ring from its configured count — healing
            any drift — and report the resulting assignment. Ownership stays
            deterministic over the ring (broker docstring), so no partition
            hand-off messages are needed."""
            resp = mq.BalanceTopicsResponse()
            ring = broker.live_brokers()
            healed_topics: "list[TopicRef]" = []
            with broker._lock:  # one lock span: a concurrent
                # ConfigureTopic must not be reverted from a stale snapshot
                for full in sorted(broker.topics):
                    rebuilt = split_ring(len(broker.topics[full]))
                    broker.topics[full] = rebuilt
                    # heal ONLY dead-leader assignments, with the same
                    # deterministic fallback leader_for uses — every other
                    # broker computes the identical answer from its own
                    # cached conf, so views stay convergent without a
                    # cross-broker conf push
                    leaders = dict(broker.topic_leaders.get(full, {}))
                    healed = False
                    for p in rebuilt:
                        if leaders.get(p.range_start) not in ring:
                            h = _stable_hash(f"{full}:{p.range_start}")
                            leaders[p.range_start] = ring[h % len(ring)]
                            healed = True
                    broker.topic_leaders[full] = leaders
                    ns, _, name = full.partition(".")
                    if healed:
                        healed_topics.append(TopicRef(ns, name))
                    a = resp.assignments.add()
                    a.topic.namespace, a.topic.name = ns, name
                    for p in rebuilt:
                        a.partitions.add(range_start=p.range_start,
                                         range_stop=p.range_stop,
                                         ring_size=p.ring_size)
            # persist OUTSIDE broker._lock (it re-acquires it), via the
            # one conf writer — a hand-rolled dict here silently dropped
            # record_type_b64, so a healed topic lost its registered schema
            for tref in healed_topics:
                broker._persist_topic_conf(tref)
            return resp

        @svc.unary("ListTopics", mq.ListTopicsRequest, mq.ListTopicsResponse)
        def list_topics(req, ctx):
            resp = mq.ListTopicsResponse()
            with broker._lock:
                names = sorted(broker.topics)
            for full in names:
                ns, _, name = full.partition(".")
                resp.topics.add(namespace=ns, name=name)
            return resp

        @svc.stream_stream("Publish", mq.PublishRequest, mq.PublishResponse)
        def publish(request_iter, ctx):
            """Reference broker_grpc_pub.go: first message is init,
            then data; each append acks with its offset."""
            lg = None
            for req in request_iter:
                if req.HasField("init"):
                    tref = tref_of(req.init.topic)
                    if broker._topic_partitions(tref) is None:
                        broker.configure_topic(tref, 1)
                    lg = broker._log_for(tref, part_of(req.init.partition))
                    continue
                if lg is None:
                    yield mq.PublishResponse(error="publish before init")
                    return
                ts = req.data.ts_ns or time.time_ns()
                off = lg.append(bytes(req.data.key),
                                bytes(req.data.value), ts)
                yield mq.PublishResponse(ack_sequence=off)

        @svc.unary("FindCoordinator", mq.FindCoordinatorRequest,
                   mq.FindCoordinatorResponse)
        def find_coordinator(req, ctx):
            tname = str(tref_of(req.topic))
            return mq.FindCoordinatorResponse(
                coordinator=broker.coordinator_for(tname,
                                                   req.consumer_group))

        @svc.stream_stream("SubscriberToSubCoordinator",
                           mq.SubscriberToSubCoordinatorRequest,
                           mq.SubscriberToSubCoordinatorResponse)
        def sub_coordinate(request_iter, ctx):
            """Reference broker_grpc_sub_coordinator.go: member joins with
            init, holds the stream open, and receives a generation-stamped
            Assignment after every rebalance; the stream breaking (death
            or leave) removes the member and triggers a rebalance for the
            survivors."""
            first = next(request_iter)
            group = first.init.consumer_group
            iid = first.init.consumer_group_instance_id
            tname = str(tref_of(first.init.topic))
            inst = broker.coordinator.add_subscriber(group, iid, tname)

            def drain():
                # consume acks until the client goes away, then unblock
                # the response loop with a poison pill
                try:
                    for _ in request_iter:
                        pass
                except Exception as e:  # noqa: BLE001
                    log.debug("subscribe request stream drain ended: %s", e)
                inst.responses.put(None)

            threading.Thread(target=drain, daemon=True,
                             name=f"mq-coord-drain-{iid}").start()
            ctx.add_callback(lambda: inst.responses.put(None))
            try:
                while ctx.is_active():
                    item = inst.responses.get()
                    if item is None:
                        return
                    gen, slots = item
                    resp = mq.SubscriberToSubCoordinatorResponse()
                    resp.assignment.generation = gen
                    for slot in slots:
                        pa = resp.assignment.partition_assignments.add(
                            leader_broker=slot.broker)
                        pa.partition.range_start = slot.range_start
                        pa.partition.range_stop = slot.range_stop
                        pa.partition.ring_size = slot.ring_size
                    yield resp
            finally:
                broker.coordinator.remove_subscriber(group, iid, tname)

        @svc.unary("DescribeConsumerGroups",
                   mq.DescribeConsumerGroupsRequest,
                   mq.DescribeConsumerGroupsResponse)
        def describe_groups(req, ctx):
            """Groups coordinated by THIS broker for the topic, with
            member assignments and committed offsets (the shell fans out
            to every live broker and merges)."""
            tname = str(tref_of(req.topic))
            resp = mq.DescribeConsumerGroupsResponse()
            coord = broker.coordinator
            with coord._lock:
                snap = [(g, cg.generation, dict(cg.instances),
                         list(cg.mapping))
                        for (t, g), cg in coord.groups.items()
                        if t == tname]
            for gname, gen, instances, mapping in snap:
                g = resp.groups.add(name=gname, generation=gen)
                by_inst: dict[str, list] = {i: [] for i in instances}
                for slot in mapping:
                    by_inst.setdefault(slot.assigned_instance_id,
                                       []).append(slot)
                for iid in sorted(instances):
                    m = g.members.add(instance_id=iid)
                    for slot in by_inst.get(iid, []):
                        m.partitions.add(range_start=slot.range_start,
                                         range_stop=slot.range_stop,
                                         ring_size=slot.ring_size)
                for p, _leader in broker._group_partitions(tname):
                    off = broker.fetch_offset(tname, p, gname)
                    po = g.offsets.add(committed=off)
                    po.partition.range_start = p.range_start
                    po.partition.range_stop = p.range_stop
                    po.partition.ring_size = p.ring_size
            return resp

        @svc.unary("CommitOffset", mq.CommitOffsetRequest,
                   mq.CommitOffsetResponse)
        def commit_offset(req, ctx):
            broker.commit_offset(str(tref_of(req.topic)),
                                 part_of(req.partition),
                                 req.consumer_group, req.offset)
            return mq.CommitOffsetResponse()

        @svc.unary("FetchOffset", mq.FetchOffsetRequest,
                   mq.FetchOffsetResponse)
        def fetch_offset(req, ctx):
            off = broker.fetch_offset(str(tref_of(req.topic)),
                                      part_of(req.partition),
                                      req.consumer_group)
            return mq.FetchOffsetResponse(offset=off, found=off >= 0)

        @svc.unary_stream("Subscribe", mq.SubscribeRequest,
                          mq.SubscribeResponse)
        def subscribe(req, ctx):
            """Reference broker_grpc_sub.go: replay from offset, then
            follow if requested."""
            init = req.init
            tref = tref_of(init.topic)
            if broker._topic_partitions(tref) is None:
                ctx.abort(5, f"topic {tref} not found")
            lg = broker._log_for(tref, part_of(init.partition))
            offset = (lg.next_offset if init.start_offset < 0
                      else init.start_offset)
            while ctx.is_active():
                batch = lg.read(offset)
                for off, k, v, ts in batch:
                    resp = mq.SubscribeResponse(offset=off)
                    resp.data.key, resp.data.value = k, v
                    resp.data.ts_ns = ts
                    yield resp
                    offset = off + 1
                if not batch:
                    if not init.follow:
                        yield mq.SubscribeResponse(is_end_of_stream=True)
                        return
                    lg.wait_for(offset, timeout=0.5)

        return svc
