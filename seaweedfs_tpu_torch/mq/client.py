"""MQ client: publisher + subscriber over the broker gRPC
(reference weed/mq/client: pub_client / sub_client).

The port's copy of seaweedfs_tpu/mq/client.py. The service name comes from
the port's utils/rpc (the reference imports it from mq/broker), so a
publisher or subscriber loads no broker code.
"""

from __future__ import annotations

import queue
import time

from ..pb import mq_pb2 as mq
from ..utils.rpc import MQ_SERVICE, Stub
from .topic import Partition, TopicRef, partition_for_key, split_ring


class Publisher:
    """Leader-aware publisher: each partition's Publish stream dials the
    broker that LookupTopicBrokers names as its leader, and a dead leader
    (broker crash) is survived by re-looking-up on the remaining seed
    brokers and re-sending the unacked message (reference
    pub_client/publish.go re-dials the same way)."""

    def __init__(self, broker_address: "str | list[str]", namespace: str,
                 topic: str, partition_count: int = 1, schema=None):
        self.seeds = ([broker_address] if isinstance(broker_address, str)
                      else list(broker_address))
        self.stub = Stub(self.seeds[0], MQ_SERVICE)
        self.tref = TopicRef(namespace, topic)
        self.schema = schema  # mq.schema.Schema: typed-record publishing
        resp = self.stub.call("ConfigureTopic", _configure_req(
            self.tref, partition_count,
            schema.schema_bytes() if schema is not None else b""),
            mq.ConfigureTopicResponse)
        self.partitions = [Partition(a.partition.range_start,
                                     a.partition.range_stop,
                                     a.partition.ring_size)
                           for a in resp.assignments]
        self._leaders = {a.partition.range_start: a.leader_broker
                         for a in resp.assignments}
        self._queues: dict[int, queue.Queue] = {}
        self._streams: dict[int, object] = {}

    def _refresh_leaders(self) -> None:
        for addr in self.seeds:
            try:
                resp = Stub(addr, MQ_SERVICE).call(
                    "LookupTopicBrokers", _lookup_req(self.tref),
                    mq.LookupTopicBrokersResponse, timeout=2)
                self._leaders = {a.partition.range_start: a.leader_broker
                                 for a in resp.assignments}
                return
            except Exception:  # noqa: BLE001
                continue

    def _drop_stream(self, p: Partition) -> None:
        q = self._queues.pop(p.range_start, None)
        if q is not None:
            q.put(None)
        self._streams.pop(p.range_start, None)

    def _stream_for(self, p: Partition):
        if p.range_start in self._streams:
            return (self._queues[p.range_start],
                    self._streams[p.range_start])
        q: queue.Queue = queue.Queue()

        def reqs():
            init = mq.PublishRequest()
            init.init.topic.namespace = self.tref.namespace
            init.init.topic.name = self.tref.name
            init.init.partition.range_start = p.range_start
            init.init.partition.range_stop = p.range_stop
            init.init.partition.ring_size = p.ring_size
            yield init
            while True:
                item = q.get()
                if item is None:
                    return
                yield item

        leader = self._leaders.get(p.range_start, self.seeds[0])
        stream = Stub(leader, MQ_SERVICE).stream_stream(
            "Publish", reqs(), mq.PublishRequest, mq.PublishResponse)
        self._queues[p.range_start] = q
        self._streams[p.range_start] = iter(stream)
        return q, self._streams[p.range_start]

    def publish(self, key: bytes, value: bytes, retries: int = 8) -> int:
        """Send one message; returns the acked partition offset. A broken
        stream re-resolves the partition leader and re-sends. Semantics
        are AT-LEAST-ONCE (same as the reference's re-dial): if the
        leader appended the message but died before the ack arrived, the
        retry appends it again on the survivor."""
        p = partition_for_key(key, self.partitions)
        req = mq.PublishRequest()
        req.data.key, req.data.value = key, value
        req.data.ts_ns = time.time_ns()
        last_err: Exception | None = None
        for attempt in range(retries):
            try:
                q, stream = self._stream_for(p)
                q.put(req)
                ack = next(stream)
                if ack.error:
                    raise RuntimeError(ack.error)
                return ack.ack_sequence
            except Exception as e:  # noqa: BLE001
                last_err = e
                self._drop_stream(p)
                time.sleep(min(0.2 * (attempt + 1), 1.0))
                self._refresh_leaders()
        raise RuntimeError(f"publish to {p} failed: {last_err}")

    def publish_record(self, key: bytes, record) -> int:
        """Typed publish: encode `record` (dict/dataclass) with the
        topic's registered schema."""
        if self.schema is None:
            raise ValueError("publisher has no schema (pass schema=)")
        return self.publish(key, self.schema.encode(record))

    def close(self) -> None:
        for q in self._queues.values():
            q.put(None)


def _configure_req(tref: TopicRef, n: int,
                   record_type: bytes = b"") -> mq.ConfigureTopicRequest:
    req = mq.ConfigureTopicRequest(partition_count=n,
                                   record_type=record_type)
    req.topic.namespace = tref.namespace
    req.topic.name = tref.name
    return req


def topic_schema(broker_address: str, namespace: str, topic: str):
    """Fetch a topic's registered schema (GetTopicConfiguration); None
    for schemaless topics. Subscribers decode records with it."""
    from .schema import Schema
    req = mq.GetTopicConfigurationRequest()
    req.topic.namespace = namespace
    req.topic.name = topic
    resp = Stub(broker_address, MQ_SERVICE).call(
        "GetTopicConfiguration", req, mq.GetTopicConfigurationResponse)
    return Schema.from_bytes(bytes(resp.record_type)) \
        if resp.record_type else None


def subscribe(broker_address: str, namespace: str, topic: str,
              start_offset: int = 0, follow: bool = False,
              partition: Partition | None = None):
    """Yield (offset, key, value) from one partition (default: the whole
    ring when the topic has a single partition)."""
    stub = Stub(broker_address, MQ_SERVICE)
    tref = TopicRef(namespace, topic)
    if partition is None:
        resp = stub.call("LookupTopicBrokers",
                         _lookup_req(tref), mq.LookupTopicBrokersResponse)
        a = resp.assignments[0]
        partition = Partition(a.partition.range_start,
                              a.partition.range_stop,
                              a.partition.ring_size)
    req = mq.SubscribeRequest()
    req.init.topic.namespace = tref.namespace
    req.init.topic.name = tref.name
    req.init.partition.range_start = partition.range_start
    req.init.partition.range_stop = partition.range_stop
    req.init.partition.ring_size = partition.ring_size
    req.init.start_offset = start_offset
    req.init.follow = follow
    for resp in stub.call_stream("Subscribe", req, mq.SubscribeResponse,
                                 timeout=3600):
        if resp.is_end_of_stream:
            return
        yield resp.offset, bytes(resp.data.key), bytes(resp.data.value)


def _lookup_req(tref: TopicRef) -> mq.LookupTopicBrokersRequest:
    req = mq.LookupTopicBrokersRequest()
    req.topic.namespace = tref.namespace
    req.topic.name = tref.name
    return req
