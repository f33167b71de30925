"""Consumer-group client (reference weed/mq/client/sub_client/: the
subscriber session holds a SubscriberToSubCoordinator stream for
assignments and one Subscribe stream per assigned partition).

Lifecycle: FindCoordinator on any live broker -> join the coordination
stream -> each Assignment (re)spawns partition workers. A worker fetches
the group's committed offset, subscribes from offset+1 on the partition
leader, and funnels records into one poll() queue. Any stream death —
coordinator or partition — re-resolves against the surviving brokers and
resumes from committed offsets, so a broker crash costs redelivery of at
most the uncommitted window (at-least-once; commit-per-record gives
effectively-once for side-effect-free processing).

The port's copy of seaweedfs_tpu/mq/consumer.py. The service name comes
from the port's utils/rpc (the reference imports it from mq/broker). One
fix of the port's (ROADMAP Queue 3): a partition worker that is stopped
(revoked, moved to a new leader, or the member closed) cancels its
Subscribe stream. The reference's worker notices its stop only when the
next record arrives, so on a quiet partition the stream, and the broker's
gRPC worker thread under it (16 a broker), stays held until the broker
stops.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

from ..pb import mq_pb2 as mq
from ..utils.log import logger
from ..utils.rpc import MQ_SERVICE, Stub
from .topic import Partition, TopicRef

log = logger("mq.consumer")


@dataclass(frozen=True)
class ConsumerRecord:
    partition: Partition
    leader: str  # broker serving the partition when this was read
    offset: int
    key: bytes
    value: bytes
    ts_ns: int


class GroupConsumer:
    """One consumer-group member."""

    def __init__(self, brokers: list[str] | str, namespace: str, topic: str,
                 group: str, instance_id: str,
                 retry_interval_s: float = 0.2):
        self.seeds = ([brokers] if isinstance(brokers, str)
                      else list(brokers))
        self.tref = TopicRef(namespace, topic)
        self.group = group
        self.instance_id = instance_id
        self.retry = retry_interval_s
        self.records: "queue.Queue[ConsumerRecord]" = queue.Queue()
        self.generation = 0
        self.assigned: dict[int, tuple[Partition, str]] = {}
        self._workers: dict[int, threading.Event] = {}  # range_start -> stop
        self._calls: "dict[threading.Event, object]" = {}  # stop -> stream
        # highest offset ALREADY put on the records queue, per partition:
        # a worker restart (stream death, leader failover) resumes from the
        # committed offset, and this watermark drops the redelivered slice
        # this member has already seen — exactly-once delivery within one
        # member; cross-member handoff remains at-least-once past the
        # committed offset (same contract as the reference)
        self._delivered: dict[int, int] = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._assigned_once = threading.Event()
        self._thread = threading.Thread(target=self._session, daemon=True,
                                        name=f"mq-consumer-{instance_id}")
        self._thread.start()

    # -- public --------------------------------------------------------------
    def poll(self, timeout: float = 5.0) -> ConsumerRecord | None:
        """Next record from any assigned partition. Records whose
        partition has been revoked since they were queued are dropped —
        a revoked partition's uncommitted tail belongs to its NEW owner,
        and delivering it here after the owner re-reads it would be a
        guaranteed duplicate (the remaining cross-member window is the
        in-flight record the app is processing at revoke time:
        at-least-once, same contract as the reference / Kafka sans EOS)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                rec = self.records.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                return None
            with self._lock:
                if rec.partition.range_start in self._workers:
                    return rec
            # revoked while queued: drop and keep polling

    def commit(self, rec: ConsumerRecord) -> None:
        """Persist rec.offset as processed; resume after failure happens
        at rec.offset + 1. Tries the record's leader first, then any
        live broker (offsets live in the shared filer)."""
        req = mq.CommitOffsetRequest(consumer_group=self.group,
                                     offset=rec.offset)
        req.topic.namespace = self.tref.namespace
        req.topic.name = self.tref.name
        req.partition.range_start = rec.partition.range_start
        req.partition.range_stop = rec.partition.range_stop
        req.partition.ring_size = rec.partition.ring_size
        for addr in [rec.leader, *self.seeds]:
            try:
                Stub(addr, MQ_SERVICE).call("CommitOffset", req,
                                            mq.CommitOffsetResponse,
                                            timeout=5)
                return
            except Exception:  # noqa: BLE001
                continue
        raise RuntimeError(f"commit offset {rec.offset} failed on all brokers")

    def wait_assigned(self, timeout: float = 10.0) -> bool:
        return self._assigned_once.wait(timeout)

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            for ev in self._workers.values():
                self._stop_worker(ev)

    def _stop_worker(self, stop: threading.Event) -> None:
        """Stop a partition worker and cancel its Subscribe stream, so the
        broker's worker thread is released now, not at the next record
        (caller holds self._lock)."""
        stop.set()
        call = self._calls.pop(stop, None)
        if call is not None:
            call.cancel()

    # -- coordinator session -------------------------------------------------
    def _find_coordinator(self) -> str | None:
        req = mq.FindCoordinatorRequest(consumer_group=self.group)
        req.topic.namespace = self.tref.namespace
        req.topic.name = self.tref.name
        for addr in self.seeds:
            try:
                resp = Stub(addr, MQ_SERVICE).call(
                    "FindCoordinator", req, mq.FindCoordinatorResponse,
                    timeout=2)
                if resp.coordinator:
                    return resp.coordinator
            except Exception:  # noqa: BLE001
                continue
        return None

    def _session(self) -> None:
        while not self._closed.is_set():
            coord = self._find_coordinator()
            if coord is None:
                self._closed.wait(self.retry)
                continue
            try:
                self._run_coordination(coord)
            except Exception as e:  # noqa: BLE001
                if not self._closed.is_set():
                    log.info("%s: coordinator %s lost (%s); rejoining",
                             self.instance_id, coord, e)
            self._closed.wait(self.retry)
        # shutdown: stop all workers
        self._apply_assignment(self.generation + 1, [])

    def _run_coordination(self, coord: str) -> None:
        # a fresh coordinator (failover) starts its generations over at 1:
        # reset ours so its first assignment isn't dropped as stale
        with self._lock:
            self.generation = 0
        stub = Stub(coord, MQ_SERVICE)

        def reqs():
            init = mq.SubscriberToSubCoordinatorRequest()
            init.init.consumer_group = self.group
            init.init.consumer_group_instance_id = self.instance_id
            init.init.topic.namespace = self.tref.namespace
            init.init.topic.name = self.tref.name
            yield init
            while not self._closed.wait(0.5):
                pass  # stream held open; half-close on close()

        stream = stub.stream_stream(
            "SubscriberToSubCoordinator", reqs(),
            mq.SubscriberToSubCoordinatorRequest,
            mq.SubscriberToSubCoordinatorResponse)
        for resp in stream:
            if self._closed.is_set():
                stream.cancel()
                return
            a = resp.assignment
            slots = [(Partition(pa.partition.range_start,
                                pa.partition.range_stop,
                                pa.partition.ring_size or 4096),
                      pa.leader_broker)
                     for pa in a.partition_assignments]
            self._apply_assignment(a.generation, slots)
            self._assigned_once.set()

    def _apply_assignment(self, generation: int,
                          slots: list[tuple[Partition, str]]) -> None:
        """Diff against current workers: stop revoked partitions, spawn
        newly assigned ones. A re-assigned partition with a NEW leader is
        restarted so it follows the failover."""
        with self._lock:
            if 0 < generation <= self.generation:
                return  # stale assignment from a lagging coordinator
            self.generation = generation
            want = {p.range_start: (p, leader) for p, leader in slots}
            for rs in list(self._workers):
                if rs not in want or self.assigned.get(rs) != want[rs]:
                    self._stop_worker(self._workers.pop(rs))
                    self.assigned.pop(rs, None)
                    if rs not in want:
                        # truly revoked (not a leader-change restart):
                        # purge its queued records NOW — if the partition
                        # later returns, stale first-ownership records
                        # would pass poll's membership check while the
                        # fresh worker re-reads the same offsets (double
                        # delivery) — and reset the watermark, since
                        # suppressing offsets we queued but never
                        # processed would turn the purge into loss
                        self._purge_queued(rs)
                        self._delivered.pop(rs, None)
            to_start = []
            for rs, (p, leader) in want.items():
                if rs in self._workers:
                    continue
                stop = threading.Event()
                self._workers[rs] = stop
                self.assigned[rs] = (p, leader)
                to_start.append(threading.Thread(
                    target=self._consume_partition,
                    args=(p, leader, stop), daemon=True,
                    name=f"mq-part-{self.instance_id}-{rs}"))
        # spawn OUTSIDE the lock: Thread.start() blocks on the new
        # thread's bootstrap, and under load N spawns serialized behind
        # self._lock stall every concurrent poll()/commit() for the
        # whole rebalance (locktrack long-hold finding)
        for t in to_start:
            t.start()

    def _purge_queued(self, range_start: int) -> None:
        """Drop a revoked partition's not-yet-polled records, preserving
        the order of everything else."""
        keep: list[ConsumerRecord] = []
        while True:
            try:
                rec = self.records.get_nowait()
            except queue.Empty:
                break
            if rec.partition.range_start != range_start:
                keep.append(rec)
        for rec in keep:
            self.records.put(rec)

    # -- partition worker ----------------------------------------------------
    def _fetch_offset(self, p: Partition, leader: str) -> int:
        req = mq.FetchOffsetRequest(consumer_group=self.group)
        req.topic.namespace = self.tref.namespace
        req.topic.name = self.tref.name
        req.partition.range_start = p.range_start
        req.partition.range_stop = p.range_stop
        req.partition.ring_size = p.ring_size
        for addr in [leader, *self.seeds]:
            try:
                resp = Stub(addr, MQ_SERVICE).call(
                    "FetchOffset", req, mq.FetchOffsetResponse, timeout=5)
                return resp.offset if resp.found else -1
            except Exception:  # noqa: BLE001
                continue
        return -1

    def _lookup_leader(self, p: Partition) -> str | None:
        req = mq.LookupTopicBrokersRequest()
        req.topic.namespace = self.tref.namespace
        req.topic.name = self.tref.name
        for addr in self.seeds:
            try:
                resp = Stub(addr, MQ_SERVICE).call(
                    "LookupTopicBrokers", req,
                    mq.LookupTopicBrokersResponse, timeout=2)
                for a in resp.assignments:
                    if a.partition.range_start == p.range_start:
                        return a.leader_broker
            except Exception:  # noqa: BLE001
                continue
        return None

    def _consume_partition(self, p: Partition, leader: str,
                           stop: threading.Event) -> None:
        while not stop.is_set() and not self._closed.is_set():
            start = self._fetch_offset(p, leader) + 1
            req = mq.SubscribeRequest()
            req.init.topic.namespace = self.tref.namespace
            req.init.topic.name = self.tref.name
            req.init.partition.range_start = p.range_start
            req.init.partition.range_stop = p.range_stop
            req.init.partition.ring_size = p.ring_size
            req.init.consumer_group = self.group
            req.init.consumer_id = self.instance_id
            req.init.start_offset = start
            req.init.follow = True
            try:
                stream = Stub(leader, MQ_SERVICE).call_stream(
                    "Subscribe", req, mq.SubscribeResponse, timeout=3600)
                with self._lock:
                    if stop.is_set():
                        stream.cancel()
                        return
                    self._calls[stop] = stream
                for resp in stream:
                    if stop.is_set() or self._closed.is_set():
                        stream.cancel()
                        return
                    if resp.is_end_of_stream:
                        break
                    # watermark + enqueue under the consumer lock, fenced
                    # on THIS worker still owning the partition: a revoke
                    # (purge + watermark reset, _apply_assignment) cannot
                    # be undone by an in-flight record, and a purge can
                    # never interleave with a concurrent put
                    with self._lock:
                        if stop.is_set() or \
                                self._workers.get(p.range_start) is not stop:
                            return
                        if resp.offset <= self._delivered.get(
                                p.range_start, -1):
                            continue  # redelivery already queued
                        self._delivered[p.range_start] = resp.offset
                        self.records.put(ConsumerRecord(
                            p, leader, resp.offset, bytes(resp.data.key),
                            bytes(resp.data.value), resp.data.ts_ns))
            except Exception as e:  # noqa: BLE001
                if stop.is_set() or self._closed.is_set():
                    return
                log.info("%s: partition %s stream on %s died (%s)",
                         self.instance_id, p, leader, e)
            if stop.wait(self.retry):
                return
            # leader may have moved (broker death): re-resolve before
            # the next attempt; the coordinator will also push a fresh
            # assignment, which restarts this worker via _apply_assignment
            leader = self._lookup_leader(p) or leader


def group_consume(brokers, namespace: str, topic: str, group: str,
                  instance_id: str, count: int,
                  timeout: float = 30.0,
                  commit_each: bool = True) -> list[ConsumerRecord]:
    """Convenience: consume exactly `count` records as one group member,
    committing after each (test harness + CLI verb helper)."""
    c = GroupConsumer(brokers, namespace, topic, group, instance_id)
    out: list[ConsumerRecord] = []
    deadline = time.monotonic() + timeout
    try:
        while len(out) < count and time.monotonic() < deadline:
            rec = c.poll(timeout=max(0.05,
                                     min(1.0, deadline - time.monotonic())))
            if rec is None:
                continue
            out.append(rec)
            if commit_each:
                c.commit(rec)
    finally:
        c.close()
    return out
