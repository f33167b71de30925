"""Consumer-group coordination (reference weed/mq/sub_coordinator/:
coordinator.go, consumer_group.go, partition_consumer_mapping.go).

A Coordinator lives inside each broker; clients are pointed at THE
coordinator for a (topic, group) by the deterministic FindCoordinator
hash, so exactly one broker balances any given group. Each ConsumerGroup
holds its member instances and a PartitionConsumerMapping; membership or
partition-list changes schedule a debounced rebalance that recomputes a
sticky assignment (surviving members keep their partitions; orphaned
partitions go round-robin to underloaded members — the balance goals at
partition_consumer_mapping.go:21-24) and pushes a generation-stamped
Assignment to every member's response stream.

The port's copy of seaweedfs_tpu/mq/sub_coordinator.py, unchanged.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

from ..utils.log import logger

log = logger("mq.subcoord")

# the reference debounces membership churn by 5s (consumer_group.go:56);
# that cadence is for humans restarting consumers — tests and most real
# rebalances want sub-second convergence, so it is configurable per broker
REBALANCE_DELAY_S = 5.0


@dataclass
class PartitionSlot:
    """One partition slot in a group's mapping (reference
    PartitionSlotToConsumerInstance, partition_list.go)."""
    range_start: int
    range_stop: int
    ring_size: int
    broker: str  # partition leader broker
    assigned_instance_id: str = ""


def balance_sticky(partitions: list[PartitionSlot],
                   instance_ids: list[str],
                   prev: list[PartitionSlot] | None) -> list[PartitionSlot]:
    """Sticky assignment (reference doBalanceSticky,
    partition_consumer_mapping.go:48): keep each partition with its prior
    instance when that instance is still a member, then hand unassigned
    partitions round-robin to instances below the average load."""
    if not partitions or not instance_ids:
        return []
    live = set(instance_ids)
    prev_by_range: dict[tuple[int, int], str] = {}
    for slot in prev or []:
        if slot.assigned_instance_id:
            prev_by_range[(slot.range_start, slot.range_stop)] = \
                slot.assigned_instance_id

    out = [PartitionSlot(p.range_start, p.range_stop, p.ring_size, p.broker)
           for p in partitions]
    counts: dict[str, int] = {i: 0 for i in instance_ids}
    for slot in out:
        keep = prev_by_range.get((slot.range_start, slot.range_stop), "")
        if keep in live:
            slot.assigned_instance_id = keep
            counts[keep] += 1

    avg = len(partitions) / len(instance_ids)
    idx = 0
    for slot in out:
        if slot.assigned_instance_id:
            continue
        for _ in range(len(instance_ids)):
            cand = instance_ids[idx]
            idx = (idx + 1) % len(instance_ids)
            if counts[cand] < avg:
                slot.assigned_instance_id = cand
                counts[cand] += 1
                break

    # divergence from the reference (improvement): its doBalanceSticky only
    # places UNASSIGNED slots, so a newly joined member idles until
    # partitions churn. Steal minimally from overloaded members (Kafka's
    # sticky assignor behavior) until loads differ by at most one.
    while True:
        lo = min(instance_ids, key=lambda i: counts[i])
        hi = max(instance_ids, key=lambda i: counts[i])
        if counts[hi] - counts[lo] <= 1:
            break
        for slot in out:
            if slot.assigned_instance_id == hi:
                slot.assigned_instance_id = lo
                counts[hi] -= 1
                counts[lo] += 1
                break
    return out


class ConsumerGroupInstance:
    """One connected member: its id plus the queue its coordinator stream
    drains (reference ConsumerGroupInstance.ResponseChan)."""

    def __init__(self, instance_id: str):
        self.instance_id = instance_id
        self.responses: "queue.Queue" = queue.Queue()


@dataclass
class ConsumerGroup:
    """Members + mapping for one (topic, group)."""
    topic_name: str
    instances: dict[str, ConsumerGroupInstance] = field(default_factory=dict)
    mapping: list[PartitionSlot] = field(default_factory=list)
    generation: int = 0


class Coordinator:
    """Per-broker group coordinator. `partitions_of` is a callback
    returning the topic's current [(Partition, leader_broker)] so
    rebalances always see live partition leadership (the reference reads
    the pub_balancer's TopicToBrokers map the same way)."""

    def __init__(self, partitions_of, rebalance_delay_s: float | None = None):
        self._partitions_of = partitions_of
        self.delay = (REBALANCE_DELAY_S if rebalance_delay_s is None
                      else rebalance_delay_s)
        # (topic_name, group) -> ConsumerGroup
        self.groups: dict[tuple[str, str], ConsumerGroup] = {}
        self._timers: dict[tuple[str, str], threading.Timer] = {}
        self._lock = threading.Lock()

    def add_subscriber(self, group: str, instance_id: str,
                       topic_name: str) -> ConsumerGroupInstance:
        with self._lock:
            cg = self.groups.setdefault((topic_name, group),
                                        ConsumerGroup(topic_name))
            inst = cg.instances.get(instance_id)
            if inst is None:
                inst = ConsumerGroupInstance(instance_id)
                cg.instances[instance_id] = inst
        self._schedule(topic_name, group,
                       f"add consumer instance {instance_id}")
        return inst

    def remove_subscriber(self, group: str, instance_id: str,
                          topic_name: str) -> None:
        with self._lock:
            cg = self.groups.get((topic_name, group))
            if cg is None:
                return
            cg.instances.pop(instance_id, None)
            empty = not cg.instances
            if empty:
                self.groups.pop((topic_name, group), None)
                t = self._timers.pop((topic_name, group), None)
                if t:
                    t.cancel()
        if not empty:
            self._schedule(topic_name, group,
                           f"remove consumer instance {instance_id}")

    def topic_names(self) -> set[str]:
        """Topics that currently have consumer groups (for the broker's
        membership watcher)."""
        with self._lock:
            return {t for t, _ in self.groups}

    def on_partition_change(self, topic_name: str) -> None:
        """Broker membership / partition leadership moved (reference
        OnPartitionChange, coordinator.go:95): rebalance every group on
        the topic."""
        with self._lock:
            keys = [k for k in self.groups if k[0] == topic_name]
        for tname, group in keys:
            self._schedule(tname, group, "partition list change")

    def shutdown(self) -> None:
        with self._lock:
            for t in self._timers.values():
                t.cancel()
            self._timers.clear()

    # -- rebalance -----------------------------------------------------------
    def _schedule(self, topic_name: str, group: str, reason: str) -> None:
        """Debounce (consumer_group.go:50): restart the timer on every
        membership event so a burst of joins costs one rebalance."""
        key = (topic_name, group)
        with self._lock:
            old = self._timers.pop(key, None)
            if old:
                old.cancel()
            t = threading.Timer(self.delay, self._rebalance,
                                args=(topic_name, group, reason))
            t.daemon = True
            self._timers[key] = t
            t.start()

    def _rebalance(self, topic_name: str, group: str, reason: str) -> None:
        try:
            partitions = self._partitions_of(topic_name)
        except Exception as e:  # noqa: BLE001
            log.warning("rebalance %s/%s: partitions_of failed: %s",
                        topic_name, group, e)
            return
        with self._lock:
            self._timers.pop((topic_name, group), None)
            cg = self.groups.get((topic_name, group))
            if cg is None or not cg.instances:
                return
            slots = [PartitionSlot(p.range_start, p.range_stop, p.ring_size,
                                   leader)
                     for p, leader in partitions]
            cg.mapping = balance_sticky(slots, sorted(cg.instances),
                                        cg.mapping)
            cg.generation += 1
            gen = cg.generation
            members = dict(cg.instances)
            by_instance: dict[str, list[PartitionSlot]] = {}
            for slot in cg.mapping:
                by_instance.setdefault(slot.assigned_instance_id,
                                       []).append(slot)
        log.info("rebalance %s/%s gen %d (%s): %s", topic_name, group, gen,
                 reason,
                 {i: len(by_instance.get(i, [])) for i in members})
        for iid, inst in members.items():
            inst.responses.put((gen, by_instance.get(iid, [])))
