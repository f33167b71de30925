"""Topics + partition ring math (reference weed/mq/topic/partition.go:
PartitionCount = 4096; a topic's partitions split the ring into
contiguous ranges; message keys hash onto the ring).

The port's copy of seaweedfs_tpu/mq/topic.py, unchanged.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

RING_SIZE = 4096  # reference topic/partition.go PartitionCount


@dataclass(frozen=True)
class TopicRef:
    namespace: str
    name: str

    def __str__(self) -> str:
        return f"{self.namespace}.{self.name}"


@dataclass(frozen=True)
class Partition:
    range_start: int
    range_stop: int  # exclusive
    ring_size: int = RING_SIZE

    def covers(self, slot: int) -> bool:
        return self.range_start <= slot < self.range_stop

    def __str__(self) -> str:
        return f"[{self.range_start},{self.range_stop})"


def split_ring(partition_count: int, ring_size: int = RING_SIZE
               ) -> list[Partition]:
    """Contiguous equal ranges (reference allocates this way when a
    topic is configured)."""
    if partition_count <= 0:
        raise ValueError("partition_count must be positive")
    step = ring_size // partition_count
    parts = []
    for i in range(partition_count):
        start = i * step
        stop = ring_size if i == partition_count - 1 else (i + 1) * step
        parts.append(Partition(start, stop, ring_size))
    return parts


def key_slot(key: bytes, ring_size: int = RING_SIZE) -> int:
    if not key:
        return 0
    return int.from_bytes(
        hashlib.md5(key, usedforsecurity=False).digest()[:4],
        "big") % ring_size


def partition_for_key(key: bytes, partitions: list[Partition]) -> Partition:
    slot = key_slot(key, partitions[0].ring_size if partitions else RING_SIZE)
    for p in partitions:
        if p.covers(slot):
            return p
    raise ValueError(f"no partition covers slot {slot}")
