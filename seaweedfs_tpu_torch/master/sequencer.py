"""File-key sequencers (reference weed/sequence: memory_sequencer.go:18
synced via heartbeat MaxFileKey, snowflake_sequencer.go:38).

The port's copy of seaweedfs_tpu/master/sequencer.py.
"""

from __future__ import annotations

import threading
import time


class MemorySequencer:
    def __init__(self, start: int = 1):
        self._next = start
        self._lock = threading.Lock()

    def next_id(self, count: int = 1) -> int:
        with self._lock:
            v = self._next
            self._next += count
            return v

    def set_max(self, seen: int) -> None:
        """Heartbeat MaxFileKey sync (master_grpc_server.go:130)."""
        with self._lock:
            if seen >= self._next:
                self._next = seen + 1

    @property
    def peek(self) -> int:
        return self._next


class SnowflakeSequencer:
    """41b ms-timestamp | 10b node | 12b sequence."""

    EPOCH_MS = 1_600_000_000_000

    def __init__(self, node_id: int = 0):
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_id(self, count: int = 1) -> int:
        with self._lock:
            ms = int(time.time() * 1000) - self.EPOCH_MS
            if ms == self._last_ms:
                self._seq += count
                if self._seq > 0xFFF:
                    while ms <= self._last_ms:
                        ms = int(time.time() * 1000) - self.EPOCH_MS
                    self._seq = 0
            else:
                self._seq = 0
            self._last_ms = ms
            return (ms << 22) | (self.node_id << 12) | self._seq

    def set_max(self, seen: int) -> None:
        pass  # time-based; nothing to sync
