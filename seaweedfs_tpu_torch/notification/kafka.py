"""Kafka-protocol notification queue: the real wire format, no SDK.

Reference: weed/notification/kafka/kafka_queue.go publishes filer events
to Kafka via the sarama SDK. This module speaks the Kafka protocol
directly — ApiVersions (key 18), Metadata (key 3 v1), and Produce
(key 0 v3) with magic-v2 RecordBatches, including the batch's CRC32C
(Castagnoli, computed by ops/crc32c like every needle checksum) — so
events land on any Kafka 0.11+ broker, and offline on
utils/mini_kafka.MiniKafka which decodes and CRC-verifies the batches.

Produce-only, like the reference's queue (consumers are downstream
systems, not seaweed's concern).

The port's copy of seaweedfs_tpu/notification/kafka.py, unchanged. The
batch CRC is a host CRC of one small buffer, as in the reference: the
port's ops/crc32c.crc32c (its C library), not the device kernel K3.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from ..ops.crc32c import crc32c
from ..pb import filer_pb2 as fpb
from ..utils.log import logger
from .queues import MessageQueue

log = logger("notification.kafka")

API_PRODUCE = 0
API_METADATA = 3
API_VERSIONS = 18


# -- primitive wire encoding -------------------------------------------------

def _str(s: "str | None") -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes(b: "bytes | None") -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _varint(n: int) -> bytes:
    """Zigzag varint (record fields inside a v2 batch)."""
    z = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        if z & ~0x7F:
            out.append((z & 0x7F) | 0x80)
            z >>= 7
        else:
            out.append(z)
            return bytes(out)


def read_varint(buf: bytes, pos: int) -> "tuple[int, int]":
    shift = z = 0
    while True:
        b = buf[pos]
        pos += 1
        z |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (z >> 1) ^ -(z & 1), pos


def encode_record(key: bytes, value: bytes, offset_delta: int) -> bytes:
    body = (b"\x00"                       # attributes
            + _varint(0)                  # timestampDelta
            + _varint(offset_delta)
            + _varint(len(key)) + key
            + _varint(len(value)) + value
            + _varint(0))                 # headers count
    return _varint(len(body)) + body


def encode_record_batch(records: "list[tuple[bytes, bytes]]") -> bytes:
    """Magic-v2 RecordBatch with a real Castagnoli CRC."""
    now_ms = int(time.time() * 1000)
    recs = b"".join(encode_record(k, v, i)
                    for i, (k, v) in enumerate(records))
    after_crc = (struct.pack(">hiqqqhi",
                             0,                    # attributes
                             len(records) - 1,     # lastOffsetDelta
                             now_ms, now_ms,       # first/max timestamp
                             -1, -1, -1)           # producerId/Epoch/baseSeq
                 + struct.pack(">i", len(records)) + recs)
    crc = crc32c(after_crc) & 0xFFFFFFFF
    # the v2 CRC is the RAW Castagnoli state (no final-xor convention
    # difference: kafka uses the standard crc32c, same as ours)
    batch_tail = b"\x02" + struct.pack(">I", crc) + after_crc  # magic + crc
    head = struct.pack(">qi", 0, len(batch_tail) + 4)  # baseOffset, length
    return head + struct.pack(">i", -1) + batch_tail   # partitionLeaderEpoch


class _Conn:
    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rf = self.sock.makefile("rb")
        self.client_id = client_id
        self._corr = 0

    def request(self, api_key: int, api_version: int, body: bytes) -> bytes:
        self._corr += 1
        hdr = (struct.pack(">hhi", api_key, api_version, self._corr)
               + _str(self.client_id))
        msg = hdr + body
        self.sock.sendall(struct.pack(">i", len(msg)) + msg)
        raw = self.rf.read(4)
        if len(raw) < 4:
            raise ConnectionError("kafka broker closed connection")
        (n,) = struct.unpack(">i", raw)
        resp = self.rf.read(n)
        if len(resp) < n:
            # died mid-response: surface as the retryable class
            raise ConnectionError("kafka broker truncated response")
        (corr,) = struct.unpack(">i", resp[:4])
        if corr != self._corr:
            raise OSError(f"kafka correlation mismatch {corr}!={self._corr}")
        return resp[4:]

    def close(self) -> None:
        try:
            self.rf.close()
            self.sock.close()
        except OSError:
            pass


class KafkaQueue(MessageQueue):
    """Filer event notification onto a Kafka topic (kafka_queue.go)."""

    name = "kafka"

    def __init__(self, address: str, topic: str = "seaweedfs_filer"):
        self.topic = topic
        host, _, port = address.rpartition(":")
        self._host = host or address
        self._port = int(port) if port.isdigit() else 9092
        self._local = threading.local()
        self._conns: list[_Conn] = []  # every thread's conn, for close()
        self._conns_lock = threading.Lock()
        # handshake once: ApiVersions + Metadata prove the peer speaks
        # kafka and auto-creates/locates the topic
        c = self._conn()
        c.request(API_VERSIONS, 0, b"")
        c.request(API_METADATA, 1, struct.pack(">i", 1) + _str(self.topic))

    def _conn(self) -> _Conn:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = self._local.conn = _Conn(self._host, self._port,
                                         "seaweedfs-tpu")
            with self._conns_lock:
                self._conns.append(c)
        return c

    def send(self, key: str, ev: fpb.EventNotification) -> None:
        batch = encode_record_batch([(key.encode(),
                                      ev.SerializeToString())])
        body = (_str(None)                     # transactional_id
                + struct.pack(">hi", 1, 10_000)  # acks=1, timeout
                + struct.pack(">i", 1)           # 1 topic
                + _str(self.topic)
                + struct.pack(">i", 1)           # 1 partition
                + struct.pack(">i", 0)           # partition 0
                + _bytes(batch))
        try:
            resp = self._conn().request(API_PRODUCE, 3, body)
        except (ConnectionError, OSError):
            # one reconnect (broker restarted between events)
            self._conn().close()
            self._local.conn = None
            resp = self._conn().request(API_PRODUCE, 3, body)
        # response: [topics][partitions] partition(int32) error(int16) ...
        # error code sits right after the first partition index (topic
        # length on the wire is UTF-8 BYTES, not characters)
        pos = 4 + 2 + len(self.topic.encode()) + 4 + 4
        (err,) = struct.unpack(">h", resp[pos:pos + 2])
        if err:
            raise OSError(f"kafka produce error code {err}")

    def close(self) -> None:
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:  # every sender thread's socket, not just ours
            c.close()
        self._local.conn = None
