"""In-process Kafka broker double: ApiVersions/Metadata/Produce over the
real wire format, decoding magic-v2 RecordBatches and VERIFYING their
Castagnoli CRC — so notification/kafka.py's producer is exercised
byte-for-byte offline (the reference tests against a dockerized broker;
this image has neither docker nor egress).

The port's copy of seaweedfs_tpu/utils/mini_kafka.py, unchanged; the CRC
check goes through the port's host ops/crc32c. A reference KafkaQueue and
a port KafkaQueue produce into one server alike.
"""

from __future__ import annotations

import socket
import struct
import threading

from ..notification.kafka import (API_METADATA, API_PRODUCE, API_VERSIONS,
                                  _str, read_varint)
from ..ops.crc32c import crc32c
from .log import logger

log = logger("mini-kafka")


class MiniKafka:
    def __init__(self, ip: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((ip, port))
        self._srv.listen(16)
        self.ip, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # topic -> list of (key, value) in produce order
        self.messages: dict[str, list[tuple[bytes, bytes]]] = {}
        self.crc_failures = 0

    @property
    def address(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> "MiniKafka":
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="mini-kafka").start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    # -- wire ---------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        rf = conn.makefile("rb")
        try:
            while not self._stop.is_set():
                raw = rf.read(4)
                if len(raw) < 4:
                    return
                (n,) = struct.unpack(">i", raw)
                req = rf.read(n)
                api_key, api_version, corr = struct.unpack(">hhi", req[:8])
                (cid_len,) = struct.unpack(">h", req[8:10])
                body = req[10 + max(cid_len, 0):]
                resp = struct.pack(">i", corr) + self._dispatch(
                    api_key, api_version, body)
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        except (OSError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, api_key: int, version: int, body: bytes) -> bytes:
        if api_key == API_VERSIONS:
            # error=0, 3 api entries (key, min, max)
            entries = [(API_PRODUCE, 0, 3), (API_METADATA, 0, 1),
                       (API_VERSIONS, 0, 0)]
            out = struct.pack(">hi", 0, len(entries))
            for k, lo, hi in entries:
                out += struct.pack(">hhh", k, lo, hi)
            return out
        if api_key == API_METADATA:
            (ntopics,) = struct.unpack(">i", body[:4])
            pos = 4
            topics = []
            for _ in range(max(ntopics, 0)):
                (tl,) = struct.unpack(">h", body[pos:pos + 2])
                topics.append(body[pos + 2:pos + 2 + tl].decode())
                pos += 2 + tl
            # v1: brokers[id host port rack] controller_id topics[...]
            out = struct.pack(">i", 1)  # one broker
            out += struct.pack(">i", 0) + _str(self.ip) \
                + struct.pack(">i", self.port) + _str(None)
            out += struct.pack(">i", 0)  # controller id
            out += struct.pack(">i", len(topics))
            for t in topics:
                with self._lock:
                    self.messages.setdefault(t, [])
                out += struct.pack(">h", 0) + _str(t) + b"\x00"  # internal
                out += struct.pack(">i", 1)  # one partition
                out += struct.pack(">hiii", 0, 0, 0, 1)  # err pid leader nrep
                out += struct.pack(">i", 0)  # replica 0
                out += struct.pack(">i", 0)  # no isr entries... must be count
            return out
        if api_key == API_PRODUCE:
            return self._produce(body)
        raise ValueError(f"unsupported api key {api_key}")

    def _produce(self, body: bytes) -> bytes:
        pos = 0
        (tid_len,) = struct.unpack(">h", body[pos:pos + 2])
        pos += 2 + max(tid_len, 0)
        acks, timeout, ntopics = struct.unpack(">hii", body[pos:pos + 10])
        pos += 10
        resp_topics = b""
        for _ in range(ntopics):
            (tl,) = struct.unpack(">h", body[pos:pos + 2])
            topic = body[pos + 2:pos + 2 + tl].decode()
            pos += 2 + tl
            (nparts,) = struct.unpack(">i", body[pos:pos + 4])
            pos += 4
            part_resp = b""
            for _ in range(nparts):
                partition, blen = struct.unpack(">ii", body[pos:pos + 8])
                pos += 8
                batch = body[pos:pos + blen]
                pos += blen
                err = self._ingest_batch(topic, batch)
                part_resp += struct.pack(">ihqq", partition, err, 0, -1)
            resp_topics += _str(topic) + struct.pack(">i", nparts) + part_resp
        # v3 response: topics[...] throttle_time
        return struct.pack(">i", ntopics) + resp_topics \
            + struct.pack(">i", 0)

    def _ingest_batch(self, topic: str, batch: bytes) -> int:
        # RecordBatch v2: baseOffset(8) batchLength(4) leaderEpoch(4)
        # magic(1) crc(4) ...after-crc bytes...
        if len(batch) < 21 or batch[16] != 2:
            return 2  # CORRUPT_MESSAGE
        (crc,) = struct.unpack(">I", batch[17:21])
        after = batch[21:]
        if (crc32c(after) & 0xFFFFFFFF) != crc:
            with self._lock:
                self.crc_failures += 1
            return 2
        # after-crc: attributes(2) lastOffsetDelta(4) ts(8) ts(8) pid(8)
        # epoch(2) baseSeq(4) count(4) records
        (count,) = struct.unpack(">i", after[36:40])
        pos = 40
        out = []
        for _ in range(count):
            _, pos = read_varint(after, pos)        # record length
            pos += 1                                 # attributes
            _, pos = read_varint(after, pos)         # ts delta
            _, pos = read_varint(after, pos)         # offset delta
            klen, pos = read_varint(after, pos)
            key = after[pos:pos + klen]
            pos += klen
            vlen, pos = read_varint(after, pos)
            value = after[pos:pos + vlen]
            pos += vlen
            nhdr, pos = read_varint(after, pos)
            for _ in range(nhdr):  # consume header key/value bytes
                hklen, pos = read_varint(after, pos)
                pos += hklen
                hvlen, pos = read_varint(after, pos)
                pos += max(hvlen, 0)
            out.append((key, value))
        with self._lock:
            self.messages.setdefault(topic, []).extend(out)
        return 0
