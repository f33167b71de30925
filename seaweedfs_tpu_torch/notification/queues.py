"""MessageQueue implementations.

Interface mirrors reference notification/configuration.go
(`MessageQueue.SendMessage(key, message)`); messages are
(key=full path, value=EventNotification) pairs.

The port's copy of seaweedfs_tpu/notification/queues.py, unchanged: a
LogFileQueue record is byte-equal to the reference's for the same event,
and `mq:` publishes through the port's mq/client.Publisher.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Callable, Iterator

from ..pb import filer_pb2 as fpb
from ..utils.log import logger

log = logger("notification")


class MessageQueue:
    name = "abstract"

    def send(self, key: str, ev: fpb.EventNotification) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryQueue(MessageQueue):
    """In-process fan-out to subscribers (test/dev; plays the role the
    reference's gocdk mempubsub plays)."""

    name = "memory"

    def __init__(self):
        self._subs: list[Callable[[str, fpb.EventNotification], None]] = []
        self._lock = threading.Lock()

    def subscribe(self, fn: Callable[[str, fpb.EventNotification], None]) -> None:
        with self._lock:
            self._subs.append(fn)

    def send(self, key: str, ev: fpb.EventNotification) -> None:
        with self._lock:
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(key, ev)
            except Exception as e:  # noqa: BLE001
                log.warning("subscriber error for %s: %s", key, e)


class LogFileQueue(MessageQueue):
    """Durable length-prefixed record log; `weed filer.replicate` style
    consumers read from an offset (the file-backed analogue of a broker
    topic — same framing as the filer meta log)."""

    name = "logfile"

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        self._lock = threading.Lock()

    def send(self, key: str, ev: fpb.EventNotification) -> None:
        rec = fpb.SubscribeMetadataResponse(directory=key)
        rec.event_notification.CopyFrom(ev)
        blob = rec.SerializeToString()
        with self._lock:
            self._f.write(struct.pack("<I", len(blob)))
            self._f.write(blob)
            self._f.flush()

    def read(self, offset: int = 0
             ) -> Iterator[tuple[int, fpb.SubscribeMetadataResponse]]:
        """Yield (next_offset, record) from byte offset."""
        with open(self.path, "rb") as f:
            f.seek(offset)
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    return
                (n,) = struct.unpack("<I", hdr)
                blob = f.read(n)
                if len(blob) < n:
                    return
                rec = fpb.SubscribeMetadataResponse()
                rec.ParseFromString(blob)
                yield f.tell(), rec

    def close(self) -> None:
        with self._lock:
            self._f.close()


def open_queue(spec: str) -> MessageQueue:
    """spec: 'memory', 'logfile:/path', or a gated broker name.
    Reference notification.toml picks one enabled backend the same way."""
    kind, _, arg = spec.partition(":")
    if kind == "memory":
        return MemoryQueue()
    if kind == "logfile":
        return LogFileQueue(arg or "notification.log")
    if kind == "mq":
        addr, _, rest = arg.partition("/")
        ns, _, topic = rest.partition("/")
        return MqQueue(addr, namespace=ns or "notifications",
                       topic=topic or "filer")
    if kind == "kafka":
        # the real Kafka wire protocol, no SDK: 'kafka:host:port/topic'
        from .kafka import KafkaQueue
        addr, _, topic = arg.partition("/")
        return KafkaQueue(addr, topic=topic or "seaweedfs_filer")
    if kind in ("aws_sqs", "gcp_pub_sub", "gocdk_pub_sub"):
        raise RuntimeError(
            f"notification backend {kind!r} requires its broker SDK, "
            "which is not in this image (reference gates these behind "
            "notification.toml the same way)")
    raise ValueError(f"unknown notification queue {spec!r}")


class MqQueue(MessageQueue):
    """Publish metadata events into the framework's OWN message queue
    (the reference fans out to Kafka/SQS/PubSub via notification.toml;
    here the built-in broker plays that role — spec 'mq:host:port' or
    'mq:host:port/namespace/topic'). Lazy-connects and drops events with a
    warning while the broker is down, like the reference's best-effort
    notifiers."""

    name = "mq"

    def __init__(self, broker_address: str, namespace: str = "notifications",
                 topic: str = "filer"):
        self.broker_address = broker_address
        self.namespace, self.topic = namespace, topic
        self._pub = None
        self._lock = threading.Lock()

    def _publisher(self):
        if self._pub is None:
            from ..mq.client import Publisher
            self._pub = Publisher(self.broker_address, self.namespace,
                                  self.topic)
        return self._pub

    def send(self, key: str, ev: fpb.EventNotification) -> None:
        with self._lock:
            try:
                self._publisher().publish(key.encode(),
                                          ev.SerializeToString())
            except Exception as e:  # noqa: BLE001 — best-effort notifier
                self._pub = None
                log.warning("mq notify %s: %s", key, e)

    def close(self) -> None:
        with self._lock:
            if self._pub is not None:
                try:
                    self._pub.close()
                except Exception as e:  # noqa: BLE001
                    log.debug("notification publisher close failed: %s", e)
                self._pub = None
