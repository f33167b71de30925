"""Metadata-event notification queues (reference weed/notification).

The filer publishes every namespace mutation (EventNotification) to an
optional message queue besides its own meta log (filer_notify.go:20-66).
The reference ships kafka / AWS SQS / GCP PubSub / GoCDK backends behind
`notification.toml`; this package provides the same seam with two
built-in queues (in-memory fan-out and a durable log file) and gated
stubs for the cloud brokers (their SDKs aren't in the image).

The port's copy of seaweedfs_tpu/notification/, every queue: memory,
logfile, mq (the port's own broker) and kafka (the wire protocol, its
RecordBatch CRC through the port's host ops/crc32c).
"""

from .queues import (LogFileQueue, MemoryQueue, MessageQueue, open_queue)

__all__ = ["MessageQueue", "MemoryQueue", "LogFileQueue", "open_queue"]
