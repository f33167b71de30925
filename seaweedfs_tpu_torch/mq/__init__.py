"""Message queue (reference weed/mq, 6,379 LoC — SURVEY.md §2.7).

Topics split into partitions over a 4096-slot ring (mq/topic/
partition.go); brokers register in the master cluster and own partition
ranges (pub_balancer/balancer.go); pub/sub are gRPC streams with acked
offsets (broker/broker_grpc_pub.go, _sub.go); closed segments persist
through the filer under /topics/<ns>/<topic>/. Consumer groups
coordinate through the broker-side sub coordinator
(mq/sub_coordinator/) with sticky rebalancing and filer-persisted
committed offsets; structured records are typed by mq/schema
(mq/schema/ in the reference) with columnar-numpy batch mapping.

The port's copy of seaweedfs_tpu/mq/, with the reference's exports. No
module of it loads torch: the broker's device work is the filer's (its
segments live in volumes the card seals with K1, scrubs with K3 and reads
back degraded through K1's one-stripe reconstruct).
"""

from .broker import BrokerServer
from .consumer import ConsumerRecord, GroupConsumer, group_consume
from .schema import Schema, infer_record_type, record_type_begin
from .topic import Partition, TopicRef, partition_for_key, split_ring

__all__ = ["TopicRef", "Partition", "partition_for_key", "split_ring",
           "BrokerServer", "GroupConsumer", "ConsumerRecord",
           "group_consume", "Schema", "infer_record_type",
           "record_type_begin"]
