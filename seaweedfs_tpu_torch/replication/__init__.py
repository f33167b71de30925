"""Async replication plane (reference weed/replication).

Event consumers replay filer mutations into pluggable sinks
(replicator.go:38 Replicate; sink/* implementations), and filer.sync
streams metadata directly between two filers with signature-based loop
prevention (command/filer_sync.go).

The port's copy of seaweedfs_tpu/replication/__init__.py; `S3Sink` is
exported too. The plane does no device work and imports no torch.
"""

from .replicator import Replicator
from .sink import FilerSink, LocalSink, ReplicationSink, S3Sink
from .filer_sync import FilerSync

__all__ = ["Replicator", "ReplicationSink", "LocalSink", "FilerSink",
           "S3Sink", "FilerSync"]
