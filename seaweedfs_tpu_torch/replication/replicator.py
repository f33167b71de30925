"""Event -> sink dispatch (reference replication/replicator.go:38).

An EventNotification decomposes into create / delete / rename / update;
the replicator routes each to the sink with the source's data reader.

The port's copy of seaweedfs_tpu/replication/replicator.py, unchanged.
"""

from __future__ import annotations

from ..filer.filer import join_path
from ..pb import filer_pb2 as fpb
from ..utils.log import logger
from .sink import DataReader, ReplicationSink

log = logger("replication")


class Replicator:
    def __init__(self, sink: ReplicationSink, read_data: DataReader,
                 path_prefix: str = "/"):
        self.sink = sink
        self.read_data = read_data
        self.prefix = path_prefix

    @staticmethod
    def _full_path(key: str, name: str) -> str:
        """`key` may be the parent directory (meta-log records) or the
        entry's full path (notification-queue keys, reference
        replicator.go) — normalize to the full path."""
        if key == "/" + name or key.endswith("/" + name):
            return key
        return join_path(key, name)

    def replicate(self, directory: str, ev: fpb.EventNotification) -> None:
        """Mirror replicator.go Replicate: old==nil -> create,
        new==nil -> delete, both with moved path -> rename,
        both same path -> update."""
        has_old = ev.HasField("old_entry") and bool(ev.old_entry.name)
        has_new = ev.HasField("new_entry") and bool(ev.new_entry.name)
        old_path = (self._full_path(directory, ev.old_entry.name)
                    if has_old else "")
        new_path = ""
        if has_new:
            if ev.new_parent_path:
                new_path = join_path(ev.new_parent_path, ev.new_entry.name)
            else:
                new_path = self._full_path(directory, ev.new_entry.name)
        in_scope = ((old_path and old_path.startswith(self.prefix))
                    or (new_path and new_path.startswith(self.prefix)))
        if not in_scope:
            return
        sigs = list(ev.signatures)
        if not has_old and has_new:
            try:
                self.sink.create_entry(new_path, ev.new_entry,
                                       self.read_data, sigs)
            except KeyError as e:
                # source data already gone (deleted after the event was
                # queued) — a later delete event will reconcile the sink
                log.warning("skip create %s: source data missing (%s)",
                            new_path, e)
        elif has_old and not has_new:
            self.sink.delete_entry(old_path, ev.old_entry.is_directory)
        elif has_old and has_new and old_path != new_path:
            self.sink.delete_entry(old_path, ev.old_entry.is_directory)
            self.sink.create_entry(new_path, ev.new_entry, self.read_data,
                                   sigs)
        elif has_old and has_new:
            self.sink.update_entry(new_path, ev.new_entry, self.read_data,
                                   sigs)
