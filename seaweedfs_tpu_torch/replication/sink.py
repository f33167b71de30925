"""Replication sinks (reference weed/replication/sink).

`ReplicationSink` mirrors sink/replication_sink.go: CreateEntry /
UpdateEntry / DeleteEntry against a destination, with the source's data
readable through a callback (the replicator resolves chunk bytes from
the source cluster — data moves with the metadata).

Built-ins: LocalSink (localsink — a plain directory tree, handy for
backup), FilerSink (filersink — another cluster's filer). The
reference's s3/gcs/azure/b2 sinks need their cloud SDKs; an S3 sink
against any sigv4 endpoint (including our own gateway) is provided since
it needs only HTTP.

The port's copy of seaweedfs_tpu/replication/sink.py. Its difference:
`S3Sink` sends its requests over the port's `client/http_util` (the
reference's uses `requests`, which the port does not need); it signs with
the port's `s3/auth.sign_request_v4` over the decoded key and sends the
percent-encoded one. Its failpoints (`replication.sink.create|update|
delete`) are the port's `utils/failpoints`. `FilerSink.delete_entry` deletes through the target's
`.filer.delete_entry(..., is_delete_data=True)`, so the target's needles
go with the entry.
"""

from __future__ import annotations

import os
from typing import Callable

from ..pb import filer_pb2 as fpb
from ..utils import failpoints
from ..utils.log import logger

log = logger("replication.sink")

DataReader = Callable[[fpb.Entry], bytes]


class ReplicationSink:
    name = "abstract"

    def create_entry(self, path: str, entry: fpb.Entry,
                     read_data: DataReader,
                     signatures: list[int] | None = None) -> None:
        raise NotImplementedError

    def update_entry(self, path: str, entry: fpb.Entry,
                     read_data: DataReader,
                     signatures: list[int] | None = None) -> None:
        self.delete_entry(path, entry.is_directory)
        self.create_entry(path, entry, read_data, signatures)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        raise NotImplementedError


class LocalSink(ReplicationSink):
    """Mirror into a local directory (reference sink/localsink)."""

    name = "local"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _local(self, path: str) -> str:
        return os.path.join(self.dir, path.lstrip("/"))

    def create_entry(self, path: str, entry: fpb.Entry,
                     read_data: DataReader,
                     signatures: list[int] | None = None) -> None:
        target = self._local(path)
        if entry.is_directory:
            os.makedirs(target, exist_ok=True)
            return
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "wb") as f:
            f.write(read_data(entry))

    def delete_entry(self, path: str, is_directory: bool) -> None:
        target = self._local(path)
        try:
            if is_directory:
                import shutil
                shutil.rmtree(target, ignore_errors=True)
            else:
                os.unlink(target)
        except FileNotFoundError:
            pass


class FilerSink(ReplicationSink):
    """Write into another cluster's filer (reference sink/filersink).
    Data is re-uploaded into the destination's blob cluster — chunk
    fids are cluster-local and can't be shared."""

    name = "filer"

    def __init__(self, target_filer_server, dir_prefix: str = ""):
        self.fs = target_filer_server
        self.prefix = dir_prefix.rstrip("/")

    def _path(self, path: str) -> str:
        return self.prefix + path if self.prefix else path

    def create_entry(self, path: str, entry: fpb.Entry,
                     read_data: DataReader,
                     signatures: list[int] | None = None) -> None:
        from ..filer.filer import split_path
        # failpoint: destination-cluster hiccup — the replicator's
        # per-event retry/dead-letter path is driven from here
        failpoints.check("replication.sink.create")
        target = self._path(path)
        if entry.is_directory:
            d, n = split_path(target)
            if self.fs.filer.find_entry(d, n) is None:
                e = fpb.Entry(name=n, is_directory=True)
                e.attributes.CopyFrom(entry.attributes)
                self.fs.filer.create_entry(d, e, signatures=signatures)
            return
        data = read_data(entry)
        # signatures ride the destination's event so a reverse sync
        # recognizes its own writes (filer_sync.go excludeSignatures)
        self.fs.write_file(target, data, mime=entry.attributes.mime,
                           signatures=signatures)

    def update_entry(self, path: str, entry: fpb.Entry,
                     read_data: DataReader,
                     signatures: list[int] | None = None) -> None:
        failpoints.check("replication.sink.update")
        # write_file overwrites in place; no need to delete first
        if entry.is_directory:
            return
        self.fs.write_file(self._path(path), read_data(entry),
                           mime=entry.attributes.mime,
                           signatures=signatures)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        from ..filer.filer import split_path
        failpoints.check("replication.sink.delete")
        d, n = split_path(self._path(path))
        try:
            self.fs.filer.delete_entry(d, n, is_recursive=is_directory,
                                       is_delete_data=True)
        except FileNotFoundError:
            pass


class S3Sink(ReplicationSink):
    """Replicate into any sigv4 S3 endpoint (reference sink/s3sink) —
    including our own gateway; needs only HTTP."""

    name = "s3"

    def __init__(self, endpoint: str, bucket: str, access_key: str,
                 secret_key: str, dir_prefix: str = ""):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.ak, self.sk = access_key, secret_key
        self.prefix = dir_prefix.strip("/")

    def _key(self, path: str) -> str:
        key = path.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def _request(self, method: str, key: str, data: bytes = b""):
        import urllib.parse

        from ..client import http_util
        from ..s3.auth import sign_request_v4
        url = f"{self.endpoint}/{self.bucket}/{key}"
        headers = sign_request_v4(method, url, {}, data, self.ak, self.sk)
        wire = (f"{self.endpoint}/{urllib.parse.quote(self.bucket)}/"
                f"{urllib.parse.quote(key)}")
        return http_util.request(method, wire, body=data, headers=headers,
                                 timeout=60, max_attempts=1)

    def create_entry(self, path: str, entry: fpb.Entry,
                     read_data: DataReader,
                     signatures: list[int] | None = None) -> None:
        if entry.is_directory:
            return
        r = self._request("PUT", self._key(path), read_data(entry))
        if r.status >= 300:
            raise OSError(f"s3 sink PUT {path}: HTTP {r.status}")

    def update_entry(self, path: str, entry: fpb.Entry,
                     read_data: DataReader,
                     signatures: list[int] | None = None) -> None:
        self.create_entry(path, entry, read_data, signatures)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        if is_directory:
            return
        self._request("DELETE", self._key(path))
