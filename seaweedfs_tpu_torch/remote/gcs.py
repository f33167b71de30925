"""Google Cloud Storage client over the native JSON API.

Reference: weed/remote_storage/gcs/gcs_storage_client.go and
weed/replication/sink/gcssink/gcs_sink.go use the GCS SDK; this speaks
the JSON API directly (upload: POST /upload/storage/v1/b/{bucket}/o,
data: GET /storage/v1/b/{bucket}/o/{object}?alt=media, list with
pageToken) authorized by a bearer token — offline it runs against
utils/mini_gcs.MiniGcs; on GCP, pass a token from the metadata server or
`gcloud auth print-access-token`. (HMAC-key users can keep using the
S3-compat path, storage/backend.py S3Remote.)

The port's copy of the client half of seaweedfs_tpu/remote/gcs.py:
`GcsClient` and `parse_gcs_spec`, which `storage/backend.py` opens for a
`gcs-json:` tier. The replication sink (`GcsSink`) is ported with the
filer and the replication package.
"""

from __future__ import annotations

import urllib.parse

from ..client import http_util
from ..storage.backend import RemoteStorageClient


class GcsClient(RemoteStorageClient):
    name = "gcs-json"

    def __init__(self, endpoint: str, bucket: str, token: str):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.token = token

    def _hdrs(self) -> dict:
        return {"Authorization": f"Bearer {self.token}"}

    def _obj_url(self, key: str) -> str:
        return (f"{self.endpoint}/storage/v1/b/{self.bucket}/o/"
                f"{urllib.parse.quote(key, safe='')}")

    def put_bytes(self, key: str, data: bytes) -> None:
        r = http_util.post(
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o",
            body=data,
            headers={**self._hdrs(),
                     "Content-Type": "application/octet-stream"},
            params={"uploadType": "media", "name": key})
        if r.status >= 300:
            raise OSError(f"gcs upload {key}: HTTP {r.status} "
                          f"{r.content[:200]!r}")

    def write_object(self, key: str, src_path: str) -> int:
        with open(src_path, "rb") as f:
            data = f.read()
        self.put_bytes(key, data)
        return len(data)

    def read_object(self, key: str, offset: int, size: int) -> bytes:
        r = http_util.get(
            self._obj_url(key), params={"alt": "media"},
            headers={**self._hdrs(),
                     "Range": f"bytes={offset}-{offset + size - 1}"})
        if r.status not in (200, 206):
            raise OSError(f"gcs GET {key}: HTTP {r.status}")
        return r.content

    def object_size(self, key: str) -> int:
        r = http_util.get(self._obj_url(key), headers=self._hdrs())
        if r.status >= 300:
            raise OSError(f"gcs stat {key}: HTTP {r.status}")
        return int(r.json().get("size", 0))

    def delete_object(self, key: str) -> None:
        r = http_util.request("DELETE", self._obj_url(key),
                              headers=self._hdrs())
        if r.status not in (204, 404):
            raise OSError(f"gcs DELETE {key}: HTTP {r.status}")

    def list_keys(self, prefix: str = "") -> "list[str]":
        keys: list[str] = []
        token = ""
        while True:
            params = {"prefix": prefix} if prefix else {}
            if token:
                params["pageToken"] = token
            r = http_util.get(
                f"{self.endpoint}/storage/v1/b/{self.bucket}/o",
                params=params or None, headers=self._hdrs())
            if r.status >= 300:
                raise OSError(f"gcs list: HTTP {r.status}")
            doc = r.json()
            keys.extend(item["name"] for item in doc.get("items", []))
            token = doc.get("nextPageToken", "")
            if not token:
                return keys


def parse_gcs_spec(arg: str) -> GcsClient:
    """'http://host:port/bucket?token' (real GCS:
    'https://storage.googleapis.com/bucket?<access-token>')."""
    url, _, token = arg.partition("?")
    scheme, sep, rest = url.partition("://")
    if not sep:
        raise ValueError(f"gcs-json spec needs an endpoint URL, got {arg!r}")
    host, _, bucket = rest.partition("/")
    if not (bucket and token):
        raise ValueError("gcs-json spec: endpoint/bucket?token required")
    return GcsClient(f"{scheme}://{host}", bucket, token)
