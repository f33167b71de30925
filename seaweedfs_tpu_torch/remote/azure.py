"""Azure Blob Storage client, REST + SharedKey.

Reference: weed/remote_storage/azure/azure_storage_client.go and
weed/replication/sink/azuresink/azure_sink.go use the Azure SDK; this
speaks the Blob service REST API directly (x-ms-version 2020-10-02) with
SharedKey request signing — no SDK, so it works in this image and against
utils/mini_azure.MiniAzure offline; point it at
https://{account}.blob.core.windows.net and the same bytes flow to real
Azure.

The port's copy of the client half of seaweedfs_tpu/remote/azure.py: the
signer, `AzureBlobClient` and `parse_azure_spec`, which `storage/backend.py`
opens for an `azure:` tier. The replication sink (`AzureSink`) needs the
filer's protobufs and the replication package and is ported with them.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import formatdate

from ..client import http_util
from ..storage.backend import RemoteStorageClient


X_MS_VERSION = "2020-10-02"


def sign_shared_key(method: str, account: str, key_b64: str, path: str,
                    query: "dict[str, str]", headers: "dict[str, str]",
                    content_length: int) -> str:
    """Authorization header value for the SharedKey scheme
    (learn.microsoft.com 'Authorize with Shared Key', implemented from the
    spec: VERB + standard headers + canonicalized x-ms headers+resource)."""
    canon_headers = "".join(
        f"{k.lower()}:{v}\n" for k, v in sorted(headers.items())
        if k.lower().startswith("x-ms-"))
    canon_resource = f"/{account}{path}"
    for k in sorted(query):
        canon_resource += f"\n{k.lower()}:{query[k]}"
    string_to_sign = "\n".join([
        method,
        headers.get("Content-Encoding", ""),
        headers.get("Content-Language", ""),
        str(content_length) if content_length else "",
        headers.get("Content-MD5", ""),
        headers.get("Content-Type", ""),
        "",  # Date: empty, x-ms-date is authoritative
        headers.get("If-Modified-Since", ""),
        headers.get("If-Match", ""),
        headers.get("If-None-Match", ""),
        headers.get("If-Unmodified-Since", ""),
        headers.get("Range", ""),
    ]) + "\n" + canon_headers + canon_resource
    mac = hmac.new(base64.b64decode(key_b64), string_to_sign.encode("utf-8"),
                   hashlib.sha256)
    return f"SharedKey {account}:{base64.b64encode(mac.digest()).decode()}"


class AzureBlobClient(RemoteStorageClient):
    name = "azure"

    def __init__(self, endpoint: str, account: str, key_b64: str,
                 container: str):
        self.endpoint = endpoint.rstrip("/")
        self.account = account
        self.key_b64 = key_b64
        self.container = container

    # -- signed round trip --------------------------------------------------
    def _request(self, method: str, blob: str = "",
                 query: "dict[str, str] | None" = None, body: bytes = b"",
                 extra_headers: "dict[str, str] | None" = None
                 ) -> http_util.Response:
        query = query or {}
        # sign the PERCENT-ENCODED path — Azure canonicalizes from the
        # request URI, so a raw-name signature 403s on keys needing
        # encoding (spaces, non-ASCII)
        qblob = urllib.parse.quote(blob) if blob else ""
        path = f"/{self.container}" + (f"/{qblob}" if blob else "")
        headers = {
            "x-ms-date": formatdate(usegmt=True),
            "x-ms-version": X_MS_VERSION,
        }
        if extra_headers:
            headers.update(extra_headers)
        headers["Authorization"] = sign_shared_key(
            method, self.account, self.key_b64, path,
            query, headers, len(body))
        # Content-Length itself is added by http_util for PUT/POST
        url = self.endpoint + path
        return http_util.request(method, url, body=body or None,
                                 headers=headers, params=query, timeout=60)

    def ensure_container(self) -> None:
        r = self._request("PUT", query={"restype": "container"})
        if r.status not in (201, 409):  # 409 = already exists
            raise OSError(f"azure create container: HTTP {r.status} "
                          f"{r.content[:200]!r}")

    def put_bytes(self, key: str, data: bytes) -> None:
        r = self._request("PUT", key, body=data,
                          extra_headers={"x-ms-blob-type": "BlockBlob"})
        if r.status >= 300:
            raise OSError(f"azure PUT {key}: HTTP {r.status} "
                          f"{r.content[:200]!r}")

    # -- RemoteStorageClient surface ----------------------------------------
    def write_object(self, key: str, src_path: str) -> int:
        with open(src_path, "rb") as f:
            data = f.read()
        self.put_bytes(key, data)
        return len(data)

    def read_object(self, key: str, offset: int, size: int) -> bytes:
        r = self._request(
            "GET", key,
            extra_headers={"Range": f"bytes={offset}-{offset + size - 1}"})
        if r.status not in (200, 206):
            raise OSError(f"azure GET {key}: HTTP {r.status}")
        return r.content

    def object_size(self, key: str) -> int:
        r = self._request("HEAD", key)
        if r.status >= 300:
            raise OSError(f"azure HEAD {key}: HTTP {r.status}")
        return int(r.headers.get("Content-Length", "0"))

    def delete_object(self, key: str) -> None:
        r = self._request("DELETE", key)
        if r.status not in (202, 404):
            raise OSError(f"azure DELETE {key}: HTTP {r.status}")

    def list_keys(self, prefix: str = "") -> "list[str]":
        keys: list[str] = []
        marker = ""
        while True:
            q = {"restype": "container", "comp": "list"}
            if prefix:
                q["prefix"] = prefix
            if marker:
                q["marker"] = marker
            r = self._request("GET", query=q)
            if r.status >= 300:
                raise OSError(f"azure list: HTTP {r.status}")
            root = ET.fromstring(r.content)
            for name in root.iter("Name"):
                keys.append(name.text or "")
            marker = (root.findtext("NextMarker") or "").strip()
            if not marker:
                return keys


def parse_azure_spec(arg: str) -> AzureBlobClient:
    """'http://host:port/container?account:base64key' (real Azure:
    'https://{account}.blob.core.windows.net/container?account:key')."""
    url, _, cred = arg.partition("?")
    scheme, sep, rest = url.partition("://")
    if not sep:
        raise ValueError(f"azure spec needs an endpoint URL, got {arg!r}")
    host, _, container = rest.partition("/")
    account, _, key = cred.partition(":")
    if not (container and account and key):
        raise ValueError(
            "azure spec: endpoint/container?account:base64key required")
    return AzureBlobClient(f"{scheme}://{host}", account, key, container)
