"""Storage backends: sealed volume data living off the local disk.

Port of seaweedfs_tpu/storage/backend.py. Reference:
weed/storage/backend/backend.go (BackendStorageFile over local disk / memory
map / S3 / rclone) + volume_tier.go (a sealed `.dat` moves to cloud storage;
the volume stays readable through ranged reads).

`RemoteStorageClient` is the transport seam. Built-ins:
- LocalDirRemote: a directory posing as a bucket (tests/dev — the role
  rclone's local backend plays in the reference).
- S3Remote: any sigv4 endpoint (AWS, minio, or an S3 gateway), ranged GET
  for reads — needs only HTTP. `requests` is imported inside its methods, so
  this module imports on a host that does not have it.

- `azure:` and `gcs-json:`: the native Blob REST (SharedKey) and GCS
  JSON-API clients of remote/, over client/http_util.

`RemoteDatFile` adapts a remote object to the seek/read file interface
Volume uses for its `.dat`, with an LRU block cache so point reads of
needles don't re-fetch whole ranges.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

from ..utils.log import logger

log = logger("storage.backend")

BLOCK_SIZE = 256 << 10  # ranged-read granularity (reference uses chunked reads)
CACHE_BLOCKS = 64       # 16 MB per tiered volume


class RemoteStorageClient:
    name = "abstract"

    def write_object(self, key: str, src_path: str) -> int:
        """Upload a local file; returns its size."""
        raise NotImplementedError

    def read_object(self, key: str, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def object_size(self, key: str) -> int:
        raise NotImplementedError

    def object_version(self, key: str) -> str:
        """A token that changes whenever the object's bytes change (an
        ETag, a generation, a file's mtime and inode); "" when the store
        gives none, and then no copy of the object is known to be fresh."""
        return ""

    def read_object_to(self, key: str, dst_path: str) -> None:
        size = self.object_size(key)
        with open(dst_path, "wb") as f:
            off = 0
            while off < size:
                n = min(BLOCK_SIZE * 16, size - off)
                chunk = self.read_object(key, off, n)
                if len(chunk) != n:
                    raise OSError(
                        f"short read of {key} at {off}: "
                        f"{len(chunk)} != {n}")
                f.write(chunk)
                off += n

    def delete_object(self, key: str) -> None:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def list_buckets(self) -> list[str]:
        """Top-level containers (shell remote.mount.buckets)."""
        raise NotImplementedError

    def write_object_bytes(self, key: str, data: bytes) -> int:
        """Upload from memory (filer.remote.sync write-back)."""
        import tempfile
        with tempfile.NamedTemporaryFile() as tf:
            tf.write(data)
            tf.flush()
            return self.write_object(key, tf.name)

    def create_bucket(self, bucket: str) -> None:
        raise NotImplementedError

    def delete_bucket(self, bucket: str) -> None:
        raise NotImplementedError


class LocalDirRemote(RemoteStorageClient):
    name = "local"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.root, key.lstrip("/"))

    def write_object(self, key: str, src_path: str) -> int:
        import shutil
        dst = self._p(key)
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        shutil.copyfile(src_path, dst)
        return os.path.getsize(dst)

    def read_object(self, key: str, offset: int, size: int) -> bytes:
        with open(self._p(key), "rb") as f:
            f.seek(offset)
            return f.read(size)

    def object_size(self, key: str) -> int:
        return os.path.getsize(self._p(key))

    def object_version(self, key: str) -> str:
        st = os.stat(self._p(key))
        return f"{st.st_mtime_ns}-{st.st_size}-{st.st_ino}"

    def delete_object(self, key: str) -> None:
        try:
            os.unlink(self._p(key))
        except FileNotFoundError:
            pass

    def list_buckets(self) -> list[str]:
        return sorted(d for d in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, d)))

    def create_bucket(self, bucket: str) -> None:
        os.makedirs(os.path.join(self.root, bucket), exist_ok=True)

    def delete_bucket(self, bucket: str) -> None:
        import shutil
        shutil.rmtree(os.path.join(self.root, bucket), ignore_errors=True)

    def list_keys(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix.lstrip("/")):
                    out.append(rel)
        return sorted(out)


class S3Remote(RemoteStorageClient):
    """Tier into any sigv4 S3 endpoint via ranged HTTP."""

    name = "s3"

    def __init__(self, endpoint: str, bucket: str,
                 access_key: str = "", secret_key: str = ""):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.ak, self.sk = access_key, secret_key

    def _signed(self, method: str, url: str, data: bytes = b"",
                headers: dict | None = None) -> dict:
        headers = dict(headers or {})
        if self.ak:
            from ..s3.auth import sign_request_v4
            headers = sign_request_v4(method, url, headers, data,
                                      self.ak, self.sk)
        return headers

    def _request(self, method: str, key: str, data: bytes = b"",
                 headers: dict | None = None):
        import requests

        url = f"{self.endpoint}/{self.bucket}/{key.lstrip('/')}"
        return requests.request(method, url, data=data or None,
                                headers=self._signed(method, url, data,
                                                     headers),
                                timeout=120)

    def write_object(self, key: str, src_path: str) -> int:
        with open(src_path, "rb") as f:
            data = f.read()
        r = self._request("PUT", key, data)
        if r.status_code >= 300:
            raise OSError(f"tier PUT {key}: HTTP {r.status_code}")
        return len(data)

    def read_object(self, key: str, offset: int, size: int) -> bytes:
        r = self._request("GET", key, headers={
            "Range": f"bytes={offset}-{offset + size - 1}"})
        if r.status_code >= 300:
            raise OSError(f"tier GET {key}: HTTP {r.status_code}")
        return r.content[:size]

    def object_size(self, key: str) -> int:
        r = self._request("HEAD", key)
        if r.status_code >= 300:
            raise OSError(f"tier HEAD {key}: HTTP {r.status_code}")
        return int(r.headers.get("Content-Length", 0))

    def object_version(self, key: str) -> str:
        r = self._request("HEAD", key)
        if r.status_code >= 300:
            raise OSError(f"tier HEAD {key}: HTTP {r.status_code}")
        return r.headers.get("ETag", "")

    def delete_object(self, key: str) -> None:
        self._request("DELETE", key)

    def list_keys(self, prefix: str = "") -> list[str]:
        import xml.etree.ElementTree as ET

        import requests

        url = f"{self.endpoint}/{self.bucket}?list-type=2&prefix=" + prefix
        r = requests.get(url, headers=self._signed("GET", url), timeout=60)
        if r.status_code >= 300:
            raise OSError(f"tier LIST: HTTP {r.status_code}")
        root = ET.fromstring(r.content)
        ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
        return [e.findtext(f"{ns}Key") for e in root.iter(f"{ns}Contents")]

    def create_bucket(self, bucket: str) -> None:
        import requests
        url = f"{self.endpoint}/{bucket}"
        r = requests.put(url, headers=self._signed("PUT", url), timeout=60)
        if r.status_code >= 300:
            raise OSError(f"CreateBucket {bucket}: HTTP {r.status_code}")

    def delete_bucket(self, bucket: str) -> None:
        import requests
        url = f"{self.endpoint}/{bucket}"
        r = requests.delete(url, headers=self._signed("DELETE", url),
                            timeout=60)
        # 404 = already gone (idempotent); anything else failing must
        # surface — e.g. 409 BucketNotEmpty, or the caller will drop its
        # mapping while the remote bucket lives on
        if r.status_code >= 300 and r.status_code != 404:
            raise OSError(f"DeleteBucket {bucket}: HTTP {r.status_code}")

    def list_buckets(self) -> list[str]:
        """GET service root = ListAllMyBuckets (works bucket-scoped or
        service-scoped: the endpoint is the service URL either way)."""
        import xml.etree.ElementTree as ET

        import requests

        url = f"{self.endpoint}/"
        r = requests.get(url, headers=self._signed("GET", url), timeout=60)
        if r.status_code >= 300:
            raise OSError(f"ListBuckets: HTTP {r.status_code}")
        root = ET.fromstring(r.content)
        ns = root.tag.split("}")[0] + "}" if root.tag.startswith("{") else ""
        return [b.findtext(f"{ns}Name") for b in root.iter(f"{ns}Bucket")]


def bucket_spec(remote: str, bucket: str) -> str:
    """Derive the per-bucket spec from a root remote spec (shared by
    shell remote.mount.buckets and the filer.remote.gateway verb)."""
    kind, _, arg = remote.partition(":")
    if kind == "local" or ":" not in remote:
        root = arg or remote
        return f"local:{root.rstrip('/')}/{bucket}"
    # s3-family: '<kind>:http://host:port[?ak:sk]' -> append /bucket
    url, q, cred = arg.partition("?")
    return f"{kind}:{url.rstrip('/')}/{bucket}" + (q + cred if q else "")


def open_remote(spec: str) -> RemoteStorageClient:
    """spec: 'local:/dir' or 's3:http://host:port/bucket[?ak:sk]'
    (reference configures backends via master.toml [storage.backend])."""
    kind, _, arg = spec.partition(":")
    if kind == "local":
        return LocalDirRemote(arg)
    if kind in ("s3", "b2", "gcs", "wasabi", "minio"):
        # b2/gcs/wasabi/minio all speak the S3 protocol (B2 S3-compatible
        # API, GCS XML API with HMAC keys) — one sigv4 client covers them,
        # the kind names keep specs self-documenting (reference ships
        # per-provider clients in weed/remote_storage/*)
        url, _, cred = arg.partition("?")
        scheme, sep, rest = url.partition("://")
        if sep:
            # 'http://host:port[/bucket]' — a bucket-less spec is valid
            # for service-level ops (remote.mount.buckets ListBuckets)
            host, _, bucket = rest.partition("/")
            base = f"{scheme}://{host}"
        else:
            base, _, bucket = url.rpartition("/")
        ak, _, sk = cred.partition(":")
        return S3Remote(base, bucket, ak, sk)
    if kind == "azure":
        # native Blob REST + SharedKey (not the s3-compat path):
        # 'azure:https://{acct}.blob.core.windows.net/container?acct:key'
        from ..remote.azure import parse_azure_spec
        return parse_azure_spec(arg)
    if kind == "gcs-json":
        # native GCS JSON API with a bearer token (HMAC users can keep
        # the s3-compat 'gcs:' spec above)
        from ..remote.gcs import parse_gcs_spec
        return parse_gcs_spec(arg)
    raise ValueError(f"unknown remote backend {spec!r}")


class RemoteDatFile:
    """Read-only file-like over a remote object (seek/read/tell), the
    interface Volume uses for its `.dat`. LRU block cache keeps the
    O(1)-disk-read promise at one remote ranged GET per cold block."""

    def __init__(self, client: RemoteStorageClient, key: str,
                 size: int | None = None):
        self.client = client
        self.key = key
        self.size = size if size is not None else client.object_size(key)
        self._pos = 0
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._lock = threading.Lock()
        self.closed = False

    # file protocol ---------------------------------------------------------
    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            pos += self.size
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos

    def _block(self, bi: int) -> bytes:
        with self._lock:
            blk = self._cache.get(bi)
            if blk is not None:
                self._cache.move_to_end(bi)
                return blk
        off = bi * BLOCK_SIZE
        n = min(BLOCK_SIZE, self.size - off)
        blk = self.client.read_object(self.key, off, n)
        with self._lock:
            self._cache[bi] = blk
            while len(self._cache) > CACHE_BLOCKS:
                self._cache.popitem(last=False)
        return blk

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self.size - self._pos
        n = max(0, min(n, self.size - self._pos))
        out = bytearray()
        pos = self._pos
        while len(out) < n:
            bi, at = divmod(pos, BLOCK_SIZE)
            blk = self._block(bi)
            take = min(n - len(out), len(blk) - at)
            if take <= 0:
                break
            out += blk[at:at + take]
            pos += take
        self._pos = pos
        return bytes(out)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.closed = True

    def write(self, data: bytes):
        raise OSError("tiered volume is read-only")

    truncate = write
