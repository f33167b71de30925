"""Remote storage of the port: the filer's remote mounts (reference
weed/remote_storage and filer read_remote.go / remote_mapping.go: graft an
external object store's listing into the filer namespace, read through on
demand, cache and uncache chunks explicitly), and the native Azure Blob
(SharedKey) and GCS JSON-API clients that `storage/backend.open_remote`
opens for the `azure:` and `gcs-json:` tiers.

The reference's package exports the five mount functions; the port's
exports the clients beside them. The replication sinks `azure.AzureSink`
and `gcs.GcsSink` live beside the clients and are built at their first
use, so opening a tier does not import the replication plane.
"""

from .azure import AzureBlobClient, parse_azure_spec, sign_shared_key
from .gcs import GcsClient, parse_gcs_spec
from .remote_mount import (cache_remote, mount_remote, read_remote,
                           uncache_remote, unmount_remote)

__all__ = ["mount_remote", "unmount_remote", "cache_remote",
           "uncache_remote", "read_remote",
           "sign_shared_key", "AzureBlobClient", "parse_azure_spec",
           "GcsClient", "parse_gcs_spec"]
