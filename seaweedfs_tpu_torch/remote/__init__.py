"""Remote object-store clients of the port: the native Azure Blob (SharedKey)
and GCS JSON-API clients that `storage/backend.open_remote` opens for the
`azure:` and `gcs-json:` tiers.

The JAX package's remote/ also holds the filer's remote mounts and the
replication sinks; they are ported with the filer.
"""

from .azure import AzureBlobClient, parse_azure_spec, sign_shared_key
from .gcs import GcsClient, parse_gcs_spec

__all__ = ["sign_shared_key", "AzureBlobClient", "parse_azure_spec",
           "GcsClient", "parse_gcs_spec"]
