"""S3 gateway: AWS-compatible object API over the filer.

Reference layer L6 (weed/s3api, 14,018 LoC — SURVEY.md §2.6): sigv4 auth
(header + presigned), bucket/object CRUD, ListObjects V1/V2 with delimiter,
multi-delete, zero-copy multipart completion, object tagging.

The port's copy of seaweedfs_tpu/s3/__init__.py, with the same exports. The
gateway runs on the port's utils/fastweb and imports no torch."""

from .auth import (ACTION_ADMIN, ACTION_LIST, ACTION_READ, ACTION_TAGGING,
                   ACTION_WRITE, Identity, IdentityAccessManagement, S3Error,
                   sign_request_v4)
from .s3_server import S3Gateway

__all__ = [
    "ACTION_ADMIN", "ACTION_LIST", "ACTION_READ", "ACTION_TAGGING",
    "ACTION_WRITE", "Identity", "IdentityAccessManagement", "S3Error",
    "S3Gateway", "sign_request_v4",
]
