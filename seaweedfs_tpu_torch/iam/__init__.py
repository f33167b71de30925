"""AWS-IAM-compatible management API (reference weed/iamapi).

The port's copy of seaweedfs_tpu/iam/__init__.py; imports no torch."""

from .iam_server import IamApiServer

__all__ = ["IamApiServer"]
