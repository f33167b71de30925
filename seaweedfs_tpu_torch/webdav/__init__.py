"""WebDAV gateway over the filer (reference weed/server/webdav_server.go,
which adapts golang.org/x/net/webdav onto the filer API).

The port's copy of seaweedfs_tpu/webdav/__init__.py; the gateway runs on
the port's utils/fastweb (see webdav_server.py)."""

from .webdav_server import WebDavServer

__all__ = ["WebDavServer"]
