"""FUSE mount subsystem (reference weed/mount, 5,330 LoC).

Architecture mirrors the reference: an inode<->path map
(inode_to_path.go), a local metadata cache kept fresh by the filer
metadata subscription (mount/meta_cache), a write-back page cache with
chunk-granular dirty pages and a concurrent upload pipeline
(page_writer.go, page_writer/upload_pipeline.go), and the filesystem
facade WeedFS (weedfs.go) exposing FUSE-shaped operations.

The kernel bridge is pluggable: `WeedFS` is a plain object whose methods
map 1:1 onto FUSE callbacks; `fuse_binding.fuse_loop` (ctypes over libfuse
2.9) serves it on a kernel mount, as the `mount` and `fuse` verbs do, and
`weedfs.mount()` adapts it through fusepy where that is installed. Tests
drive WeedFS directly — same split the reference uses between weedfs.go
(logic) and go-fuse (kernel glue).

The port's copy of seaweedfs_tpu/mount/: the same modules and exports.
The mount does no device work; under a file on an EC volume with shards
lost, a read goes through the volume servers' reconstructs (K1).
"""

from .inode_map import InodeToPath
from .page_writer import ChunkedDirtyPages, MemChunk, SwapFileChunk, UploadPipeline
from .meta_cache import MetaCache
from .weedfs import WeedFS

__all__ = ["InodeToPath", "ChunkedDirtyPages", "MemChunk", "SwapFileChunk",
           "UploadPipeline", "MetaCache", "WeedFS"]
