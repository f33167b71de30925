"""Inode <-> path bi-map (reference weed/mount/inode_to_path.go).

FUSE speaks inodes; the filer speaks paths. Inodes are allocated
deterministically from the path hash with linear probing on collision
(the reference hashes path+mode, inode_to_path.go AllocateInode), stay
stable across lookups, and are released on Forget.

The port's copy of seaweedfs_tpu/mount/inode_map.py, unchanged: the same
inode for the same path in both packages.
"""

from __future__ import annotations

import threading
import zlib

ROOT_INODE = 1


class InodeToPath:
    def __init__(self, root: str = "/"):
        self._lock = threading.Lock()
        self._path_to_inode: dict[str, int] = {root: ROOT_INODE}
        self._inode_to_path: dict[int, str] = {ROOT_INODE: root}
        self._refs: dict[int, int] = {ROOT_INODE: 1}

    def lookup(self, path: str) -> int:
        """Get-or-allocate the inode for a path; bumps the kernel ref."""
        with self._lock:
            ino = self._path_to_inode.get(path)
            if ino is None:
                ino = self._allocate(path)
            self._refs[ino] = self._refs.get(ino, 0) + 1
            return ino

    def _allocate(self, path: str) -> int:
        ino = (zlib.crc32(path.encode()) << 1) | 1
        while ino in self._inode_to_path:
            ino += 2  # linear probe, keep odd (root is 1, even left free)
        if ino == ROOT_INODE:
            ino += 2
        self._path_to_inode[path] = ino
        self._inode_to_path[ino] = path
        return ino

    def get_path(self, inode: int) -> str:
        with self._lock:
            p = self._inode_to_path.get(inode)
            if p is None:
                raise KeyError(f"unknown inode {inode}")
            return p

    def has_path(self, path: str) -> bool:
        with self._lock:
            return path in self._path_to_inode

    def get_inode(self, path: str) -> int | None:
        with self._lock:
            return self._path_to_inode.get(path)

    def move_path(self, old: str, new: str) -> None:
        """Rename keeps the inode (inode_to_path.go MovePath)."""
        with self._lock:
            ino = self._path_to_inode.pop(old, None)
            if ino is None:
                return
            stale = self._path_to_inode.pop(new, None)
            if stale is not None:
                self._inode_to_path.pop(stale, None)
                self._refs.pop(stale, None)
            self._path_to_inode[new] = ino
            self._inode_to_path[ino] = new

    def remove_path(self, path: str) -> None:
        with self._lock:
            ino = self._path_to_inode.pop(path, None)
            if ino is not None:
                self._inode_to_path.pop(ino, None)
                self._refs.pop(ino, None)

    def forget(self, inode: int, nlookup: int = 1) -> None:
        """Kernel dropped refs; free the mapping at zero
        (inode_to_path.go Forget)."""
        with self._lock:
            if inode == ROOT_INODE:
                return
            n = self._refs.get(inode, 0) - nlookup
            if n > 0:
                self._refs[inode] = n
                return
            self._refs.pop(inode, None)
            p = self._inode_to_path.pop(inode, None)
            if p is not None:
                self._path_to_inode.pop(p, None)
