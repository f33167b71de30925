"""DiskLocation: one data directory holding volumes and EC shards.

Port of seaweedfs_tpu/storage/disk_location.py. Reference:
weed/storage/disk_location.go (+ disk_location_ec.go:75,136 for EC
scanning). Scans the directory at startup, loads .dat/.idx volumes,
tiered volumes (a .vif naming a remote .dat, no local .dat) and
.ecx/.ec?? shard sets.
"""

from __future__ import annotations

import os
import re
import threading

from ..ec import files as ec_files
from ..ec.volume import EcVolume
from ..utils.log import logger
from .types import DiskType
from .volume import Volume

log = logger("disk")

_DAT_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.dat$")
_ECX_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ecx$")
# tiered volumes keep only .vif+.idx locally (the .dat lives remotely)
_VIF_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.vif$")


class DiskLocation:
    def __init__(self, directory: str, disk_type: str = "hdd",
                 max_volume_count: int = 8, min_free_space_bytes: int = 0,
                 needle_map_kind: str = "memory"):
        self.directory = os.path.abspath(directory)
        self.needle_map_kind = needle_map_kind
        self.disk_type = DiskType.parse(disk_type).value
        self.max_volume_count = max_volume_count
        self.min_free_space_bytes = min_free_space_bytes
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        self.lock = threading.RLock()
        os.makedirs(self.directory, exist_ok=True)

    def load_existing(self) -> None:
        with self.lock:
            for name in sorted(os.listdir(self.directory)):
                m = _DAT_RE.match(name)
                if m:
                    vid = int(m.group("vid"))
                    col = m.group("col") or ""
                    if vid not in self.volumes:
                        try:
                            self.volumes[vid] = Volume(
                                self.directory, col, vid,
                                needle_map_kind=self.needle_map_kind,
                                create_if_missing=False)
                        except Exception as e:  # noqa: BLE001 — one bad volume must not stop the scan
                            log.error("load volume %s: %s", name, e)
                    continue
                m = _VIF_RE.match(name)
                if m:
                    vid = int(m.group("vid"))
                    col = m.group("col") or ""
                    dat = os.path.join(self.directory, name[:-4] + ".dat")
                    if (vid not in self.volumes and not os.path.exists(dat)
                            and "remote" in ec_files.read_vif(
                                os.path.join(self.directory, name))):
                        try:
                            self.volumes[vid] = Volume(
                                self.directory, col, vid,
                                needle_map_kind=self.needle_map_kind,
                                create_if_missing=False)
                        except Exception as e:  # noqa: BLE001 — one bad volume must not stop the scan
                            log.error("load tiered volume %s: %s", name, e)
                    continue
                m = _ECX_RE.match(name)
                if m:
                    vid = int(m.group("vid"))
                    col = m.group("col") or ""
                    if vid not in self.ec_volumes:
                        base = os.path.join(self.directory, name[:-4])
                        try:
                            ev = EcVolume(base, vid, collection=col)
                            if ev.shards:
                                self.ec_volumes[vid] = ev
                            else:
                                ev.close()
                        except Exception as e:  # noqa: BLE001 — one bad volume must not stop the scan
                            log.error("load ec volume %s: %s", name, e)

    def base_name(self, collection: str, vid: int) -> str:
        name = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(self.directory, name)

    def has_free_space(self) -> bool:
        if not self.min_free_space_bytes:
            return True
        st = os.statvfs(self.directory)
        return st.f_bavail * st.f_frsize > self.min_free_space_bytes

    def free_slots(self) -> int:
        with self.lock:
            return max(0, self.max_volume_count - len(self.volumes))
