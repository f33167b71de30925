"""Store: the per-server aggregate over disk locations.

Port of seaweedfs_tpu/storage/store.py. Reference: weed/storage/store.go:83
(NewStore), :259 (CollectHeartbeat), :436/:460 (write/read dispatch),
store_ec.go (EC mount/read), :389 (deleteExpiredEcVolumes, fork).

Coder selection has no fallback: `coder_name="torch"` (the default) is
TorchCoder on `device` (default "cuda", kernel K1), `"native"` the AVX2
host coder (ops/native.py), `"numpy"` the host oracle, and any other name
or a coder that fails to build raises. The
layered codecs (`ec_codec` or a volume's sealed codec "piggyback" or "msr")
wrap that same backend on that same device.

The lifecycle tiers: `offload_ec_shards` moves this holder's shard payloads
to a remote tier (storage/backend.py) and keeps serving them through ranged
reads, `promote_ec_shards` pulls them back, `move_volume_local` moves a
volume to another disk type of this server, and the DestroyTime reap knows
both EC tiers.
"""

from __future__ import annotations

import os
import time

from ..ec import files as ec_files
from ..ec.encoder import decode_volume, encode_volume, rebuild_shards
from ..ec.locate import EcGeometry
from ..ec.volume import EcVolume, RemoteEcVolumeShard
from ..ops.coder import ErasureCoder, codec_coder
from ..utils import failpoints, fsutil
from ..utils.log import logger
from . import types as t
from .disk_location import DiskLocation
from .needle import Needle
from .volume import Volume, VolumeClosedError

log = logger("store")

# the lifecycle tiers an EC volume's reap names (the JAX package's
# lifecycle.TIER_EC, TIER_REMOTE and TIER_TRASH)
TIER_EC = "ec"          # erasure-coded, local shards
TIER_REMOTE = "remote"  # erasure-coded, shard payload in a remote tier
TIER_TRASH = "trash"    # soft-deleted (DestroyTime reap), restorable

_CODERS = ("torch", "numpy", "native")


class Store:
    def __init__(self, ip: str, port: int, public_url: str,
                 locations: list[DiskLocation],
                 ec_geometry: EcGeometry | None = None,
                 coder_name: str = "torch", ec_codec: str = "rs",
                 device: str = "cuda"):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.locations = locations
        self.ec_geometry = ec_geometry or EcGeometry()
        self.coder_name = coder_name
        self.device = device
        # erasure CODEC for new encodes, orthogonal to coder_name (the
        # compute backend). Reads and rebuilds follow the codec sealed in
        # each volume's .vif.
        self.ec_codec = ec_codec or "rs"
        self.coder()  # refuse a bad name, codec or device before serving
        # lifecycle heat: vid -> [reads_total, last_read_monotonic]; plain
        # dict ops are GIL-atomic and a lost increment under contention
        # only shades a heat score, so no lock on the read hot path
        self._access: dict[int, list] = {}
        for loc in locations:
            loc.load_existing()

    # -- lifecycle access stats ---------------------------------------------
    def note_read(self, vid: int, n: int = 1) -> None:
        """Record needle reads against a volume resolved locally (removal
        paths prune the entry, so the dict stays bounded by the volumes
        this server served)."""
        ent = self._access.get(vid)
        if ent is None:
            ent = self._access[vid] = [0, 0.0]
        ent[0] += n
        ent[1] = time.monotonic()

    def _drop_access(self, vid: int) -> None:
        self._access.pop(vid, None)

    def access_snapshot(self) -> dict:
        """vid -> {"reads": total, "last_read_age_s": seconds}."""
        now = time.monotonic()
        return {vid: {"reads": ent[0],
                      "last_read_age_s": round(now - ent[1], 3)}
                for vid, ent in list(self._access.items())}

    # -- coder selection ----------------------------------------------------
    def coder(self, d: int | None = None, p: int | None = None,
              codec: str | None = None) -> ErasureCoder:
        d = d or self.ec_geometry.d
        p = p or self.ec_geometry.p
        if self.coder_name not in _CODERS:
            raise ValueError(f"unknown coder {self.coder_name!r}; have "
                             f"{sorted(_CODERS)} (no automatic choice)")
        # plain RS is the backend coder itself; a layered codec wraps it
        # as its inner coder, on this Store's device either way
        return codec_coder(codec or self.ec_codec, d, p,
                           backend=self.coder_name, device=self.device)

    # -- volume lifecycle ---------------------------------------------------
    def find_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def unmount_volume(self, vid: int) -> bool:
        """Close a volume and drop it from serving; files stay on disk
        (reference volume_grpc_admin.go VolumeUnmount)."""
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                with loc.lock:
                    loc.volumes.pop(vid, None)
                v.close()
                self._drop_access(vid)
                return True
        return False

    def mount_volume(self, vid: int, collection: str = "") -> Volume:
        """(Re)open an on-disk volume into serving (VolumeMount)."""
        v = self.find_volume(vid)
        if v is not None:
            return v
        for loc in self.locations:
            base = Volume.path_for(loc.directory, collection, vid)
            if os.path.exists(base + ".dat"):
                v = Volume(loc.directory, collection, vid,
                           create_if_missing=False)
                with loc.lock:
                    loc.volumes[vid] = v
                return v
        raise KeyError(f"volume {vid} not found on disk")

    def reload_volume(self, vid: int) -> Volume | None:
        """Re-open a volume whose backing changed (a tier upload or download
        swaps the .dat between local disk and a remote backend)."""
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                try:
                    v.close()
                except OSError as e:
                    log.debug("stale volume handle close failed: %s", e)
                nv = Volume(loc.directory, v.collection, vid,
                            create_if_missing=False)
                loc.volumes[vid] = nv
                return nv
        return None

    def find_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is not None:
                return ev
        return None

    def _location_for(self, disk_type: str | None = None) -> DiskLocation:
        cands = [l for l in self.locations
                 if (disk_type is None or l.disk_type == disk_type)
                 and l.free_slots() > 0 and l.has_free_space()]
        if not cands:
            raise OSError(f"no free slots for disk type {disk_type}")
        return max(cands, key=lambda l: l.free_slots())

    def add_volume(self, vid: int, collection: str = "",
                   replication: str = "000", ttl: str = "",
                   disk_type: str | None = None) -> Volume:
        if self.find_volume(vid) is not None:
            raise FileExistsError(f"volume {vid} exists")
        loc = self._location_for(disk_type)
        v = Volume(loc.directory, collection, vid,
                   needle_map_kind=loc.needle_map_kind,
                   replica_placement=t.ReplicaPlacement.parse(replication),
                   ttl=t.TTL.parse(ttl))
        with loc.lock:
            loc.volumes[vid] = v
        log.info("allocated volume %d (col=%r) at %s", vid, collection, loc.directory)
        return v

    def delete_volume(self, vid: int, only_empty: bool = False) -> None:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is None:
                continue
            if only_empty and v.file_count > 0:
                raise OSError(f"volume {vid} not empty")
            with loc.lock:
                loc.volumes.pop(vid, None)
            v.destroy()
            if self.find_ec_volume(vid) is None:
                self._drop_access(vid)  # ec conversion keeps the heat
            return
        raise KeyError(f"volume {vid} not found")

    def mark_readonly(self, vid: int, read_only: bool = True) -> None:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        v.read_only = read_only

    # -- data path ----------------------------------------------------------
    def write_needle(self, vid: int, n: Needle, sync: bool = False) -> int:
        failpoints.check("store.write")
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        return v.write_needle(n, sync=sync)

    def write_needles_bulk(self, vid: int, needles: "list[Needle]",
                           ) -> "list[int]":
        """Bulk-PUT storage path: one lock, one .dat write, one batched
        needle-map update, one fsync for the whole frame."""
        failpoints.check("volume.bulk.write")
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        return v.write_needles(needles)

    def read_needle(self, vid: int, needle_id: int, cookie: int | None = None,
                    shard_reader=None) -> Needle:
        failpoints.check("store.read")
        for v in self._read_volumes(vid):
            self.note_read(vid)
            try:
                return v.read_needle(needle_id, cookie=cookie)
            except VolumeClosedError:
                continue  # retry through the refreshed mapping
        ev = self.find_ec_volume(vid)
        if ev is not None:
            self.note_read(vid)
            return ev.read_needle(needle_id, cookie=cookie,
                                  shard_reader=shard_reader)
        raise KeyError(f"volume {vid} not found")

    def read_needles_bulk(self, vid: int, pairs: "list[tuple[int, int]]",
                          shard_reader=None,
                          byte_budget: "int | None" = None):
        """Bulk-GET storage path: resolve + read a whole (key, cookie)
        batch. EC volumes answer per needle (each read may take the
        degraded reconstruct path). `byte_budget` bounds materialized
        payload bytes; past it, found needles report READ_OVERFLOW unread.
        Returns [(status, Needle | None)]."""
        failpoints.check("store.read")
        from .bulk import (READ_ERROR, READ_NOT_FOUND, READ_OK,
                           READ_OVERFLOW)
        for v in self._read_volumes(vid):
            self.note_read(vid, n=len(pairs))
            try:
                return v.read_needles(pairs, byte_budget=byte_budget)
            except VolumeClosedError:
                continue
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise KeyError(f"volume {vid} not found")
        self.note_read(vid, n=len(pairs))
        out = []
        used = 0
        for key, cookie in pairs:
            if byte_budget is not None and used >= byte_budget:
                out.append((READ_OVERFLOW, None))
                continue
            try:
                n = ev.read_needle(key, cookie=cookie,
                                   shard_reader=shard_reader)
                used += len(n.data)
                out.append((READ_OK, n))
            except KeyError:
                out.append((READ_NOT_FOUND, None))
            except Exception as e:  # noqa: BLE001 — per-needle status
                log.debug("bulk ec read %d/%x: %s", vid, key, e)
                out.append((READ_ERROR, None))
        return out

    def _read_volumes(self, vid: int):
        """Volume objects to try for a read: the current mapping, then, if
        a lock-free read lost the race against a remount swap
        (VolumeClosedError), the refreshed mapping until the swap window
        (1 s) passes."""
        deadline = time.monotonic() + 1.0
        last = None
        while True:
            if time.monotonic() > deadline:
                raise VolumeClosedError(
                    f"volume {vid} kept closing under reads")
            v = self.find_volume(vid)
            if v is None:
                return
            if v is not last:
                last = v
                yield v
                continue  # consumer failed on a fresh object: re-check now
            time.sleep(0.01)  # swap in flight: the new mapping lands soon

    def delete_needle(self, vid: int, needle_id: int) -> bool:
        failpoints.check("store.delete")
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        return v.delete_needle(needle_id)

    # -- EC operations (reference volume_grpc_erasure_coding.go) -----------
    def _geometry(self, d: int | None, p: int | None) -> EcGeometry:
        return EcGeometry(d or self.ec_geometry.d, p or self.ec_geometry.p,
                          self.ec_geometry.large_block,
                          self.ec_geometry.small_block)

    def generate_ec_shards(self, vid: int, collection: str = "",
                           d: int | None = None, p: int | None = None,
                           stats: "dict | None" = None,
                           codec: str | None = None) -> str:
        v = self.find_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        geo = self._geometry(d, p)
        v.sync()
        base = v.file_name()
        encode_volume(base + ".dat", base, geo,
                      self.coder(geo.d, geo.p, codec=codec),
                      idx_path=base + ".idx", stats=stats)
        return base

    def generate_ec_shards_batch(self, vids: "list[int]", collection: str = "",
                                 d: int | None = None, p: int | None = None,
                                 stats: "dict | None" = None,
                                 codec: str | None = None,
                                 ) -> "list[int]":
        """Encode many local volumes through one shared device stream
        (ec/stream.py). Returns the vids encoded; a vid no longer here is
        skipped."""
        from ..ec import stream
        geo = self._geometry(d, p)
        jobs, done = [], []
        for vid in vids:
            v = self.find_volume(vid)
            if v is None:
                continue
            v.sync()
            base = v.file_name()
            jobs.append((base + ".dat", base, base + ".idx"))
            done.append(vid)
        if jobs:
            stream.encode_volumes(jobs, geo,
                                  self.coder(geo.d, geo.p, codec=codec),
                                  stats=stats)
        return done

    def mount_ec_shards(self, vid: int, collection: str = "") -> EcVolume:
        for loc in self.locations:
            old = loc.ec_volumes.get(vid)
            if old is not None:  # remount: rescan shard files on disk
                old.close()
                ev = EcVolume(old.base, vid, collection, old.geo)
                with loc.lock:
                    loc.ec_volumes[vid] = ev
                return ev
        for loc in self.locations:
            base = loc.base_name(collection, vid)
            if os.path.exists(base + ".ecx") or any(
                    os.path.exists(base + ec_files.shard_ext(i))
                    for i in range(32)):
                ev = EcVolume(base, vid, collection)
                with loc.lock:
                    loc.ec_volumes[vid] = ev
                return ev
        raise KeyError(f"no ec shards for volume {vid}")

    def unmount_ec_shards(self, vid: int, shard_ids: list[int] | None = None) -> None:
        for loc in self.locations:
            ev = loc.ec_volumes.get(vid)
            if ev is None:
                continue
            if shard_ids is not None:
                for sid in shard_ids:
                    sh = ev.shards.pop(sid, None)
                    if sh:
                        sh.close()
            if shard_ids is None or not ev.shards:
                with loc.lock:
                    loc.ec_volumes.pop(vid, None)
                ev.close()
                self._drop_access(vid)
            return

    def rebuild_ec_shards(self, vid: int, collection: str = "",
                          shard_reader=None,
                          remote_shards: "list[int] | None" = None,
                          stats: "dict | None" = None,
                          wanted: "list[int] | None" = None,
                          fragment_reader=None,
                          fold_planner=None) -> list[int]:
        """Rebuild missing shards locally (all not held here or listed in
        `remote_shards`, or just `wanted`), decoding with the codec the
        .vif seal names. Survivors not on this disk are read by range
        through `shard_reader`, which serves the ids in `remote_shards`,
        or as packed fragments through `fragment_reader`; `fold_planner`
        lets far survivors fold behind a relay (ec/encoder.py contract)."""
        ev = self.find_ec_volume(vid)
        base = ev.base if ev else None
        if base is None:
            for loc in self.locations:
                cand = loc.base_name(collection, vid)
                if os.path.exists(cand + ".ecx"):
                    base = cand
                    break
        if base is None:
            raise KeyError(f"no ec files for volume {vid}")
        info = ec_files.read_vif(base + ".vif")
        geo = EcGeometry.from_vif(info, self.ec_geometry)
        if ev:
            ev.close()
        coder = self.coder(geo.d, geo.p, codec=info.get("codec", "rs"))
        rebuilt = rebuild_shards(base, geo, coder, wanted=wanted,
                                 shard_reader=shard_reader,
                                 remote_shards=remote_shards, stats=stats,
                                 fragment_reader=fragment_reader,
                                 fold_planner=fold_planner)
        if ev:
            for loc in self.locations:
                if loc.ec_volumes.get(vid) is ev:
                    loc.ec_volumes[vid] = EcVolume(base, vid, collection, geo)
        return rebuilt

    def ec_shards_to_volume(self, vid: int, collection: str = "") -> Volume:
        """Decode EC shards back into a normal volume (ShardsToVolume RPC)."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise KeyError(f"no ec volume {vid}")
        base = ev.base
        geo = ev.geo
        coder = self.coder(geo.d, geo.p, codec=ev.codec)
        decode_volume(base, base + ".dat", geo, coder)
        if os.path.exists(base + ".ecx"):
            ec_files.write_idx_from_ecx(base + ".ecx", base + ".ecj", base + ".idx")
        else:
            # no index sidecar survived: rebuild the .idx by scanning the
            # .dat (reference `weed fix`, command/fix.go:74), then replay
            # the delete journal so journal-only deletes stay deleted
            from .needle_map import _ENTRY
            from .volume import rebuild_idx_from_dat
            rebuild_idx_from_dat(base + ".dat", base + ".idx")
            journaled = ec_files.read_ecj(base + ".ecj")
            if journaled:
                with open(base + ".idx", "ab") as f:
                    for nid in journaled:
                        f.write(_ENTRY.pack(nid, 0, t.TOMBSTONE_SIZE))
        self.unmount_ec_shards(vid)
        for loc in self.locations:
            if os.path.dirname(base) == loc.directory:
                v = Volume(loc.directory, collection, vid, create_if_missing=False)
                with loc.lock:
                    loc.volumes[vid] = v
                return v
        raise RuntimeError("location vanished")

    # -- lifecycle tiering (EC->remote offload, remote->local promote) --------
    def offload_ec_shards(self, vid: int, spec: str, collection: str = ""
                          ) -> int:
        """Move this holder's local shard payloads of an EC volume to a
        remote tier. The .ecx/.ecj/.vif sidecars stay local (lookup is
        local, payload is remote), the .vif records the remote mapping,
        and the volume keeps serving through lazy ranged reads. Returns
        bytes offloaded (0: nothing local to move; idempotent)."""
        from .backend import open_remote
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise KeyError(f"no ec volume {vid}")
        remote = dict(ev.remote_spec or {"spec": spec, "keys": {},
                                         "sizes": {}})
        if remote["spec"] != spec:
            # one remote tier per volume: mixing specs would strand the
            # earlier objects when the .vif only records one client
            raise ValueError(
                f"ec volume {vid} already offloaded to "
                f"{remote['spec']!r}; refusing {spec!r}")
        local = [(sid, sh) for sid, sh in sorted(ev.shards.items())
                 if not isinstance(sh, RemoteEcVolumeShard)]
        if not local:
            return 0
        client = open_remote(spec)
        prefix = f"{collection or ev.collection or 'default'}"
        moved = 0
        uploaded: list[tuple[int, str, int]] = []
        try:
            for sid, sh in local:
                key = f"{prefix}/{vid}{ec_files.shard_ext(sid)}"
                size = client.write_object(key, sh.path)
                uploaded.append((sid, key, size))
                moved += size
        except Exception:
            # roll back: local files are untouched, so the volume is still
            # whole; only the objects already uploaded would be orphaned
            for _sid, key, _size in uploaded:
                try:
                    client.delete_object(key)
                except Exception as e:  # noqa: BLE001 — the upload's error is raised below
                    log.warning("offload rollback of %s: %s", key, e)
            raise
        keys = dict(remote.get("keys", {}))
        sizes = dict(remote.get("sizes", {}))
        for sid, key, size in uploaded:
            keys[str(sid)] = key
            sizes[str(sid)] = size
        remote.update(keys=keys, sizes=sizes)
        # seal the mapping BEFORE deleting local payloads: a crash in between
        # leaves both copies (served local, cleaned on the next pass), never
        # neither. Locked update: the idle-close stamp on another thread
        # must not lose this seal.
        ec_files.update_vif(ev.base + ".vif", {"remote_shards": remote})
        # unlink the local payloads, then swap in a fresh EcVolume that
        # scans remote read-through. The old object is not closed: reads in
        # flight on it finish on its open fds (posix unlink semantics), so
        # each fd is pinned open first (an idle-closed shard would otherwise
        # reopen its unlinked path); the fds go when the object is collected
        for _sid, sh in local:
            sh.pin()
            os.remove(sh.path)
        for loc in self.locations:
            if loc.ec_volumes.get(vid) is ev:
                nev = EcVolume(ev.base, vid, ev.collection, ev.geo)
                with loc.lock:
                    loc.ec_volumes[vid] = nev
        return moved

    def promote_ec_shards(self, vid: int, collection: str = "",
                          keep_remote: bool = False) -> int:
        """Pull this holder's offloaded shard payloads back to local disk
        (promote-on-heat). Downloads land beside the sidecars under a temp
        name and swap in atomically: a torn download never costs the
        remote copy. Returns bytes promoted."""
        from .backend import open_remote
        ev = self.find_ec_volume(vid)
        if ev is None:
            raise KeyError(f"no ec volume {vid}")
        if not ev.remote_spec:
            return 0
        client = open_remote(ev.remote_spec["spec"])
        remote_shards = [(sid, sh) for sid, sh in sorted(ev.shards.items())
                         if isinstance(sh, RemoteEcVolumeShard)]
        moved = 0
        landed: list[tuple[int, str]] = []
        try:
            for sid, sh in remote_shards:
                path = ev.base + ec_files.shard_ext(sid)
                tmp = path + ".tiertmp"
                client.read_object_to(sh.key, tmp)
                got = os.path.getsize(tmp)
                if sh.size and got != sh.size:
                    raise OSError(f"short promote of shard {sid}: "
                                  f"{got} != {sh.size}")
                # the remote copy may be deleted below (keep_remote False):
                # the local bytes and their rename must be durable before
                # the last other copy goes away
                fsutil.fsync_path(tmp)
                os.replace(tmp, path)
                landed.append((sid, sh.key))
                moved += got
            fsutil.fsync_dir(ev.base + ".vif")
        except Exception:
            for sid, _key in landed:
                try:
                    os.remove(ev.base + ec_files.shard_ext(sid))
                except OSError:
                    pass  # never landed: nothing to undo
            raise
        ec_files.update_vif(ev.base + ".vif", remove=("remote_shards",))
        # swap in a fresh local-backed EcVolume; the old (remote-backed)
        # object is not closed, so ranged reads in flight on it finish (the
        # same contract as offload above)
        for loc in self.locations:
            if loc.ec_volumes.get(vid) is ev:
                nev = EcVolume(ev.base, vid, ev.collection, ev.geo)
                with loc.lock:
                    loc.ec_volumes[vid] = nev
        if not keep_remote:
            # delete every mapped key, not just the shards downloaded this
            # pass: a shard present both locally and remotely (a promote
            # raced a crash) still has a remote object, and the mapping
            # just dropped was its last reference
            for key in (ev.remote_spec or {}).get("keys", {}).values():
                try:
                    client.delete_object(key)
                except Exception as e:  # noqa: BLE001 — an orphan object, not data
                    log.warning("delete promoted remote shard %s: %s",
                                key, e)
        return moved

    def move_volume_local(self, vid: int, disk_type: str) -> str:
        """Same-server cross-tier move: copy a volume's files to a location
        of `disk_type` on this server and retire the old copy (the
        disk-to-disk half of volume.tier.move). Returns the new directory."""
        import shutil
        src_loc = None
        v = None
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                src_loc = loc
                break
        if v is None:
            raise KeyError(f"volume {vid} not found")
        if src_loc.disk_type == disk_type:
            return src_loc.directory  # already on the target tier
        dst_loc = self._location_for(disk_type)
        # freeze for the copy window (callers normally froze already), or
        # an append landing between copy and swap would be silently lost
        was_read_only = v.read_only
        v.read_only = True
        v.sync()
        src_base = v.file_name()
        dst_base = dst_loc.base_name(v.collection, vid)
        exts = [e for e in (".dat", ".idx", ".vif")
                if os.path.exists(src_base + e)]
        copied = []
        try:
            for ext in exts:
                # copy + fsync under a temp name, then rename: a crash
                # mid-move leaves the source authoritative
                tmp = dst_base + ext + ".tiertmp"
                shutil.copyfile(src_base + ext, tmp)
                with open(tmp, "rb+") as f:
                    os.fsync(f.fileno())
                os.replace(tmp, dst_base + ext)
                copied.append(dst_base + ext)
            # the source files are removed once the swap commits: the
            # destination's directory entries must survive first
            fsutil.fsync_dir(dst_base + ".dat")
            # build the replacement fully (needle-map load, integrity scan)
            # before touching the mapping: reads must never find the vid
            # unmapped mid-move
            nv = Volume(dst_loc.directory, v.collection, vid,
                        needle_map_kind=dst_loc.needle_map_kind,
                        create_if_missing=False)
        except Exception:
            v.read_only = was_read_only
            for p in copied:
                try:
                    os.remove(p)
                except OSError:
                    pass  # never copied: nothing to undo
            raise
        nv.read_only = was_read_only
        # map the destination before unmapping the source: both serve the
        # same frozen bytes, so whichever a racing read resolves is right;
        # closing the source then routes stragglers through the refreshed
        # mapping (VolumeClosedError retry)
        with dst_loc.lock:
            dst_loc.volumes[vid] = nv
        with src_loc.lock:
            src_loc.volumes.pop(vid, None)
        v.close()
        for ext in exts:
            try:
                os.remove(src_base + ext)
            except OSError as e:
                log.warning("retire source copy %s%s: %s", src_base, ext, e)
        return dst_loc.directory

    def close_idle_ec_handles(self, idle_s: float = 3600.0) -> int:
        """Idle-close EC shard handles (fork ec_volume.go:348 IsExpire)."""
        n = 0
        for loc in self.locations:
            for ev in loc.ec_volumes.values():
                if ev.close_idle(idle_s):
                    n += 1
        return n

    def delete_expired_ec_volumes(self, now: "float | None" = None
                                  ) -> "list[dict]":
        """Fork behavior (store.go:389): reap EC volumes past DestroyTime
        into the soft-delete trash dir. A volume reaps at its destroy_time
        instant (<=). Returns one record per reaped volume: {"vid",
        "collection", "from" (ec or remote), "bytes" (local bytes soft-moved
        to trash)}. An offloaded volume's remote objects are kept, so a
        restore remounts its remote tier intact."""
        if now is None:
            now = time.time()  # swtpu-lint: disable=wallclock-duration (destroy_time is persisted wall-clock)
        reaped = []
        for loc in self.locations:
            for vid, ev in list(loc.ec_volumes.items()):
                if ev.destroy_time and ev.destroy_time <= now:
                    with loc.lock:
                        loc.ec_volumes.pop(vid, None)
                    rec = {"vid": vid, "collection": ev.collection,
                           "from": (TIER_REMOTE if ev.remote_spec
                                    else TIER_EC),
                           "bytes": sum(
                               sh.size for sh in ev.shards.values()
                               if not isinstance(sh, RemoteEcVolumeShard))}
                    ev.destroy(to_trash=os.path.join(loc.directory, ".trash"))
                    self._drop_access(vid)
                    reaped.append(rec)
        return reaped

    def restore_ec_volume_from_trash(self, vid: int, collection: str = ""
                                     ) -> EcVolume:
        """Undo a DestroyTime reap before the trash grace expires: move the
        soft-deleted files back beside the live volumes and remount."""
        for loc in self.locations:
            trash = os.path.join(loc.directory, ".trash")
            if not os.path.isdir(trash):
                continue
            base = os.path.basename(loc.base_name(collection, vid))
            moved = False
            for fn in os.listdir(trash):
                stem, _ = os.path.splitext(fn)
                if stem == base:
                    # a crash rolling the move back leaves the file in
                    # .trash, restorable by re-running
                    os.replace(os.path.join(trash, fn),  # swtpu-lint: disable=rename-no-dir-fsync (trash restore: a rolled-back move re-runs)
                               os.path.join(loc.directory, fn))
                    moved = True
            if moved:
                return self.mount_ec_shards(vid, collection)
        raise KeyError(f"ec volume {vid} not in trash")

    # -- heartbeat assembly (store.go:259) ----------------------------------
    def collect_heartbeat(self) -> dict:
        volumes, ec_shards = [], []
        max_file_key = 0
        for loc in self.locations:
            for vid, v in loc.volumes.items():
                max_file_key = max(max_file_key, v.nm.max_key)
                volumes.append({
                    "id": vid, "size": v.content_size,
                    "collection": v.collection,
                    "file_count": v.file_count,
                    "delete_count": v.deleted_count,
                    "deleted_byte_count": v.nm.deleted_size,
                    "read_only": v.read_only,
                    "replica_placement": v.super_block.replica_placement.to_byte(),
                    "version": v.super_block.version,
                    "ttl": int.from_bytes(v.super_block.ttl.to_bytes(), "little"),
                    "compact_revision": v.super_block.compaction_revision,
                    "modified_at_second": int(v.last_append_at_ns // 1e9),
                    "disk_type": loc.disk_type,
                })
            for vid, ev in loc.ec_volumes.items():
                ec_shards.append({
                    "id": vid, "collection": ev.collection,
                    "ec_index_bits": ev.shard_bits().bits,
                    "disk_type": loc.disk_type,
                    # whole seconds: the Heartbeat's field is an int64, and
                    # a stamped TTL's instant is a float that protobuf
                    # refuses (the reap itself compares the exact instant)
                    "destroy_time": int(ev.destroy_time),
                })
        return {
            "volumes": volumes, "ec_shards": ec_shards,
            "max_file_key": max_file_key,
            "max_volume_counts": self._max_volume_counts(),
        }

    def _max_volume_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for loc in self.locations:
            out[loc.disk_type] = out.get(loc.disk_type, 0) + loc.max_volume_count
        return out

    def status(self) -> dict:
        return {
            "volumes": sum(len(l.volumes) for l in self.locations),
            "ec_volumes": sum(len(l.ec_volumes) for l in self.locations),
            "locations": [l.directory for l in self.locations],
        }

    def close(self) -> None:
        for loc in self.locations:
            for v in loc.volumes.values():
                v.close()
            for ev in loc.ec_volumes.values():
                ev.close()
