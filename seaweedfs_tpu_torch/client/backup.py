"""Incremental volume backup to a local directory.

Reference: weed/command/backup.go — first run pulls the full .dat/.idx
(CopyFile stream); later runs append only the records newer than the local
tail (VolumeSyncStatus + VolumeIncrementalCopy). A compaction-revision
mismatch (the remote vacuumed since the last backup) forces a fresh full
copy, exactly like runBackup's Destroy-and-recreate path.

The port's copy of seaweedfs_tpu/client/backup.py, over the port's
storage/volume.Volume, pb/volume_server_pb2 and utils/rpc.Stub; the
volume server it pulls from may run either package.
"""

from __future__ import annotations

import os

from ..pb import volume_server_pb2 as vpb
from ..storage.volume import Volume
from ..utils.log import logger
from ..utils.rpc import Stub, VOLUME_SERVICE

log = logger("backup")


def _grpc_addr(loc: dict) -> str:
    host = (loc.get("url") or loc["public_url"]).rsplit(":", 1)[0]
    return f"{host}:{loc['grpc_port']}"


def _apply_stream(v: Volume, stream) -> int:
    """Apply raw .dat chunks record-wise with a carry buffer for the record
    straddling each chunk boundary — O(chunk) memory however large the diff."""
    import struct

    from ..storage import types as t
    from ..storage.needle import record_size_from_header

    carry = b""
    applied = 0
    for resp in stream:
        buf = carry + resp.file_content
        # largest prefix of whole records
        pos = 0
        while pos + t.NEEDLE_HEADER_SIZE <= len(buf):
            _, _nid, nsize = struct.unpack_from("<IQI", buf, pos)
            rec_len = record_size_from_header(nsize)
            if pos + rec_len > len(buf):
                break
            pos += rec_len
        if pos:
            applied += v.append_records(buf[:pos])
        carry = buf[pos:]
    if carry:
        log.warning("incremental stream ended mid-record (%d bytes dropped)",
                    len(carry))
    return applied


def backup_volume(mc, vid: int, dest_dir: str, collection: str = "") -> dict:
    """One backup pass for `vid` into dest_dir. Returns a summary dict.

    mc: a started MasterClient (resolves the volume's server).
    """
    locs = mc.lookup(vid)
    if not locs:
        raise KeyError(f"volume {vid} has no locations")
    stub = Stub(_grpc_addr(locs[0]), VOLUME_SERVICE)
    status = stub.call("VolumeSyncStatus",
                       vpb.VolumeSyncStatusRequest(volume_id=vid),
                       vpb.VolumeSyncStatusResponse)
    collection = collection or status.collection

    base_exists = os.path.exists(
        Volume.path_for(dest_dir, collection, vid) + ".dat")
    mode = "incremental"
    if base_exists:
        v = Volume(dest_dir, collection, vid, create_if_missing=False)
        if v.super_block.compaction_revision != status.compact_revision:
            # remote vacuumed since last backup: local offsets are invalid
            log.info("volume %d compact revision %d != local %d; full resync",
                     vid, status.compact_revision,
                     v.super_block.compaction_revision)
            v.close()
            v.destroy()
            base_exists = False
    if not base_exists:
        mode = "full"
        _full_copy(stub, vid, collection, dest_dir)
        v = Volume(dest_dir, collection, vid, create_if_missing=False)

    since = v.last_record_append_ns()
    applied = _apply_stream(v, stub.call_stream(
        "VolumeIncrementalCopy",
        vpb.VolumeIncrementalCopyRequest(volume_id=vid, since_ns=since),
        vpb.VolumeIncrementalCopyResponse))
    v.sync()
    out = {"volume_id": vid, "mode": mode, "since_ns": since,
           "records_applied": applied, "size": v.content_size}
    v.close()
    return out


def _full_copy(stub: Stub, vid: int, collection: str, dest_dir: str) -> None:
    base = Volume.path_for(dest_dir, collection, vid)
    for ext in (".dat", ".idx"):
        with open(base + ext, "wb") as f:
            for resp in stub.call_stream(
                    "CopyFile",
                    vpb.CopyFileRequest(volume_id=vid, collection=collection,
                                        ext=ext),
                    vpb.CopyFileResponse):
                f.write(resp.file_content)
