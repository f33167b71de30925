"""Set-up of the data: the seeded needles written with the program's own
storage (`storage.volume.Volume.write_needles`), EC-encoded with its
`ec.stream.encode_volumes` (kernel K1 on the card) into each rack's
directory. Then each server mounts what its directory holds through its
own RPC (VolumeEcShardsMount)."""

from __future__ import annotations

import os
import shutil

import numpy as np

from .reference import needles as ref

FRAME_BYTES = 16 << 20  # needles a Volume.write_needles call takes


def rack_names(cfg: dict) -> "list[str]":
    return [f"r{i + 1}" for i in range(int(cfg["racks"]))]


def shard_rack(cfg: dict, sid: int) -> int:
    """Shard i sits in rack r(1 + i mod racks): round robin within
    placement's cap of p shards a rack."""
    return sid % int(cfg["racks"])


def write_volume(dirname: str, collection: str, vol: ref.Volume) -> str:
    """The needles of `vol` through the program's Volume; returns the
    .dat path. Holds the program to the reference's record layout, which
    the routing and the stripe arithmetic rest on."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    v = Volume(dirname, collection, vol.vid)
    try:
        offs: "list[int]" = []
        i = 0
        while i < vol.n:
            j, size = i, 0
            while j < vol.n and (j == i or size + vol.sizes[j] <= FRAME_BYTES):
                size += int(vol.sizes[j])
                j += 1
            offs += v.write_needles([
                Needle(id=k + 1, cookie=int(vol.cookies[k]),
                       data=vol.needle(k)) for k in range(i, j)])
            i = j
        dat = v.dat_path
    finally:
        v.close()
    if not np.array_equal(np.array(offs, np.int64), vol.offsets()) or \
            os.path.getsize(dat) != vol.dat_size():
        raise RuntimeError(f"volume {vol.vid}: the program's records are "
                           "not where the reference's layout puts them")
    return dat


def base_name(collection: str, vid: int) -> str:
    return f"{collection}_{vid}" if collection else str(vid)


def build_ec(cfg: dict, vols: "list[ref.Volume]", staging: str,
             device: str) -> None:
    """Write and encode every volume in `staging`."""
    from seaweedfs_tpu_torch.ec import stream
    from seaweedfs_tpu_torch.ec.locate import EcGeometry
    from seaweedfs_tpu_torch.ops.coder import TorchCoder
    d, p = int(cfg["d"]), int(cfg["p"])
    jobs = []
    for vol in vols:
        dat = write_volume(staging, cfg["collection"], vol)
        jobs.append((dat, dat[:-4], dat[:-4] + ".idx"))
    geo = EcGeometry(d, p, int(cfg["large_block"]), int(cfg["small_block"]))
    stream.encode_volumes(jobs, geo, TorchCoder(d, p, device=device))


def place_ec(cfg: dict, vols: "list[ref.Volume]", staging: str,
             rack_dirs: "list[str]") -> None:
    """Shard i of each volume moved into its rack's directory, the .ecx
    and .vif copied beside it. Done once the servers are up: a server
    that scanned its directory mid-move would load half a volume."""
    from seaweedfs_tpu_torch.ec import files
    d, p = int(cfg["d"]), int(cfg["p"])
    for vol in vols:
        name = base_name(cfg["collection"], vol.vid)
        src = os.path.join(staging, name)
        for sid in range(d + p):
            dst = os.path.join(rack_dirs[shard_rack(cfg, sid)], name)
            os.replace(src + files.shard_ext(sid), dst + files.shard_ext(sid))
        for rd in {rack_dirs[shard_rack(cfg, s)] for s in range(d + p)}:
            for ext in (".ecx", ".vif"):
                shutil.copyfile(src + ext, os.path.join(rd, name) + ext)


def mount(cluster, cfg: dict, holders: "dict[int, list]") -> None:
    """Each server mounts the shards its directory holds (every vid in
    `holders[i]` for server i), through the program's RPC."""
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.utils.rpc import VOLUME_SERVICE, Stub
    for i, srv in enumerate(cluster.servers):
        stub = Stub(srv.grpc, VOLUME_SERVICE)
        for vid in holders.get(i, []):
            stub.call("VolumeEcShardsMount",
                      vpb.VolumeEcShardsMountRequest(
                          volume_id=vid, collection=cfg["collection"]),
                      vpb.VolumeEcShardsMountResponse, timeout=120)
