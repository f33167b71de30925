"""A cluster of the port alone, and the operator's EC flow through it, for
tests/test_torch_master.py (device="cpu") and tests/test_torch_gpu.py (the
card). It imports only the port, numpy and chip_smoke.py, whose port
picks it shares (never JAX, nor the conftest, which imports it), so the
GPU tests run where JAX is not installed.

The cluster: the port's MasterServer with its HTTP API, health engine and
admin cron (health-driven, script "ec.rebuild"), and four port volume
servers, one in each of racks r1-r4 of dc1, heartbeating over gRPC; r4
holds a regular volume of collection "scrub" with damaged needles, written
before it starts. The flow's steps, each checked exactly:

* `write_and_encode`: blobs written through MasterClient.assign and POSTs
  into two volumes grown on rack r1 (/dir/assign?rack=r1); the port's
  shell runs `lock; ec.encode; unlock`; the RS(10,4) shards spread with at
  most 4 on a rack; every shard's sha256 kept; every blob read back
  through master lookups;
* `lose_rack_and_repair`: rack r1's server stops; /cluster/health turns
  DEGRADED with exactly its shards missing; every blob reads back through
  degraded reads (LookupEcVolume); one AdminCron.trigger() rebuilds onto
  the surviving racks; the verdict returns to OK with every rebuilt shard
  equal to the original;
* `scrub`: volume.scrub of the damaged volume reports exactly the damage;
* `decode`: ec.decode of one EC volume, every blob read back.
"""

from __future__ import annotations

import hashlib
import io
import os
import time

import chip_smoke
import numpy as np

from seaweedfs_tpu_torch.client import http_util
from seaweedfs_tpu_torch.client.master_client import MasterClient
from seaweedfs_tpu_torch.ec import files
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.master.master_server import MasterServer
from seaweedfs_tpu_torch.server.grpc_service import serve_volume
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import (ec_commands,  # noqa: F401 (register)
                                       lifecycle_commands, volume_commands)
from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils import retry

D, P = 10, 4
RACKS = ("r1", "r2", "r3", "r4")
SCRUB_VID, SCRUB_NEEDLES, SCRUB_DAMAGED = 90, 300, 3


def free_port_pair() -> int:
    """A free port whose +10000 gRPC sibling is free, both below the
    kernel's ephemeral range where it leaves room: chip_smoke's pick (one
    slice of the range per test worker, no port handed out twice in one
    process), so no outgoing connection's source port, other worker's pick
    or earlier pick takes either before its server binds it."""
    return chip_smoke._free_port_pair()


def wait_until(cond, timeout: float = 10.0, msg: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if cond():
                return
        except Exception:  # noqa: BLE001 — polled state may be mid-change
            pass
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def bounded(fn, timeout: float = 60.0):
    """fn() on a daemon thread; fails if it has not returned within
    `timeout` (there is no pytest-timeout), else its result or its
    exception."""
    import threading
    box: dict = {}

    def run():
        try:
            box["v"] = fn()
        except BaseException as e:  # noqa: BLE001 — raised again below
            box["e"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise AssertionError(f"{getattr(fn, '__name__', fn)} still running "
                             f"after {timeout} s")
    if "e" in box:
        raise box["e"]
    return box.get("v")


def make_damaged_volume(dirname: str, collection: str, vid: int, n: int,
                        damaged: int, seed: int) -> "list[int]":
    """A regular volume of n needles written through Volume.write_needles,
    `damaged` of them with a data byte flipped on disk; the damaged ids."""
    rng = np.random.default_rng(seed)
    v = Volume(dirname, collection, vid)
    v.write_needles([Needle(id=i + 1, cookie=int(rng.integers(1, 1 << 32)),
                            data=rng.bytes(int(rng.integers(1000, 1100))))
                     for i in range(n)])
    v.sync()
    bad = sorted(int(i) + 1 for i in rng.choice(n, damaged, replace=False))
    with open(v.dat_path, "r+b") as f:
        for nid in bad:
            nv = v.nm.get(nid)
            off = nv.offset + 20 + int(rng.integers(0, nv.size - 5))
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x5A]))
    v.close()
    return bad


def start(root, device: str = "cpu", volume_size_limit_mb: int = 1,
          small_block: int = 1 << 12) -> dict:
    """The master and the four volume servers; `stop` ends them all."""
    retry.reset_breakers()
    geo = EcGeometry(D, P, large_block=1 << 20, small_block=small_block)
    mport, hport = free_port_pair(), free_port_pair()
    master = MasterServer(port=mport, http_port=hport,
                          volume_size_limit_mb=volume_size_limit_mb,
                          pulse_seconds=0.5, ec_parity_shards=P,
                          maintenance_scripts=["ec.rebuild"],
                          maintenance_interval_s=3600)
    master.start()
    c = {"master": master, "http": f"127.0.0.1:{hport}", "served": {},
         "geo": geo, "dirs": {}, "blobs": {}, "mc": None}
    try:
        for rack in RACKS:
            d = os.path.join(str(root), rack)
            os.makedirs(d, exist_ok=True)
            c["dirs"][rack] = d
            if rack == "r4":
                c["damaged"] = make_damaged_volume(
                    d, "scrub", SCRUB_VID, SCRUB_NEEDLES, SCRUB_DAMAGED, 4)
            port = free_port_pair()
            store = Store("127.0.0.1", port, f"127.0.0.1:{port}",
                          [DiskLocation(d, max_volume_count=32)],
                          ec_geometry=geo, coder_name="torch", device=device)
            vs = VolumeServer(store, "127.0.0.1", port, data_center="dc1",
                              rack=rack, pulse_seconds=0.5)
            c["served"][rack] = serve_volume(vs, port + 10000,
                                             master=master.address)
        wait_until(lambda: len(master.topo.nodes) == len(RACKS), timeout=20,
                   msg="four volume servers registered")
        c["mc"] = MasterClient(master.address).start()
        c["env"] = CommandEnv(master.address, mc=c["mc"], out=io.StringIO())
    except BaseException:
        stop(c)
        raise
    return c


def stop(c: dict) -> None:
    if c.get("mc") is not None:
        c["mc"].stop()
    for served in c["served"].values():
        served.stop()
    c["master"].stop()
    retry.reset_breakers()


def shell(c: dict, *lines: str) -> str:
    """Run shell lines on the cluster's CommandEnv; their output."""
    env = c["env"]
    env.out = io.StringIO()
    for line in lines:
        run_command(env, line)
    return env.out.getvalue()


def shard_files(c: dict, vid: int, collection: str) -> "dict[int, list[str]]":
    """shard id -> its files on every server's disk."""
    out: dict[int, list[str]] = {}
    for d in c["dirs"].values():
        base = os.path.join(d, f"{collection}_{vid}")
        for sid in range(c["geo"].n):
            if os.path.exists(base + files.shard_ext(sid)):
                out.setdefault(sid, []).append(base + files.shard_ext(sid))
    return out


def sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def ec_racks(master, vid: int) -> "dict[str, list[int]]":
    """rack -> the shard ids of `vid` the master sees there."""
    out: dict[str, list[int]] = {}
    for sid, nodes in master.topo.lookup_ec(vid).items():
        for n in nodes:
            out.setdefault(n.rack.id, []).append(sid)
    return {r: sorted(s) for r, s in out.items()}


def get(mc, fid: str) -> "tuple[int, bytes]":
    """GET a blob from the first holder the master names now."""
    mc.vid_map.invalidate(int(fid.split(",")[0]))
    r = http_util.get(mc.lookup_file_id(fid)[0], timeout=30)
    return r.status, r.content


def health(c: dict) -> dict:
    return http_util.get(f"http://{c['http']}/cluster/health").json()


def assert_every_blob(c: dict) -> None:
    for fid, data in c["blobs"].items():
        assert get(c["mc"], fid) == (200, data), fid


def write_and_encode(c: dict, n_blobs: int = 60) -> None:
    master, mc = c["master"], c["mc"]
    # two volumes grown on rack r1: a placement preference of the assign
    r = http_util.get(f"http://{c['http']}/dir/assign",
                      params={"collection": "ec", "rack": "r1",
                              "writableVolumeCount": "2"})
    assert r.status == 200, r.content
    rng = np.random.default_rng(17)
    # r1 must carry the most bytes (more than r4's damaged volume), so the
    # spread ranks it last
    for _ in range(n_blobs):
        data = rng.bytes(int(rng.integers(5000, 12000)))
        a = mc.assign(collection="ec")
        assert not a.error
        st = http_util.post(f"http://{a.location.url}/{a.fid}", data)
        assert st.status == 201, st.content
        c["blobs"][a.fid] = data
    vids = sorted({int(f.split(",")[0]) for f in c["blobs"]})
    assert len(vids) == 2
    for vid in vids:
        assert [n.rack.id for n in master.topo.lookup(vid)] == ["r1"]

    def sizes_settled():
        with master.topo.lock:
            got = {v.id: v.size for n in master.topo.all_nodes()
                   for v in n.all_volumes() if v.collection == "ec"}
        return all(got.get(v, 0) > 100_000 for v in vids)

    # a heartbeat acknowledged after the last write: the master's sizes are
    # the final ones, not a pulse's snapshot taken mid-way (one between
    # 100,000 B and the 10% below left a volume out of the encode)
    for served in c["served"].values():
        served.vs.heartbeat_flush()
    wait_until(sizes_settled, msg="volume sizes in heartbeats")
    out = shell(c, "lock", "ec.encode -collection ec -fullPercent 10",
                "unlock")
    assert "ec encoded 2 volumes" in out, out
    for vid in vids:
        wait_until(lambda: len(master.topo.lookup_ec(vid)) == c["geo"].n,
                   msg=f"all shards of {vid} registered")
        racks = ec_racks(master, vid)
        assert sorted(s for ids in racks.values() for s in ids) == \
            list(range(c["geo"].n))
        assert max(len(ids) for ids in racks.values()) <= P, racks
        assert master.topo.lookup(vid) == []   # the source volume is gone
    c["vids"] = vids
    c["hashes"] = {vid: {sid: sha(paths[0]) for sid, paths in
                         shard_files(c, vid, "ec").items()}
                   for vid in vids}
    assert all(len(h) == c["geo"].n for h in c["hashes"].values())
    assert_every_blob(c)


def lose_rack_and_repair(c: dict) -> None:
    master = c["master"]
    lost = {vid: ec_racks(master, vid).get("r1", []) for vid in c["vids"]}
    # the sources sat on r1, which scores last in the spread and so takes
    # the short share: fewer than p shards of each stripe
    assert all(1 <= len(s) < P for s in lost.values()), lost
    c["served"].pop("r1").stop()
    wait_until(lambda: len(master.topo.nodes) == 3,
               msg="r1's server dropped")
    wait_until(lambda: health(c)["verdict"] == "DEGRADED",
               msg="DEGRADED verdict")
    items = {it["id"]: it for it in health(c)["items"] if it["kind"] == "ec"}
    assert {vid: items[vid]["shards_missing"] for vid in c["vids"]} == lost
    for vid in c["vids"]:
        assert items[vid]["rs"] == {"k": D, "n": D + P}
    assert_every_blob(c)

    master.admin_cron.trigger()
    assert "repair" in master.admin_cron.last_output
    wait_until(lambda: health(c)["verdict"] == "OK", timeout=20,
               msg="verdict back to OK")
    have = {vid: shard_files(c, vid, "ec") for vid in c["vids"]}
    for vid in c["vids"]:
        for sid in lost[vid]:
            live = [p for p in have[vid][sid]
                    if not p.startswith(c["dirs"]["r1"] + os.sep)]
            assert live and sha(live[0]) == c["hashes"][vid][sid], sid
        assert "r1" not in ec_racks(master, vid)
    assert_every_blob(c)


def scrub(c: dict) -> None:
    try:
        shell(c, f"volume.scrub -volumeId {SCRUB_VID}")
    except RuntimeError as e:
        assert f"{SCRUB_DAMAGED} corrupt" in str(e)
    else:
        raise AssertionError("volume.scrub passed a damaged volume")
    out = c["env"].out.getvalue()
    assert f"scrubbed {SCRUB_NEEDLES} needles, {SCRUB_DAMAGED} corrupt" \
        in out, out
    assert f"CORRUPT: {[hex(n) for n in c['damaged']]}" in out, out


def decode(c: dict) -> None:
    master = c["master"]
    vid = c["vids"][0]
    out = shell(c, "lock", f"ec.decode -volumeId {vid}", "unlock")
    assert f"decoded ec volume {vid}" in out, out
    wait_until(lambda: master.topo.lookup(vid) and
               not master.topo.lookup_ec(vid),
               msg="decoded volume registered, shards gone")
    assert_every_blob(c)
