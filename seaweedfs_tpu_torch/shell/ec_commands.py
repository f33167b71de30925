"""ec.* commands — the north-star admin pipeline.

Reference: weed/shell/command_ec_encode.go:61 (Do), :187 (spreadEcShards),
:333 (balancedEcDistribution), command_ec_rebuild.go:100,
command_ec_balance.go, command_ec_decode.go. Fork semantics honored: source
volumes can be filtered to SSD (-sourceDiskType), shards move with
VolumeEcShardsMove, rebuilds can use CopyByRebuild.

The port's copy of seaweedfs_tpu/shell/ec_commands.py.
"""

from __future__ import annotations

import argparse
import time

from ..pb import volume_server_pb2 as vpb
from ..utils.rpc import Stub, VOLUME_SERVICE
from .commands import CommandEnv, command, deposed


def _stub(env: CommandEnv, srv: dict) -> Stub:
    return Stub(env.grpc_addr(srv["id"], srv["grpc_port"]), VOLUME_SERVICE)


def parse_ec_shards(spec: str) -> tuple[int, int]:
    """'d,p' -> (d, p); the one grammar every -ecShards flag shares."""
    try:
        d_s, p_s = spec.split(",")
        d, p = int(d_s), int(p_s)
    except ValueError:
        raise ValueError(f"-ecShards wants 'd,p' (e.g. 10,4), got {spec!r}"
                         ) from None
    if d <= 0 or p <= 0 or d + p > 256:
        raise ValueError(f"invalid RS geometry ({d},{p})")
    return d, p


def _ec_holders(env: CommandEnv, vid: int) -> dict[int, list[dict]]:
    """shard id -> servers holding it."""
    out: dict[int, list[dict]] = {}
    for srv in env.collect_volume_servers():
        for disk in srv["disks"].values():
            for s in disk.ec_shard_infos:
                if s.id == vid:
                    for sid in range(32):
                        if s.ec_index_bits >> sid & 1:
                            out.setdefault(sid, []).append(srv)
    return out


def _settled_ec_holders(env: CommandEnv, vid: int,
                        tries: int = 20, interval: float = 0.2
                        ) -> dict[int, list[dict]]:
    """Master topology is heartbeat-propagated (eventually consistent); after
    mount/unmount RPCs the view lags by up to a pulse. Poll until two
    consecutive reads agree before acting on it."""
    prev = None
    holders = _ec_holders(env, vid)
    for _ in range(tries):
        cur = {sid: sorted(h["id"] for h in hs) for sid, hs in holders.items()}
        if prev is not None and cur == prev:
            break
        prev = cur
        time.sleep(interval)
        holders = _ec_holders(env, vid)
    return holders


def _free_slots(srv: dict) -> int:
    return sum(d.free_volume_count for d in srv["disks"].values())


def balanced_ec_distribution(servers: list[dict], n_shards: int,
                             parity: int = 0, vid: int = 0) -> list[dict]:
    """Shard -> server assignment through the placement engine
    (placement/engine.py spread_ec_shards): scored by free slots, byte
    load and breaker state, and RACK-CAPPED — no rack holds more than
    `parity` shards of the stripe, so a rack loss stays reconstructable
    (degrades gracefully to the most-even spread when the fleet has too
    few racks). parity=0 keeps the legacy free-slot ranking semantics
    with no rack cap (the reference command_ec_encode.go:333 shape)."""
    if not servers:
        raise RuntimeError("no volume servers")
    from ..placement import snapshot_from_servers, spread_ec_shards
    snap = snapshot_from_servers(servers)
    by_id = {s["id"]: s for s in servers}
    views = spread_ec_shards(snap, n_shards,
                             parity if parity > 0 else n_shards, vid=vid)
    return [by_id[v.id] for v in views]


def _codec_names() -> "list[str]":
    """Registered erasure codecs — any codec behind the ErasureCoder
    seam shows up in help/validation without editing this file. Called
    at parse time, never at import (the lazy codec registry exists so a
    help string doesn't eagerly import every codec module)."""
    from ..ops.coder import registered_codecs
    return registered_codecs()


@command("ec.encode",
         "-volumeId N | -collection C|'*' [-fullPercent 95] "
         "[-sourceDiskType ssd] [-ecShards d,p] [-codec NAME]: "
         "erasure-code volumes and spread shards (geometry defaults to the "
         "server's -ecShards; fork 14+2 and upstream 10+4 both just work; "
         "-codec takes any registered erasure codec — ec.encode -h "
         "enumerates them; piggyback and msr are repair-efficient)",
         needs_lock=True)
def cmd_ec_encode(env: CommandEnv, args):
    p = argparse.ArgumentParser(prog="ec.encode")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-collection", default=None)
    p.add_argument("-fullPercent", type=float, default=95.0)
    p.add_argument("-sourceDiskType", default="")
    p.add_argument("-dataShards", type=int, default=0)
    p.add_argument("-parityShards", type=int, default=0)
    p.add_argument("-ecShards", default="",
                   help="geometry as 'd,p' (e.g. 14,2 or 10,4); shorthand "
                        "for -dataShards/-parityShards")
    p.add_argument("-codec", default="",
                   help=f"erasure codec: {' | '.join(_codec_names())} "
                        "(blank = server default; piggyback and msr are "
                        "repair-efficient)")
    opt = p.parse_args(args)
    if opt.codec and opt.codec not in _codec_names():
        raise ValueError(f"unknown codec {opt.codec!r}; registered: "
                         f"{', '.join(_codec_names())}")
    if opt.ecShards:
        opt.dataShards, opt.parityShards = parse_ec_shards(opt.ecShards)

    limit = env.mc.volume_list().volume_size_limit_mb * (1 << 20)
    targets = []  # (vid, collection, srv)
    for srv in env.collect_volume_servers():
        for dtype, disk in srv["disks"].items():
            if opt.sourceDiskType and dtype != opt.sourceDiskType:
                continue  # fork: EC source restricted by disk type
            for v in disk.volume_infos:
                if opt.volumeId and v.id != opt.volumeId:
                    continue
                if not opt.volumeId:
                    if opt.collection is None or (
                            opt.collection != "*"
                            and v.collection != opt.collection):
                        continue
                    if limit and v.size < limit * opt.fullPercent / 100:
                        continue
                targets.append((v.id, v.collection, srv))
    seen = set()
    targets = [t for t in targets
               if t[0] not in seen and not seen.add(t[0])]
    if not targets:
        env.println("no volumes eligible for ec encoding")
        return
    # group by source server so each server encodes ALL its volumes through
    # one shared device stream (VolumeEcShardsGenerateBatch; ec/stream.py) —
    # the reference loops per volume instead (command_ec_encode.go:113-126)
    by_src: dict[tuple[str, str], tuple[dict, list[tuple[int, str]]]] = {}
    for vid, collection, srv in targets:
        by_src.setdefault((srv["id"], collection),
                          (srv, []))[1].append((vid, collection))
    encoded = 0
    for srv, vols in by_src.values():
        if deposed(env):
            env.println("aborting ec.encode: leadership lost")
            break
        encoded += _encode_on_server(env, srv, vols, opt)
    env.println(f"ec encoded {encoded} volumes")


def _encode_on_server(env: CommandEnv, srv: dict,
                      vols: "list[tuple[int, str]]", opt) -> int:
    """Freeze + batch-generate + spread one server's volumes. A failure
    rolls the un-encoded volumes back to writable and never aborts other
    servers' batches (caller loops on)."""
    stub = _stub(env, srv)
    collection = vols[0][1]
    vids = [v for v, _ in vols]
    env.println(f"  ec.encode volumes {vids} on {srv['id']} (batched)")
    frozen = []
    for vid, _c in vols:  # freeze writes (command_ec_encode.go:147)
        stub.call("VolumeMarkReadonly",
                  vpb.VolumeMarkReadonlyRequest(volume_id=vid),
                  vpb.VolumeMarkReadonlyResponse)
        frozen.append(vid)
    done: list[int] = []
    d = p = 0
    try:
        gen = stub.call("VolumeEcShardsGenerateBatch",
                        vpb.VolumeEcShardsGenerateBatchRequest(
                            volume_ids=vids, collection=collection,
                            data_shards=opt.dataShards,
                            parity_shards=opt.parityShards,
                            codec=getattr(opt, "codec", "")),
                        vpb.VolumeEcShardsGenerateBatchResponse,
                        timeout=3600 * len(vids))
        done = list(gen.encoded_volume_ids)
        d, p = gen.data_shards, gen.parity_shards
        if gen.codec:
            env.println(f"    codec {gen.codec} RS({d},{p})")
    except Exception as e:  # noqa: BLE001
        env.println(f"    batch generate failed on {srv['id']}: {e}")
    for vid in frozen:
        if vid not in done:  # rollback: un-encoded volumes take writes again
            try:
                stub.call("VolumeMarkWritable",
                          vpb.VolumeMarkWritableRequest(volume_id=vid),
                          vpb.VolumeMarkWritableResponse)
            except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (best-effort rollback of mark-readonly)
                pass
    coll_by_vid = dict(vols)
    for vid in done:
        _spread_and_clean(env, vid, coll_by_vid.get(vid, collection), srv, d, p)
    return len(done)


def _spread_and_clean(env: CommandEnv, vid: int, collection: str, srv: dict,
                      d: int, p: int) -> None:
    """Distribute generated shards and delete the source volume
    (reference command_ec_encode.go:187 spreadEcShards)."""
    stub = _stub(env, srv)
    if not d or not p:
        # the batch response didn't carry the geometry (pre-geometry
        # server): ask the holder for the SEALED (d,p) instead of
        # assuming an RS default — the fork's stale "10.4" bug class,
        # where help text and fallbacks hardcode one geometry while the
        # .vif is the source of truth
        info = stub.call("VolumeEcShardsInfo",
                         vpb.VolumeEcShardsInfoRequest(
                             volume_id=vid, collection=collection),
                         vpb.VolumeEcShardsInfoResponse, timeout=30)
        d = d or info.data_shards
        p = p or info.parity_shards
    n_shards = (d or 10) + (p or 4)
    # 3. spread (command_ec_encode.go:187): copy to targets, mount, clean
    # src — rack-capped at p shards per rack so rack loss != data loss
    servers = env.collect_volume_servers()
    placement = balanced_ec_distribution(servers, n_shards,
                                         parity=(p or 4), vid=vid)
    by_server: dict[str, tuple[dict, list[int]]] = {}
    for sid, target in enumerate(placement):
        by_server.setdefault(target["id"], (target, []))[1].append(sid)
    src_grpc = env.grpc_addr(srv["id"], srv["grpc_port"])
    for tid, (target, sids) in by_server.items():
        if tid != srv["id"]:
            _stub(env, target).call(
                "VolumeEcShardsCopy",
                vpb.VolumeEcShardsCopyRequest(
                    volume_id=vid, collection=collection, shard_ids=sids,
                    copy_ecx_file=True, copy_ecj_file=True, copy_vif_file=True,
                    source_data_node=src_grpc),
                vpb.VolumeEcShardsCopyResponse, timeout=3600)
        _stub(env, target).call(
            "VolumeEcShardsMount",
            vpb.VolumeEcShardsMountRequest(volume_id=vid, collection=collection,
                                           shard_ids=sids),
            vpb.VolumeEcShardsMountResponse)
        env.println(f"    shards {sids} -> {tid}")
    # 4. delete shards that moved away from source + the original volume
    keep = by_server.get(srv["id"], (None, []))[1]
    moved = [s for s in range(n_shards) if s not in keep]
    if moved:
        stub.call("VolumeEcShardsUnmount",
                  vpb.VolumeEcShardsUnmountRequest(volume_id=vid, shard_ids=moved),
                  vpb.VolumeEcShardsUnmountResponse)
        stub.call("VolumeEcShardsDelete",
                  vpb.VolumeEcShardsDeleteRequest(volume_id=vid,
                                                  collection=collection,
                                                  shard_ids=moved),
                  vpb.VolumeEcShardsDeleteResponse)
    stub.call("VolumeDelete", vpb.VolumeDeleteRequest(volume_id=vid),
              vpb.VolumeDeleteResponse)


@command("ec.rebuild", "[-volumeId N] [-byRebuild]: restore missing ec "
         "shards (geometry and codec follow each volume's sealed .vif, "
         "never a fixed RS default)", needs_lock=True)
def cmd_ec_rebuild(env: CommandEnv, args):
    """Rebuild runs ON a holder; remote survivors stream in by RANGE —
    or as packed computed fragments through VolumeEcShardRead's
    ranged-compute mode — following the volume's codec repair plan: a
    piggybacked stripe moves ~(d+|group|)/2 half-shards for a single
    data-shard loss, an msr stripe (n-1)/p shard-equivalents for ANY
    single loss, where the old gather-then-rebuild flow copied d full
    shard files before reconstructing anything. Returns
    {rebuilt, bytes_read, bytes_written} so callers (cluster.repair)
    can journal the traffic."""
    p = argparse.ArgumentParser(prog="ec.rebuild")
    p.add_argument("-volumeId", type=int, default=0)
    p.add_argument("-byRebuild", action="store_true",
                   help="use the fork's CopyByRebuild RPC on a fresh server")
    opt = p.parse_args(args)
    # find all ec volumes and their shard coverage
    vols: dict[int, tuple[str, dict[int, list[dict]]]] = {}
    for srv in env.collect_volume_servers():
        for disk in srv["disks"].values():
            for s in disk.ec_shard_infos:
                if opt.volumeId and s.id != opt.volumeId:
                    continue
                vols.setdefault(s.id, (s.collection, {}))
    summary = {"rebuilt": 0, "bytes_read": 0, "bytes_written": 0}
    for vid, (collection, _) in sorted(vols.items()):
        holders = _settled_ec_holders(env, vid)
        if not holders:
            continue
        # geometry: n = max(shard ids)+1 is unreliable; read from a holder
        have = sorted(holders)
        any_srv = holders[have[0]][0]
        n = _probe_n_shards(env, any_srv, vid, collection)
        missing = [s for s in range(n) if s not in holders]
        if not missing:
            continue
        env.println(f"  ec volume {vid}: missing shards {missing}")
        if opt.byRebuild:
            # fork path: rebuild directly onto the least-loaded server
            target = balanced_ec_distribution(
                env.collect_volume_servers(), 1)[0]
            resp = _stub(env, target).call(
                "VolumeEcShardsCopyByRebuild",
                vpb.VolumeEcShardsCopyByRebuildRequest(
                    volume_id=vid, collection=collection, shard_ids=missing),
                vpb.VolumeEcShardsCopyByRebuildResponse, timeout=3600)
            host = target
        else:
            # default: rebuild on the holder with the most local shards
            # (fewest remote ranges to pull); deterministic on ties
            counts: dict[str, list] = {}
            for _sid, hs in holders.items():
                for h in hs:
                    counts.setdefault(h["id"], [0, h])
                    counts[h["id"]][0] += 1
            host = sorted(counts.items(),
                          key=lambda kv: (-kv[1][0], kv[0]))[0][1][1]
            resp = _stub(env, host).call(
                "VolumeEcShardsRebuild",
                vpb.VolumeEcShardsRebuildRequest(volume_id=vid,
                                                 collection=collection),
                vpb.VolumeEcShardsRebuildResponse, timeout=3600)
        if resp.rebuilt_shard_ids:
            _stub(env, host).call(
                "VolumeEcShardsMount",
                vpb.VolumeEcShardsMountRequest(
                    volume_id=vid, collection=collection,
                    shard_ids=list(resp.rebuilt_shard_ids)),
                vpb.VolumeEcShardsMountResponse)
        env.println(f"    rebuilt {sorted(resp.rebuilt_shard_ids)} on "
                    f"{host['id']}: {resp.bytes_read} B read / "
                    f"{resp.bytes_written} B written")
        summary["rebuilt"] += len(resp.rebuilt_shard_ids)
        summary["bytes_read"] += resp.bytes_read
        summary["bytes_written"] += resp.bytes_written
    env.println(f"rebuilt {summary['rebuilt']} shards "
                f"({summary['bytes_read']} survivor bytes read)")
    return summary


def _gather_shards(env: CommandEnv, host_stub: Stub, vid: int, collection: str,
                   fetch: list[int], holders: dict[int, list[dict]]) -> None:
    """Copy each shard in `fetch` onto the host from a server that actually
    holds it (per-shard source), including the index sidecars. Holders come
    from eventually-consistent master state, so try every listed holder and
    refresh the view on failure."""
    first = True
    for sid in fetch:
        hs = list(holders.get(sid) or [])
        last_err: Exception | None = None
        copied = False
        for attempt in range(6):
            for src in hs:
                try:
                    host_stub.call(
                        "VolumeEcShardsCopy",
                        vpb.VolumeEcShardsCopyRequest(
                            volume_id=vid, collection=collection,
                            shard_ids=[sid],
                            copy_ecx_file=first, copy_ecj_file=first,
                            copy_vif_file=first,
                            source_data_node=env.grpc_addr(
                                src["id"], src["grpc_port"])),
                        vpb.VolumeEcShardsCopyResponse, timeout=3600)
                    copied = True
                    break
                except Exception as e:  # noqa: BLE001
                    last_err = e
            if copied or not hs and attempt > 2:
                break
            if not copied:
                time.sleep(0.3)
                hs = list(_ec_holders(env, vid).get(sid) or [])
        if not copied:
            if last_err is None:
                continue  # no holder anywhere: leave it to rebuild
            raise RuntimeError(
                f"gather shard {vid}.{sid} failed from all holders: {last_err}")
        first = False


def _probe_n_shards(env: CommandEnv, srv: dict, vid: int, collection: str) -> int:
    """Ask a holder for the volume's real geometry (VolumeEcShardsInfo reads
    the .vif); fall back to the reference default 14 only if the RPC fails."""
    try:
        resp = _stub(env, srv).call(
            "VolumeEcShardsInfo",
            vpb.VolumeEcShardsInfoRequest(volume_id=vid, collection=collection),
            vpb.VolumeEcShardsInfoResponse)
        if resp.data_shards:
            return resp.data_shards + resp.parity_shards
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (pre-geometry-RPC server: fork default)
        pass
    return 14


@command("ec.balance",
         "[-dryRun] [-collection C] [-maxMoves 64]: spread ec shards "
         "evenly across servers, rack-safety-capped")
def cmd_ec_balance(env: CommandEnv, args):
    """Thin shell over the placement plane (seaweedfs_tpu/placement/):
    ONE topology snapshot plans every move (the old loop re-ran the
    settled-holder poll + a full cluster collect per single shard), all
    shards of a stripe moving between one (src, dst) pair ride ONE
    VolumeEcShardsMove RPC, no rack ends up holding more than the
    stripe's parity count, and every hop is maintenance-class through
    the QoS plane with its byte cost journaled. -dryRun prints the
    exact plan and performs zero mutating RPCs."""
    from ..maintenance import make_probes
    from ..placement import (BalanceExecutor, build_ec_balance_plan,
                             snapshot_from_servers)

    p = argparse.ArgumentParser(prog="ec.balance")
    p.add_argument("-dryRun", action="store_true",
                   help="print the plan, mutate nothing")
    p.add_argument("-collection", default=None,
                   help="balance only this collection's stripes")
    p.add_argument("-maxMoves", type=int, default=64)
    p.add_argument("-url", default="",
                   help="master HTTP base URL (fetches its -linkCosts "
                        "policy so plans price moves like the cron)")
    p.add_argument("-linkCosts", default="",
                   help="geo link-cost policy (inline JSON or file); "
                        "overrides the master's")
    opt = p.parse_args(args)

    # stripes can drift for a pulse after encode/rebuild RPCs; settle
    # one stripe's holder view (two consecutive identical reads) before
    # snapshotting so the plan isn't built mid-heartbeat — ONCE, not
    # once per move like the old loop
    any_vid = next((s.id for srv in env.collect_volume_servers()
                    for disk in srv["disks"].values()
                    for s in disk.ec_shard_infos), None)
    if any_vid is None:
        env.println("no ec shards to balance")
        return
    _settled_ec_holders(env, any_vid, tries=5)
    _remount_probe, geometry_probe = make_probes(env)

    def parity_of(vid: int, collection: str) -> "int | None":
        g = geometry_probe(vid, collection)
        return g.get("p") if g else None

    def shard_bytes_of(vid: int, collection: str) -> "int | None":
        g = geometry_probe(vid, collection)
        return g.get("shard_size") if g else None

    limit_mb = env.mc.volume_list().volume_size_limit_mb or 30_000
    snap = snapshot_from_servers(
        env.collect_volume_servers(), shard_bytes_of=shard_bytes_of,
        default_shard_bytes=(limit_mb << 20) // 10)
    from .health_util import fetch_link_costs
    plan = build_ec_balance_plan(snap, collection=opt.collection,
                                 parity_of=parity_of,
                                 max_moves=opt.maxMoves,
                                 costs=fetch_link_costs(opt.url,
                                                        opt.linkCosts))
    plan.render(env.println)
    if opt.dryRun:
        BalanceExecutor(env).execute(plan, dry_run=True)
        env.println("dry run: nothing executed")
        return
    had_lock = bool(env.lock_token)
    env.acquire_lock()
    try:
        res = BalanceExecutor(env, max_moves=opt.maxMoves).execute(plan)
    finally:
        if not had_lock:
            try:
                env.release_lock()
            except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (lease already expired/released)
                pass
    moved = sum(len(m["shard_ids"]) for m in res["done"])
    env.println(f"moved {moved} shards in {len(res['done'])} grouped "
                f"move(s), {len(res['failed'])} failed")
    for f in res["failed"]:
        env.println(f"  FAILED ec {f['vid']} shards {f['shard_ids']} "
                    f"{f['src']} -> {f['dst']}: {f['error']}")


@command("ec.decode", "-volumeId N: convert ec shards back to a normal "
         "volume (decodes with the codec and (data,parity) sealed in the "
         "volume's .vif)", needs_lock=True)
def cmd_ec_decode(env: CommandEnv, args):
    p = argparse.ArgumentParser(prog="ec.decode")
    p.add_argument("-volumeId", type=int, required=True)
    opt = p.parse_args(args)
    vid = opt.volumeId
    holders = _settled_ec_holders(env, vid)
    if not holders:
        env.println(f"no ec shards for volume {vid}")
        return
    # gather all shards onto one holder then ShardsToVolume
    servers = {h["id"]: h for hs in holders.values() for h in hs}
    host = next(iter(servers.values()))
    collection = ""
    for srv in env.collect_volume_servers():
        for disk in srv["disks"].values():
            for s in disk.ec_shard_infos:
                if s.id == vid:
                    collection = s.collection
    host_stub = _stub(env, host)
    host_sids = {s for s, hs in holders.items()
                 if any(h["id"] == host["id"] for h in hs)}
    fetch = sorted(s for s in holders if s not in host_sids)
    if fetch:
        _gather_shards(env, host_stub, vid, collection, fetch, holders)
        host_stub.call("VolumeEcShardsMount",
                       vpb.VolumeEcShardsMountRequest(
                           volume_id=vid, collection=collection,
                           shard_ids=fetch),
                       vpb.VolumeEcShardsMountResponse)
    host_stub.call("VolumeEcShardsToVolume",
                   vpb.VolumeEcShardsToVolumeRequest(volume_id=vid,
                                                     collection=collection),
                   vpb.VolumeEcShardsToVolumeResponse, timeout=3600)
    # drop leftover shards elsewhere
    for sid, hs in holders.items():
        for h in hs:
            if h["id"] == host["id"]:
                continue
            _stub(env, h).call(
                "VolumeEcShardsUnmount",
                vpb.VolumeEcShardsUnmountRequest(volume_id=vid, shard_ids=[sid]),
                vpb.VolumeEcShardsUnmountResponse)
            _stub(env, h).call(
                "VolumeEcShardsDelete",
                vpb.VolumeEcShardsDeleteRequest(volume_id=vid,
                                                collection=collection,
                                                shard_ids=[sid]),
                vpb.VolumeEcShardsDeleteResponse)
    env.println(f"decoded ec volume {vid} back to a normal volume on {host['id']}")


@command("ec.volume.delete", "-volumeId N [-collection C]: delete an ec "
         "volume's shards everywhere", needs_lock=True,
         aliases=("ecVolume.delete",))
def cmd_ec_volume_delete(env: CommandEnv, args):
    """Reference command_ecVolume_delete.go (fork)."""
    p = argparse.ArgumentParser(prog="ec.volume.delete")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    opt = p.parse_args(args)
    removed = 0
    for srv in env.collect_volume_servers():
        sids: list[int] = []
        for disk in srv["disks"].values():
            for s in disk.ec_shard_infos:
                if s.id != opt.volumeId:
                    continue
                sids.extend(i for i in range(32)
                            if s.ec_index_bits & (1 << i) and i not in sids)
        if not sids:
            continue
        stub = _stub(env, srv)
        stub.call("VolumeEcShardsUnmount",
                  vpb.VolumeEcShardsUnmountRequest(volume_id=opt.volumeId,
                                                   shard_ids=sids),
                  vpb.VolumeEcShardsUnmountResponse)
        stub.call("VolumeEcShardsDelete",
                  vpb.VolumeEcShardsDeleteRequest(volume_id=opt.volumeId,
                                                  collection=opt.collection,
                                                  shard_ids=sids),
                  vpb.VolumeEcShardsDeleteResponse)
        removed += len(sids)
        env.println(f"  removed shards {sids} from {srv['id']}")
    env.println(f"deleted ec volume {opt.volumeId} ({removed} shards)")
