"""fs.* / volume.fsck shell commands over the filer.

Reference: weed/shell command_fs_ls.go, command_fs_cat.go,
command_fs_du.go, command_fs_mkdir.go, command_fs_rm.go,
command_fs_verify.go:54 (read every chunk of every entry),
command_volume_fsck.go:81 (filer chunk refs vs volume needles),
command_s3_bucket_*.go. Filer discovery: `-filer host:port` per command
or the shell-wide default (reference resolves filers from the master
cluster list).

The port's copy of seaweedfs_tpu/shell/fs_commands.py: every fs.* command,
volume.fsck and every s3.* command (s3.bucket.*, s3.bucket.quota[.check],
s3.clean.uploads, s3.configure, s3.circuitbreaker) and fs.meta.notify into
the port's notification queues. HTTP goes through
client/http_util instead of requests; the FilerClient that s3.configure and
s3.circuitbreaker open is closed after use.
"""

from __future__ import annotations

import argparse

from ..pb import filer_pb2 as fpb
from ..storage.types import parse_file_id
from ..utils.rpc import FILER_SERVICE, Stub
from .commands import CommandEnv, command

BUCKETS_DIR = "/buckets"


def _filer_addr(env: CommandEnv, opt_filer: str) -> str:
    addr = opt_filer or env.option.get("filer", "") \
        or _discover_filer(env)
    if not addr:
        raise RuntimeError("no filer configured; pass -filer host:port")
    return addr


def _discover_filer(env: CommandEnv) -> str:
    """Resolve a live filer from the master cluster list (the reference
    shell resolves filers the same way; cluster.go:104). Cached on the
    env — including the advertised grpc port, which _filer_grpc must
    honor for filers off the +10000 convention."""
    cached = env.option.get("_discovered_filer")
    if cached:
        return cached
    from .commands import discover_cluster_node
    addr, gport = discover_cluster_node(env, "filer")
    if addr:
        env.option["_discovered_filer"] = addr
        if gport:
            env.option.setdefault("_filer_grpc_ports", {})[addr] = gport
    return addr


def _filer_grpc(addr: str, grpc_port: int = 0) -> str:
    host, _, port = addr.rpartition(":")
    return f"{host}:{grpc_port or int(port) + 10000}"  # +10000 convention


def _filer_stub(env: CommandEnv, opt_filer: str) -> Stub:
    addr = _filer_addr(env, opt_filer)
    gport = env.option.get("_filer_grpc_ports", {}).get(addr, 0)
    return Stub(_filer_grpc(addr, gport), FILER_SERVICE)


def _list_entries(stub: Stub, directory: str):
    for resp in stub.call_stream(
            "ListEntries", fpb.ListEntriesRequest(directory=directory),
            fpb.ListEntriesResponse):
        yield resp.entry


def _walk(stub: Stub, directory: str):
    """Depth-first (path, entry) walk of the filer namespace."""
    for e in _list_entries(stub, directory):
        path = (directory.rstrip("/") + "/" + e.name) \
            if directory != "/" else "/" + e.name
        yield path, e
        if e.is_directory:
            yield from _walk(stub, path)


def _fs_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("-filer", default="")
    return p


def _abs(env: CommandEnv, path: str) -> str:
    """Resolve a possibly-relative path against the shell cwd (fs.cd),
    normalizing '.' and '..' segments."""
    import posixpath
    if not path.startswith("/"):
        cwd = env.option.get("cwd", "/")
        path = cwd.rstrip("/") + "/" + path
    return posixpath.normpath(path)


@command("fs.ls", "list a filer directory")
def cmd_fs_ls(env: CommandEnv, args):
    p = _fs_parser("fs.ls")
    p.add_argument("-l", dest="long", action="store_true")
    p.add_argument("path", nargs="?", default="/")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    for e in _list_entries(stub, _abs(env, opt.path).rstrip("/") or "/"):
        if opt.long:
            kind = "d" if e.is_directory else "-"
            size = e.attributes.file_size
            env.println(f"{kind} {size:>12d} {e.name}")
        else:
            env.println(e.name + ("/" if e.is_directory else ""))


@command("fs.cat", "print a filer file's content")
def cmd_fs_cat(env: CommandEnv, args):
    from ..client import http_util

    p = _fs_parser("fs.cat")
    p.add_argument("path")
    opt = p.parse_args(args)
    addr = _filer_addr(env, opt.filer)
    r = http_util.get(f"http://{addr}{_abs(env, opt.path)}", timeout=60)
    if r.status != 200:
        env.println(f"error: HTTP {r.status}")
        return
    env.out.write(r.content.decode("utf-8", errors="replace"))


@command("fs.du", "disk usage of a filer subtree")
def cmd_fs_du(env: CommandEnv, args):
    p = _fs_parser("fs.du")
    p.add_argument("path", nargs="?", default="/")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    total_bytes = 0
    file_count = 0
    dir_count = 0
    for _path, e in _walk(stub, _abs(env, opt.path).rstrip("/") or "/"):
        if e.is_directory:
            dir_count += 1
        else:
            file_count += 1
            total_bytes += e.attributes.file_size
    env.println(f"{total_bytes} bytes, {file_count} files, "
                f"{dir_count} dirs under {opt.path}")


@command("fs.mkdir", "create a filer directory")
def cmd_fs_mkdir(env: CommandEnv, args):
    p = _fs_parser("fs.mkdir")
    p.add_argument("path")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    path = _abs(env, opt.path).rstrip("/")
    d, _, n = path.rpartition("/")
    req = fpb.CreateEntryRequest(directory=d or "/")
    req.entry.name = n
    req.entry.is_directory = True
    req.entry.attributes.file_mode = 0o755
    resp = stub.call("CreateEntry", req, fpb.CreateEntryResponse)
    env.println(resp.error or f"created {path}")


@command("fs.rm", "remove a filer file or directory")
def cmd_fs_rm(env: CommandEnv, args):
    p = _fs_parser("fs.rm")
    p.add_argument("-r", dest="recursive", action="store_true")
    p.add_argument("path")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    path = _abs(env, opt.path).rstrip("/")
    d, _, n = path.rpartition("/")
    resp = stub.call("DeleteEntry", fpb.DeleteEntryRequest(
        directory=d or "/", name=n, is_delete_data=True,
        is_recursive=opt.recursive), fpb.DeleteEntryResponse)
    env.println(resp.error or f"removed {path}")


@command("fs.verify", "read every chunk of every entry; report breakage")
def cmd_fs_verify(env: CommandEnv, args):
    """Reference command_fs_verify.go:54."""
    from ..client import http_util

    p = _fs_parser("fs.verify")
    p.add_argument("path", nargs="?", default="/")
    p.add_argument("-scrub", action="store_true",
                   help="additionally CRC-verify every volume's needles "
                        "through the device-batched kernel (volume.scrub)")
    p.add_argument("-device", choices=["auto", "on", "off"], default="auto")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    ok = bad = 0
    for path, e in _walk(stub, _abs(env, opt.path).rstrip("/") or "/"):
        if e.is_directory:
            continue
        for c in e.chunks:
            try:
                urls = env.mc.lookup_file_id(c.file_id)
                good = False
                for u in urls:
                    r = http_util.get(u, timeout=10)
                    if r.status == 200:
                        good = True
                        break
                if good:
                    ok += 1
                else:
                    bad += 1
                    env.println(f"BROKEN {path} chunk {c.file_id}")
            except Exception as ex:  # noqa: BLE001
                bad += 1
                env.println(f"BROKEN {path} chunk {c.file_id}: {ex}")
    env.println(f"verified {ok} chunks ok, {bad} broken")
    if opt.scrub:
        # HTTP reachability above proves the chunks serve; the scrub pass
        # proves the BYTES on disk still match their CRCs (bit rot)
        from .volume_commands import cmd_volume_scrub
        cmd_volume_scrub(env, ["-device", opt.device])


@command("volume.fsck", "cross-check filer chunk refs against volume needles")
def cmd_volume_fsck(env: CommandEnv, args):
    """Reference command_volume_fsck.go:81: finds filer references to
    missing needles, and (with -findOrphanData) needles no filer entry
    references."""
    from ..pb import volume_server_pb2 as vpb
    from ..utils.rpc import VOLUME_SERVICE

    p = _fs_parser("volume.fsck")
    p.add_argument("-findOrphanData", action="store_true")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    # collect all referenced (vid, key) pairs from the filer
    refs: dict[int, set[int]] = {}
    for _path, e in _walk(stub, "/"):
        for c in e.chunks:
            try:
                vid, key, _ = parse_file_id(c.file_id)
            except ValueError:
                continue
            refs.setdefault(vid, set()).add(key)
    missing = 0
    for vid, keys in sorted(refs.items()):
        locs = env.mc.lookup(vid)
        if not locs:
            env.println(f"volume {vid}: no locations "
                        f"({len(keys)} refs dangling)")
            missing += len(keys)
            continue
        addr = f"{locs[0]['url'].rsplit(':', 1)[0]}:{locs[0]['grpc_port']}"
        vstub = Stub(addr, VOLUME_SERVICE)
        for key in sorted(keys):
            try:
                vstub.call("VolumeNeedleStatus",
                           vpb.VolumeNeedleStatusRequest(
                               volume_id=vid, needle_id=key),
                           vpb.VolumeNeedleStatusResponse)
            except Exception:  # noqa: BLE001
                env.println(f"missing needle {vid},{key:x}")
                missing += 1
    env.println(f"fsck: {sum(len(k) for k in refs.values())} refs checked, "
                f"{missing} missing")
    if opt.findOrphanData:
        orphans = 0
        for srv in env.collect_volume_servers():
            for disk in srv["disks"].values():
                for v in disk.volume_infos:
                    have = refs.get(v.id, set())
                    if v.file_count > len(have):
                        orphans += v.file_count - len(have)
                        env.println(
                            f"volume {v.id} on {srv['id']}: "
                            f"{v.file_count - len(have)} orphan needles")
        env.println(f"fsck: ~{orphans} orphan needles")


@command("fs.configure",
         "[-locationPrefix /p] [-collection C] [-replication R] [-ttl T] "
         "[-disk ssd] [-fsync] [-delete] [-apply]: path-prefix storage rules "
         "(filer.conf)")
def cmd_fs_configure(env: CommandEnv, args):
    """Reference command_fs_configure.go: edit /etc/seaweedfs/filer.conf
    inside the filer; without -apply just prints the resulting rules."""
    from ..filer.filer_conf import (CONF_DIR, CONF_NAME, FilerConf, PathRule)

    p = _fs_parser("fs.configure")
    p.add_argument("-locationPrefix", default="")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")
    p.add_argument("-disk", default="")
    p.add_argument("-fsync", action="store_true")
    p.add_argument("-volumeGrowthCount", type=int, default=0)
    p.add_argument("-delete", action="store_true")
    p.add_argument("-apply", action="store_true")
    opt = p.parse_args(args)
    from ..client import http_util

    # the filer HTTP path reads/writes through chunked entries; a raw
    # gRPC LookupDirectoryEntry would miss chunked conf content
    base = f"http://{_filer_addr(env, opt.filer)}"
    r = http_util.get(f"{base}{CONF_DIR}/{CONF_NAME}", timeout=10)
    conf = FilerConf.from_bytes(r.content if r.status == 200 else b"")
    if opt.locationPrefix:
        if opt.delete:
            conf.delete(opt.locationPrefix)
        else:
            conf.upsert(PathRule(
                location_prefix=opt.locationPrefix,
                collection=opt.collection, replication=opt.replication,
                ttl=opt.ttl, disk_type=opt.disk, fsync=opt.fsync,
                volume_growth_count=opt.volumeGrowthCount))
    env.println(conf.to_bytes().decode())
    if opt.locationPrefix and opt.apply:
        r = http_util.post(f"{base}{CONF_DIR}/{CONF_NAME}",
                           body=conf.to_bytes(), timeout=10)
        if not r.ok:
            raise RuntimeError(f"HTTP {r.status} applying filer.conf")
        env.println("applied.")


@command("fs.mv", "move/rename a filer file or directory")
def cmd_fs_mv(env: CommandEnv, args):
    """Reference command_fs_mv.go (AtomicRenameEntry)."""
    p = _fs_parser("fs.mv")
    p.add_argument("src")
    p.add_argument("dst")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    src_path = _abs(env, opt.src)
    dst_path = _abs(env, opt.dst)
    sd, _, sn = src_path.rstrip("/").rpartition("/")
    dd, _, dn = dst_path.rstrip("/").rpartition("/")
    # mv into an existing directory keeps the source name (unix mv)
    try:
        t = stub.call("LookupDirectoryEntry",
                      fpb.LookupDirectoryEntryRequest(directory=dd or "/",
                                                      name=dn),
                      fpb.LookupDirectoryEntryResponse)
        if t.entry.is_directory:
            dd, dn = dst_path.rstrip("/"), sn
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (destination doesn't exist: plain rename)
        pass
    stub.call("AtomicRenameEntry", fpb.AtomicRenameEntryRequest(
        old_directory=sd or "/", old_name=sn,
        new_directory=dd or "/", new_name=dn),
        fpb.AtomicRenameEntryResponse)
    env.println(f"moved {src_path} -> {(dd or '/').rstrip('/')}/{dn}")


@command("fs.tree", "recursively print a filer subtree")
def cmd_fs_tree(env: CommandEnv, args):
    """Reference command_fs_tree.go."""
    p = _fs_parser("fs.tree")
    p.add_argument("path", nargs="?", default="/")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    root = _abs(env, opt.path).rstrip("/") or "/"
    env.println(root)
    files = dirs = 0
    for path, e in _walk(stub, root):
        depth = path[len(root):].count("/") if root != "/" else path.count("/")
        env.println("  " * depth + e.name + ("/" if e.is_directory else ""))
        if e.is_directory:
            dirs += 1
        else:
            files += 1
    env.println(f"{dirs} directories, {files} files")


@command("fs.meta.save", "[-o file] [path]: snapshot filer metadata to a "
         "local file")
def cmd_fs_meta_save(env: CommandEnv, args):
    """Reference command_fs_meta_save.go: length-prefixed FullEntry protos."""
    import struct as _struct

    p = _fs_parser("fs.meta.save")
    p.add_argument("-o", dest="output", default="filer-meta.bin")
    p.add_argument("path", nargs="?", default="/")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    n = 0
    with open(opt.output, "wb") as f:
        for path, e in _walk(stub, _abs(env, opt.path).rstrip("/") or "/"):
            d, _, _name = path.rpartition("/")
            fe = fpb.FullEntry(dir=d or "/", entry=e)
            blob = fe.SerializeToString()
            f.write(_struct.pack("<I", len(blob)) + blob)
            n += 1
    env.println(f"saved {n} entries to {opt.output}")


@command("fs.meta.load", "[-i file]: restore filer metadata from a snapshot")
def cmd_fs_meta_load(env: CommandEnv, args):
    """Reference command_fs_meta_load.go."""
    import struct as _struct

    p = _fs_parser("fs.meta.load")
    p.add_argument("-i", dest="input", default="filer-meta.bin")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    n = errors = 0
    with open(opt.input, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            (ln,) = _struct.unpack("<I", hdr)
            fe = fpb.FullEntry()
            fe.ParseFromString(f.read(ln))
            resp = stub.call("CreateEntry",
                             fpb.CreateEntryRequest(directory=fe.dir,
                                                    entry=fe.entry),
                             fpb.CreateEntryResponse)
            if resp.error:
                errors += 1
                env.println(f"  error restoring {fe.dir}/{fe.entry.name}: "
                            f"{resp.error}")
            else:
                n += 1
    env.println(f"loaded {n} entries from {opt.input}"
                + (f" ({errors} failed)" if errors else ""))


@command("fs.meta.cat", "print one entry's metadata as text")
def cmd_fs_meta_cat(env: CommandEnv, args):
    """Reference command_fs_meta_cat.go."""
    p = _fs_parser("fs.meta.cat")
    p.add_argument("path")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    d, _, n = _abs(env, opt.path).rstrip("/").rpartition("/")
    resp = stub.call("LookupDirectoryEntry",
                     fpb.LookupDirectoryEntryRequest(directory=d or "/",
                                                     name=n),
                     fpb.LookupDirectoryEntryResponse)
    env.println(str(resp.entry))


@command("fs.cd", "change the shell's working filer directory")
def cmd_fs_cd(env: CommandEnv, args):
    p = _fs_parser("fs.cd")
    p.add_argument("path", nargs="?", default="/")
    opt = p.parse_args(args)
    path = _abs(env, opt.path).rstrip("/") or "/"
    if path != "/":
        stub = _filer_stub(env, opt.filer)
        d, _, n = path.rpartition("/")
        resp = stub.call("LookupDirectoryEntry",
                         fpb.LookupDirectoryEntryRequest(directory=d or "/",
                                                         name=n),
                         fpb.LookupDirectoryEntryResponse)
        if not resp.entry.is_directory:
            env.println(f"not a directory: {path}")
            return
    env.option["cwd"] = path
    env.println(env.option["cwd"])


@command("fs.pwd", "print the shell's working filer directory")
def cmd_fs_pwd(env: CommandEnv, args):
    env.println(env.option.get("cwd", "/"))


@command("fs.log", "[-limit N] [-pathPrefix /p]: dump recent filer metadata "
         "events")
def cmd_fs_log(env: CommandEnv, args):
    """Reference command_fs_log.go (meta event tail, bounded)."""
    import threading as _threading

    p = _fs_parser("fs.log")
    p.add_argument("-limit", type=int, default=100)
    p.add_argument("-pathPrefix", default="/")
    opt = p.parse_args(args)
    import collections

    import grpc as _grpc

    stub = _filer_stub(env, opt.filer)
    stream = stub.call_stream(
        "SubscribeMetadata",
        fpb.SubscribeMetadataRequest(client_name="fs.log",
                                     path_prefix=opt.pathPrefix,
                                     since_ns=1),
        fpb.SubscribeMetadataResponse, timeout=5)
    tail: collections.deque = collections.deque(maxlen=opt.limit)
    try:
        for resp in stream:  # drain the backlog; keep the NEWEST N
            tail.append(resp)
    except _grpc.RpcError as e:
        if e.code() != _grpc.StatusCode.DEADLINE_EXCEEDED:
            env.println(f"error: {e.code().name}: {e.details()}")
            return
    for resp in tail:
        ev = resp.event_notification
        kind = ("delete" if not ev.new_entry.name
                else "create" if not ev.old_entry.name else "update")
        name = ev.new_entry.name or ev.old_entry.name
        env.println(f"{resp.ts_ns} {kind:7s} {resp.directory}/{name}")
    env.println(f"({len(tail)} events)")


# -- chunk-rewriting maintenance commands ---------------------------------

def _collect_volumes(env: CommandEnv) -> "tuple[dict, int]":
    """{vid: VolumeInformationMessage} (first replica wins) + size limit."""
    resp = env.mc.volume_list()
    limit = (resp.volume_size_limit_mb or 30_000) << 20
    vols: dict[int, object] = {}
    for dc in resp.topology_info.data_center_infos:
        for rack in dc.rack_infos:
            for node in rack.data_node_infos:
                for disk in node.disk_infos.values():
                    for v in disk.volume_infos:
                        vols.setdefault(v.id, v)
    return vols, limit


def _rewrite_chunks(env: CommandEnv, stub: Stub, directory: str,
                    rewrite_fn, move_data: bool) -> "tuple[int, int]":
    """Walk `directory`; for each file chunk, rewrite_fn(vid) -> new vid or
    None. With move_data the blob is copied into the new volume under the
    same key+cookie first (reference command_fs_merge_volumes.go moveChunk:
    only the volume id changes, so the fid stays unique and cacheable).
    Returns (chunks changed, failures)."""
    from ..client import operation

    changed_n = failed = 0
    for path, e in _walk(stub, directory):
        if e.is_directory or not e.chunks:
            continue
        if any(ch.is_chunk_manifest for ch in e.chunks):
            env.println(f"  {path}: manifest-chunked file not supported; "
                        "skipped")
            continue
        entry_changed = False
        for ch in e.chunks:
            vid, _, _ = parse_file_id(ch.file_id)
            to_vid = rewrite_fn(vid)
            if to_vid is None or to_vid == vid:
                continue
            to_fid = f"{to_vid},{ch.file_id.split(',', 1)[1]}"
            try:
                if move_data:
                    data = operation.read(env.mc, ch.file_id)
                    locs = env.mc.lookup(to_vid)
                    if not locs:
                        raise RuntimeError(f"volume {to_vid} has no location")
                    operation.upload(f"{locs[0]['url']}/{to_fid}", data,
                                     gzip_if_worthwhile=False,
                                     jwt=env.mc.lookup_file_id_jwt(to_fid))
                env.println(f"  {path}: {ch.file_id} -> {to_fid}")
                ch.file_id = to_fid
                entry_changed = True
                changed_n += 1
            except Exception as ex:  # noqa: BLE001 — keep sweeping
                failed += 1
                env.println(f"  failed {path} {ch.file_id}: {ex}")
        if entry_changed:
            d = path.rsplit("/", 1)[0] or "/"
            stub.call("UpdateEntry",
                      fpb.UpdateEntryRequest(directory=d, entry=e),
                      fpb.UpdateEntryResponse)
    return changed_n, failed


@command("fs.merge.volumes", "[-dir /] [-collection '*'] [-fromVolumeId x] "
         "[-toVolumeId y] [-apply]: re-locate chunks out of lighter volumes "
         "so vacuum can clear them", aliases=("fs.mergeVolumes",))
def cmd_fs_merge_volumes(env: CommandEnv, args):
    """Reference command_fs_merge_volumes.go: plan light->full merges among
    compatible volumes (same collection/ttl/replication, projected size
    within the limit), then rewrite chunk fids keeping key+cookie. The
    filer's replaced-chunk GC deletes the old needles, after which the
    light volumes are empty and vacuum/volume.delete.empty reclaims them."""
    p = _fs_parser("fs.merge.volumes")
    p.add_argument("-dir", default="/")
    p.add_argument("-collection", default="*")
    p.add_argument("-fromVolumeId", type=int, default=0)
    p.add_argument("-toVolumeId", type=int, default=0)
    p.add_argument("-apply", action="store_true")
    opt = p.parse_args(args)
    vols, limit = _collect_volumes(env)

    def live(vid: int) -> int:
        v = vols[vid]
        return max(0, v.size - v.deleted_byte_count)

    usable = sorted(
        (vid for vid, v in vols.items()
         if not v.read_only and live(vid) > 0
         and (opt.collection == "*" or v.collection == opt.collection)),
        key=live, reverse=True)
    plan: dict[int, int] = {}
    for i in range(len(usable) - 1, -1, -1):  # lightest volumes first
        src = usable[i]
        if opt.fromVolumeId and src != opt.fromVolumeId:
            continue
        if src in plan.values():
            # already chosen as a destination this sweep: draining it now
            # would re-move chunks it is about to receive, and the
            # projected-size math would undercount its incoming bytes
            continue
        for j in range(i):  # into the fullest compatible candidate
            cand = usable[j]
            if opt.toVolumeId and cand != opt.toVolumeId:
                continue
            if cand in plan:
                continue  # candidate is being drained as a source itself
            sv, cv = vols[src], vols[cand]
            if (sv.collection, sv.ttl, sv.replica_placement) != \
                    (cv.collection, cv.ttl, cv.replica_placement):
                continue
            projected = live(cand) + live(src) + sum(
                live(s) for s, d in plan.items() if d == cand)
            if projected > limit:
                continue
            plan[src] = cand
            break
    if not plan:
        env.println("no mergeable volumes")
        return
    for src, dst in sorted(plan.items()):
        env.println(f"volume {src} ({live(src) >> 20} MB) "
                    f"=> volume {dst} ({live(dst) >> 20} MB)")
    if not opt.apply:
        env.println("dry run; pass -apply to relocate chunks")
        return
    stub = _filer_stub(env, opt.filer)
    moved, failed = _rewrite_chunks(env, stub, _abs(env, opt.dir),
                                    plan.get, move_data=True)
    env.println(f"moved {moved} chunk(s), {failed} failure(s)")


@command("fs.meta.changeVolumeId", "-dir /path (-fromVolumeId x "
         "-toVolumeId y | -mapping file) [-force]: rewrite chunk volume ids "
         "in metadata")
def cmd_fs_meta_change_volume_id(env: CommandEnv, args):
    """Reference command_fs_meta_change_volume_id.go: metadata-only fixup
    after volumes were physically renumbered/migrated out of band — no
    blob data moves."""
    p = _fs_parser("fs.meta.changeVolumeId")
    p.add_argument("-dir", default="/")
    p.add_argument("-fromVolumeId", type=int, default=0)
    p.add_argument("-toVolumeId", type=int, default=0)
    p.add_argument("-mapping", default="",
                   help="file of lines 'x => y' (one change per line)")
    p.add_argument("-force", action="store_true")
    opt = p.parse_args(args)
    mapping: dict[int, int] = {}
    if opt.mapping:
        with open(opt.mapping) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, _, b = line.partition("=>")
                mapping[int(a.strip())] = int(b.strip())
    else:
        if not opt.fromVolumeId or not opt.toVolumeId:
            env.println("need -mapping or -fromVolumeId/-toVolumeId")
            return
        if opt.fromVolumeId == opt.toVolumeId:
            env.println("no volume id changes")
            return
        mapping[opt.fromVolumeId] = opt.toVolumeId
    stub = _filer_stub(env, opt.filer)
    if not opt.force:
        n = 0
        for path, e in _walk(stub, _abs(env, opt.dir)):
            for ch in e.chunks:
                vid, _, _ = parse_file_id(ch.file_id)
                if vid in mapping:
                    env.println(f"  would change {path}: {ch.file_id}")
                    n += 1
        env.println(f"dry run: {n} chunk(s); pass -force to apply")
        return
    changed, failed = _rewrite_chunks(env, stub, _abs(env, opt.dir),
                                      mapping.get, move_data=False)
    env.println(f"changed {changed} chunk(s), {failed} failure(s)")


@command("fs.log.purge", "[-daysAgo N]: drop filer meta-log events older "
         "than N days")
def cmd_fs_log_purge(env: CommandEnv, args):
    """Reference command_fs_log_purge.go (it deletes dated log files under
    /topics/.system/log; our filer compacts its meta log in place)."""
    import time as _time

    p = _fs_parser("fs.log.purge")
    p.add_argument("-daysAgo", type=float, default=365)
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    # destructive cutoff from the FILER's clock — shell-host skew must
    # not purge events the filer stamped moments ago
    conf = stub.call("GetFilerConfiguration",
                     fpb.GetFilerConfigurationRequest(),
                     fpb.GetFilerConfigurationResponse)
    now_ns = conf.now_ns or _time.time_ns()
    before = now_ns - int(opt.daysAgo * 86400 * 1e9)
    resp = stub.call(
        "PurgeMetaLog", fpb.PurgeMetaLogRequest(before_ns=before),
        fpb.PurgeMetaLogResponse)
    env.println(f"purged {resp.purged} meta-log event(s)")


@command("fs.meta.notify", "[-dir /path] -queue spec: replay directory tree "
         "metadata into a notification queue")
def cmd_fs_meta_notify(env: CommandEnv, args):
    """Reference command_fs_meta_notify.go: recursively send every entry
    as a new-entry EventNotification so a downstream replicator can
    bootstrap from existing state. Queue spec as in notification.toml
    ('memory' is useless here; use 'logfile:/path' or 'mq:host:port')."""
    from ..notification import open_queue

    p = _fs_parser("fs.meta.notify")
    p.add_argument("-dir", default="/")
    p.add_argument("-queue", default="",
                   help="notification spec; default from notification.toml")
    opt = p.parse_args(args)
    spec = opt.queue
    if not spec:
        from ..utils.config import load_config
        spec = (load_config("notification") or {}).get("queue", "")
    if not spec:
        env.println("no queue: pass -queue or configure notification.toml")
        return
    q = open_queue(spec)
    stub = _filer_stub(env, opt.filer)
    dirs = files = 0
    try:
        for path, e in _walk(stub, _abs(env, opt.dir)):
            q.send(path, fpb.EventNotification(new_entry=e))
            if e.is_directory:
                dirs += 1
            else:
                files += 1
    finally:
        q.close()
    env.println(f"notified {dirs} directories, {files} files")


# -- s3.* (the buckets, their quotas and multipart staging) -------------

@command("s3.bucket.list", "list buckets")
def cmd_s3_bucket_list(env: CommandEnv, args):
    p = _fs_parser("s3.bucket.list")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    try:
        for e in _list_entries(stub, BUCKETS_DIR):
            if e.is_directory and not e.name.startswith("."):
                env.println(e.name)
    except Exception:  # noqa: BLE001
        env.println("(no buckets)")


@command("s3.bucket.create", "create a bucket")
def cmd_s3_bucket_create(env: CommandEnv, args):
    p = _fs_parser("s3.bucket.create")
    p.add_argument("-name", required=True)
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    req = fpb.CreateEntryRequest(directory=BUCKETS_DIR)
    req.entry.name = opt.name
    req.entry.is_directory = True
    req.entry.attributes.file_mode = 0o755
    resp = stub.call("CreateEntry", req, fpb.CreateEntryResponse)
    env.println(resp.error or f"created bucket {opt.name}")


@command("s3.bucket.delete", "delete a bucket and its objects")
def cmd_s3_bucket_delete(env: CommandEnv, args):
    p = _fs_parser("s3.bucket.delete")
    p.add_argument("-name", required=True)
    opt = p.parse_args(args)
    env.confirm_is_locked()
    stub = _filer_stub(env, opt.filer)
    resp = stub.call("DeleteEntry", fpb.DeleteEntryRequest(
        directory=BUCKETS_DIR, name=opt.name, is_delete_data=True,
        is_recursive=True), fpb.DeleteEntryResponse)
    env.println(resp.error or f"deleted bucket {opt.name}")


@command("s3.bucket.quota", "-bucket B [-sizeMB N | -remove]: set or clear "
         "a bucket size quota")
def cmd_s3_bucket_quota(env: CommandEnv, args):
    """Reference command_s3_bucket_quota.go: quota rides the bucket entry's
    extended attributes."""
    p = _fs_parser("s3.bucket.quota")
    p.add_argument("-bucket", required=True)
    p.add_argument("-sizeMB", type=int, default=0)
    p.add_argument("-remove", action="store_true")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    resp = stub.call("LookupDirectoryEntry",
                     fpb.LookupDirectoryEntryRequest(directory=BUCKETS_DIR,
                                                     name=opt.bucket),
                     fpb.LookupDirectoryEntryResponse)
    entry = fpb.Entry()
    entry.CopyFrom(resp.entry)
    if opt.remove:
        entry.extended.pop("quota_mb", None)
        entry.extended.pop("quota_readonly", None)
    else:
        entry.extended["quota_mb"] = str(opt.sizeMB).encode()
    stub.call("CreateEntry",
              fpb.CreateEntryRequest(directory=BUCKETS_DIR, entry=entry),
              fpb.CreateEntryResponse)
    env.println(f"bucket {opt.bucket} quota "
                + ("removed" if opt.remove else f"{opt.sizeMB} MB"))


@command("s3.bucket.quota.check", "enforce bucket quotas: over-quota buckets "
         "become read-only", aliases=("s3.bucket.quota.enforce",))
def cmd_s3_bucket_quota_check(env: CommandEnv, args):
    """Reference command_s3_bucket_quota_check.go."""
    opt = _fs_parser("s3.bucket.quota.check").parse_args(args)
    stub = _filer_stub(env, opt.filer)
    for e in _list_entries(stub, BUCKETS_DIR):
        if not e.is_directory:
            continue
        quota_mb = int(e.extended.get("quota_mb", b"0") or b"0")
        if not quota_mb:
            continue
        used = sum(x.attributes.file_size
                   for _p, x in _walk(stub, f"{BUCKETS_DIR}/{e.name}")
                   if not x.is_directory)
        over = used > quota_mb << 20
        was = e.extended.get("quota_readonly") == b"1"
        if over != was:
            upd = fpb.Entry()
            upd.CopyFrom(e)
            if over:
                upd.extended["quota_readonly"] = b"1"
            else:
                upd.extended.pop("quota_readonly", None)
            stub.call("CreateEntry",
                      fpb.CreateEntryRequest(directory=BUCKETS_DIR,
                                             entry=upd),
                      fpb.CreateEntryResponse)
        env.println(f"  {e.name}: {used >> 20} / {quota_mb} MB"
                    + (" READONLY" if over else ""))
    env.println("quota check done")


@command("s3.clean.uploads", "[-timeAgo 24h]: purge stale multipart upload "
         "staging")
def cmd_s3_clean_uploads(env: CommandEnv, args):
    """Reference command_s3_clean_uploads.go: multipart staging lives under
    /buckets/<b>/.uploads/<id>; abandoned ids older than -timeAgo go."""
    import time as _time

    from ..storage.types import TTL

    p = _fs_parser("s3.clean.uploads")
    p.add_argument("-timeAgo", default="24h")
    opt = p.parse_args(args)
    stub = _filer_stub(env, opt.filer)
    cutoff = _time.time() - TTL.parse(opt.timeAgo).seconds  # swtpu-lint: disable=wallclock-duration (compared to persisted mtime)
    removed = 0
    for b in _list_entries(stub, BUCKETS_DIR):
        if not b.is_directory:
            continue
        updir = f"{BUCKETS_DIR}/{b.name}/.uploads"
        for u in _list_entries(stub, updir):
            if (u.attributes.mtime or u.attributes.crtime) < cutoff:
                stub.call("DeleteEntry",
                          fpb.DeleteEntryRequest(directory=updir,
                                                 name=u.name,
                                                 is_delete_data=True,
                                                 is_recursive=True),
                          fpb.DeleteEntryResponse)
                removed += 1
                env.println(f"  removed {updir}/{u.name}")
    env.println(f"cleaned {removed} stale uploads")


# -- s3 cluster configuration (stored in the filer, hot-reloaded) ---------

IAM_DIR, IAM_FILE = "/etc/iam", "identity.json"
CB_DIR, CB_FILE = "/etc/s3", "circuit_breaker.json"


def _read_filer_json(env: CommandEnv, opt_filer: str, d: str, n: str) -> dict:
    import json

    from ..client.filer_client import FilerClient
    fc = FilerClient(_filer_addr(env, opt_filer))
    try:
        entry = fc.filer.find_entry(d, n)
        if entry is None:
            return {}
        return json.loads(fc.read_entry_bytes(entry) or b"{}")
    finally:
        fc.close()


def _write_filer_json(env: CommandEnv, opt_filer: str, d: str, n: str,
                      obj: dict) -> None:
    import json

    from ..client.filer_client import FilerClient
    fc = FilerClient(_filer_addr(env, opt_filer))
    try:
        fc.write_file(f"{d}/{n}", json.dumps(obj, indent=2).encode(),
                      mime="application/json")
    finally:
        fc.close()


@command("s3.configure", "[-user u] [-access_key ak -secret_key sk] "
         "[-actions Read,Write[:bucket]] [-buckets b1,b2] [-delete] "
         "[-apply]: manage S3 identities stored in the filer")
def cmd_s3_configure(env: CommandEnv, args):
    """Reference command_s3_configure.go: edits /etc/iam/identity.json in
    the filer; running S3 gateways hot-reload it (standalone s3 verb
    subscribes to /etc). Without -apply, prints the resulting config."""
    import json

    p = _fs_parser("s3.configure")
    p.add_argument("-user", default="")
    p.add_argument("-access_key", default="")
    p.add_argument("-secret_key", default="")
    p.add_argument("-actions", default="",
                   help="comma list: Read,Write,List,Tagging,Admin, "
                        "optionally scoped Action:bucket")
    p.add_argument("-buckets", default="",
                   help="scope every -actions entry to these buckets")
    p.add_argument("-delete", action="store_true")
    p.add_argument("-apply", action="store_true")
    opt = p.parse_args(args)
    conf = _read_filer_json(env, opt.filer, IAM_DIR, IAM_FILE)
    idents = conf.setdefault("identities", [])
    if opt.user:
        ident = next((i for i in idents if i.get("name") == opt.user), None)
        if opt.delete:
            if ident is None:
                env.println(f"user {opt.user!r} not found")
                return
            idents.remove(ident)
        else:
            if ident is None:
                ident = {"name": opt.user, "credentials": [], "actions": []}
                idents.append(ident)
            if opt.access_key:
                ident.setdefault("credentials", [])
                cred = {"accessKey": opt.access_key,
                        "secretKey": opt.secret_key}
                ident["credentials"] = [
                    c for c in ident["credentials"]
                    if c.get("accessKey") != opt.access_key] + [cred]
            if opt.actions:
                actions = [a.strip() for a in opt.actions.split(",")
                           if a.strip()]
                if opt.buckets:
                    actions = [f"{a}:{b.strip()}"
                               for a in actions
                               for b in opt.buckets.split(",") if b.strip()]
                ident["actions"] = sorted(set(ident.get("actions", []))
                                          | set(actions))
    env.println(json.dumps(conf, indent=2))
    if not opt.apply:
        env.println("dry run; pass -apply to save")
        return
    _write_filer_json(env, opt.filer, IAM_DIR, IAM_FILE, conf)
    env.println(f"saved {IAM_DIR}/{IAM_FILE}")


@command("s3.circuitbreaker", "[-global] [-buckets b1,b2] "
         "[-actions Read,Write] [-countLimit N] [-disable] [-apply]: "
         "manage the S3 concurrent-request breaker config")
def cmd_s3_circuitbreaker(env: CommandEnv, args):
    """Reference command_s3_circuitbreaker.go: edits
    /etc/s3/circuit_breaker.json in the filer; gateways hot-reload it.
    Limits are concurrent in-flight requests per action; exceeding one
    returns 503 SlowDown (s3/circuit_breaker.py)."""
    import json

    p = _fs_parser("s3.circuitbreaker")
    p.add_argument("-global", dest="global_", action="store_true",
                   help="apply -countLimit to the global scope")
    p.add_argument("-buckets", default="",
                   help="apply -countLimit to these buckets")
    p.add_argument("-actions", default="Read,Write",
                   help="actions to limit (Read,Write,List,Admin)")
    p.add_argument("-countLimit", type=int, default=0)
    p.add_argument("-disable", action="store_true",
                   help="remove the selected limits")
    p.add_argument("-apply", action="store_true")
    opt = p.parse_args(args)
    conf = _read_filer_json(env, opt.filer, CB_DIR, CB_FILE)
    actions = [a.strip() for a in opt.actions.split(",") if a.strip()]
    if opt.global_:
        g = conf.setdefault("global", {})
        for a in actions:
            if opt.disable:
                g.pop(a, None)
            elif opt.countLimit:
                g[a] = opt.countLimit
    for b in [b.strip() for b in opt.buckets.split(",") if b.strip()]:
        bl = conf.setdefault("buckets", {}).setdefault(b, {})
        for a in actions:
            if opt.disable:
                bl.pop(a, None)
            elif opt.countLimit:
                bl[a] = opt.countLimit
    # prune empty scopes so 'disabled' really disables
    conf["buckets"] = {b: v for b, v in (conf.get("buckets") or {}).items()
                       if v}
    if not conf.get("buckets"):
        conf.pop("buckets", None)
    if not conf.get("global"):
        conf.pop("global", None)
    env.println(json.dumps(conf, indent=2) if conf else "(breaker disabled)")
    if not opt.apply:
        env.println("dry run; pass -apply to save")
        return
    _write_filer_json(env, opt.filer, CB_DIR, CB_FILE, conf)
    env.println(f"saved {CB_DIR}/{CB_FILE}")
