"""Command line of the port: ``python -m seaweedfs_tpu_torch <verb> ...``.

Verbs, the counterparts of the JAX package's (seaweedfs_tpu/__main__.py):

* ``master`` (`run_master`, :162, with `_add_master_flags`, :25): the
  master server, its HTTP API with `-httpPort`, the health engine and the
  admin cron; `-peers` with more than one master and `-raftDir` run a raft
  quorum, `-sloPolicy` and `-telemetryIntervalS` the leader's fleet
  telemetry, `-lifecyclePolicy` the lifecycle plane in the cron.
* ``volume`` (`run_volume` with `_add_volume_flags`, :115, :203): a volume
  server that serves HTTP and gRPC and heartbeats to `-mserver`. It runs
  on the card unless `-device cpu` is asked for, and exits non-zero on a
  host without one. `-qosPolicy` (a JSON file, reloaded when it changes)
  turns on QoS admission.
* ``server`` (`run_server`, :224): a master and one volume server in one
  process, the volume server on the card unless `-device cpu`; `-filer`
  adds a filer on `-filerPort` over a sqlite store in `-dir`/filer, and
  `-s3`/`-iam` the S3 gateway on `-s3Port` and the IAM API on `-iamPort`
  over it (each implies the filer), and `-webdav` the WebDAV gateway on
  `-webdavPort`.
* ``shell`` (`run_shell`, :291): the admin shell over the ported command
  tables (shell/commands.py, ec_commands.py, volume_commands.py,
  fs_commands.py, lifecycle_commands.py, mq_commands.py, qos_commands.py,
  remote_commands.py, telemetry_commands.py); `-c` runs semicolon-separated
  lines and exits non-zero when one fails.
* ``filer`` (`run_filer`, :352): the filer daemon (HTTP on the port's
  fastweb, gRPC, the meta log, the peer mesh unless `-noPeerMeta`); it
  loads no torch. ``filer.copy``, ``filer.cat``, ``filer.meta.tail`` and
  ``filer.meta.backup`` (:679, :959, :720, :981) are its clients; the
  tail flushes each line as it prints it. `-s3 -s3Port` embeds the S3
  gateway (:376-420) and `-iam -iamPort` the IAM API, a port-only flag.
  An embedded gateway loads identities, the circuit breaker and the QoS
  policy from the filer's /etc and reloads them when /etc changes, as the
  standalone ``s3`` verb does; the reference's embedded gateway runs open.
* ``s3`` (`run_s3`, :422): the standalone S3 gateway over a remote filer
  (`-filer -ip -port -config`). ``iam`` (`run_iam`, :605): the standalone
  IAM API over a remote filer. ``webdav`` (`run_webdav_standalone`,
  :496): the WebDAV gateway over a remote filer (`-filer -ip -port`).
  None loads torch.
* ``filer.backup`` (`run_filer_backup`, :556): mirrors a filer subtree into
  a local directory through the replication plane's LocalSink, resuming
  from the offset kept in the source filer's kv. ``filer.sync``
  (`run_filer_sync`, :618): FilerSync from `-a` to `-b`, and back unless
  `-isActivePassive`, its offsets in the target's store. ``geo.sync``
  (`run_geo_sync`, :639): the same through GeoSync (its own offsets,
  maintenance-class applies, the lag gauge and `-lagBound`). Each runs
  until SIGINT or SIGTERM; none loads torch.
* ``filer.replicate`` (`run_filer_replicate`, :1074): a `logfile:`
  notification queue (written by the filer or `fs.meta.notify`) applied
  through a replication sink (`-sink local:|filer:|s3:|azure:|gcs-json:`),
  resuming from `<queue>.offset`. ``mq.broker`` (`run_mq_broker`, :942):
  the message-queue broker, standalone on a local segment directory
  (`-dir`). Both end on SIGINT or SIGTERM, the broker after flushing its
  partitions' tails; neither loads torch.
* ``filer.remote.sync`` and ``filer.remote.gateway``
  (`run_filer_remote_sync`, :1126; `run_filer_remote_gateway`, :1177):
  local changes under remote mounts written back to their remotes, and
  buckets under /buckets made and removed on a remote too. ``ftp``
  (`run_ftp`, :1237): the FTP gateway over a filer. Each ends on SIGINT or
  SIGTERM with rc 0 (the reference's on SIGINT alone); none loads torch.
* ``mount`` and ``fuse`` (`run_mount`, :902; `run_fuse`, :1273): a kernel
  FUSE mount of a filer through the ctypes libfuse binding, with the
  control socket `shell mount.configure` dials.
* ``scaffold`` (:802) prints a config template; ``update`` (:1262) says
  how to update a source checkout and downloads nothing;
  ``autocomplete`` and ``unautocomplete`` (:1293, :1311) add and remove a
  bash completion line in ~/.bashrc.
* ``upload`` and ``download`` (`run_upload`, :827; `run_download`, :855):
  blobs through client/operation's submit and read.
* ``benchmark`` (:889): `weed benchmark`, bench_tool.run.
* ``backup`` (:330): client/backup.backup_volume of one volume into a
  local directory, full the first time, incremental after.
* ``master.follow`` (:509): a lookup-only master follower over the
  leader's KeepConnected stream.
* ``export``, ``compact`` and ``fix`` (:747, :779, :876): offline tools
  over one volume's files (its needles to files, vacuum in place, the
  `.idx` rebuilt from the `.dat`).
* ``version`` (:797): the reference's line with the port's package name,
  ``seaweedfs-tpu-torch 0.4.0``; `__version__` is the reference's.

`-jwtSigningKey`, `-jwtReadSigningKey` and `-whiteList` build a daemon's
security guard (reference `_add_security_flags` and `_make_guard`,
:87-114): flags win, and an absent flag falls back to security.toml on the
config tier chain (utils/config). The `[grpc]` section of that file (ca,
cert, key) puts every gRPC server and stub of the process under mTLS
before any starts (reference `_init_tls`, :1366); a partial section
refuses to start.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def _parse_ec_shards(spec: str) -> "tuple[int, int]":
    """'d,p' -> (d, p)."""
    try:
        d_s, p_s = spec.split(",")
        d, p = int(d_s), int(p_s)
    except ValueError:
        raise ValueError(f"-ecShards wants 'd,p' (e.g. 10,4), got {spec!r}"
                         ) from None
    if d <= 0 or p <= 0 or d + p > 256:
        raise ValueError(f"invalid RS geometry ({d},{p})")
    return d, p


def _master_flags(p: argparse.ArgumentParser) -> None:
    """The reference's `_add_master_flags`, flag for flag."""
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-httpPort", type=int, default=0,
                   help="HTTP status/metrics API port (0 = off)")
    p.add_argument("-volumeSizeLimitMB", type=int, default=30_000)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-peers", default="",
                   help="comma-separated master quorum incl. self "
                        "(enables raft leader election)")
    p.add_argument("-raftDir", default="",
                   help="directory for persistent raft state")
    p.add_argument("-maintenanceScripts", default="default",
                   help="semicolon-separated shell lines the master cron runs "
                        "(reference master.toml scripts); 'default' = "
                        "fix.replication/ec.rebuild/ec.balance/volume.balance, "
                        "'' disables")
    p.add_argument("-maintenanceIntervalS", type=float, default=0,
                   help="cron interval seconds (0 = reference default 17 min)")
    p.add_argument("-maintenanceHealthDriven", default="on",
                   choices=["on", "off"],
                   help="on (default): cron sweeps repair from the health "
                        "plane's report, most-at-risk first under the "
                        "admission budget; off: the script list")
    p.add_argument("-maintenanceMaxConcurrentRepairs", type=int, default=2,
                   help="repairs in flight per health-driven sweep")
    p.add_argument("-ecParityShards", type=int, default=0,
                   help="parity shard count of the cluster's EC geometry, "
                        "used by the health engine to derive k = n - parity "
                        "(0 = fork default 2)")
    p.add_argument("-ecShards", default="",
                   help="cluster EC geometry as 'd,p' (e.g. 14,2 or 10,4); "
                        "the p half feeds the health engine like "
                        "-ecParityShards")
    p.add_argument("-lifecyclePolicy", default="",
                   help="tiered-storage lifecycle policy JSON file; wires "
                        "lifecycle.apply into the maintenance cron "
                        "(status: /debug/lifecycle)")
    p.add_argument("-sloPolicy", default="",
                   help="SLO policy: JSON file path or inline JSON doc; the "
                        "leader's telemetry collector evaluates burn-rate "
                        "alerts from it (status: /cluster/telemetry)")
    p.add_argument("-telemetryIntervalS", type=float, default=0,
                   help="fleet telemetry scrape interval seconds; 0 uses "
                        "SWTPU_TELEMETRY_INTERVAL_S (default 15), "
                        "negative disables the collector")
    p.add_argument("-linkCosts", default="",
                   help="geo link-cost policy: JSON file path or inline "
                        "JSON doc; served at /cluster/linkcosts")
    _security_flags(p)


def _security_flags(p: argparse.ArgumentParser) -> None:
    # empty keys keep security off, as in the reference's default
    p.add_argument("-jwtSigningKey", default="")
    p.add_argument("-jwtReadSigningKey", default="")
    p.add_argument("-whiteList", default="",
                   help="comma-separated IPs/CIDRs allowed without jwt")


def _ec_parity(opt) -> "int | None":
    """-ecShards d,p wins over the older -ecParityShards spelling."""
    if opt.ecShards:
        return _parse_ec_shards(opt.ecShards)[1]
    return opt.ecParityShards or None


def _volume_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-grpcPort", type=int, default=0,
                   help="gRPC port (default: -port + 10000)")
    p.add_argument("-mserver", default="127.0.0.1:9333",
                   help="master address(es), comma-separated")
    p.add_argument("-dir", default="./data")
    p.add_argument("-max", type=int, default=8)
    p.add_argument("-dataCenter", default="")
    p.add_argument("-rack", default="")
    p.add_argument("-disk", default="hdd")
    p.add_argument("-coder", default="torch", choices=("torch", "native"),
                   help="erasure coder backend: torch (kernel K1 on the "
                        "device) or native (the AVX2 host coder)")
    p.add_argument("-device", default="cuda", choices=("cuda", "cpu"),
                   help="device of the torch coder and the scrub")
    p.add_argument("-codec", default="rs",
                   help="erasure codec for new encodes: rs | piggyback | msr")
    p.add_argument("-ecShards", default="",
                   help="default EC geometry as 'd,p' (e.g. 14,2 or 10,4)")
    p.add_argument("-index", default="memory",
                   help="needle map kind: memory|leveldb|sorted_file "
                        "(reference -index flag)")
    p.add_argument("-pulseSeconds", type=float, default=2.0)
    p.add_argument("-qosPolicy", default="",
                   help="QoS policy JSON file (tenant/class token buckets, "
                        "weights), reloaded when it changes; empty = "
                        "admission off")
    _security_flags(p)


def _make_guard(opt):
    """The security guard, or None when nothing configures one: flags win;
    absent flags fall back to security.toml on the config tier chain
    (reference util/config.go:37-48 with the security/jwt wiring)."""
    from .security import Guard
    from .utils import config as cfg
    sec = cfg.load_config("security")
    sign = opt.jwtSigningKey or cfg.get_dotted(
        sec, "jwt.signing.key", "") or ""
    read = opt.jwtReadSigningKey or cfg.get_dotted(
        sec, "jwt.signing.read.key", "") or ""
    wl = opt.whiteList or cfg.get_dotted(sec, "guard.white_list", "") or ""
    if isinstance(wl, list):
        wl = ",".join(wl)
    if not (sign or read or wl):
        return None
    return Guard(white_list=[s for s in wl.split(",") if s],
                 signing_key=sign, read_signing_key=read)


def _init_tls() -> None:
    """Install cluster mTLS from security.toml [grpc] before any server or
    stub starts; a configured but unusable section exits non-zero (fail
    closed, never plaintext)."""
    try:
        from .utils.rpc import load_tls_from_security_toml, set_tls_config
        tls = load_tls_from_security_toml()
    except Exception as e:  # noqa: BLE001 — fail closed
        print(f"fatal: mTLS configured but unusable: {e}", file=sys.stderr)
        sys.exit(1)
    if tls is not None:
        set_tls_config(tls)
        print("gRPC mTLS enabled (security.toml [grpc])", file=sys.stderr)


def _signals() -> threading.Event:
    """An event SIGINT or SIGTERM sets; caught from now on, so a daemon
    stopped while it starts still stops cleanly."""
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    return done


def _wait_for_signal() -> None:
    _signals().wait()


def _master_server(opt, **kw):
    """A MasterServer from master flags; an option the constructor
    rejects (a malformed SLO policy, link costs) exits with its message.
    `-raftDir` keeps this master's raft state in raft-<port>.json there."""
    import os

    from .master.master_server import MasterServer
    raft_state = None
    if opt.raftDir:
        os.makedirs(opt.raftDir, exist_ok=True)
        raft_state = os.path.join(opt.raftDir, f"raft-{opt.port}.json")
    try:
        return MasterServer(
            ip=opt.ip, port=opt.port,
            volume_size_limit_mb=opt.volumeSizeLimitMB,
            default_replication=opt.defaultReplication,
            guard=_make_guard(opt), http_port=opt.httpPort or None,
            peers=[p for p in opt.peers.split(",") if p],
            raft_state_path=raft_state,
            ec_parity_shards=_ec_parity(opt),
            lifecycle_policy=opt.lifecyclePolicy,
            slo_policy=opt.sloPolicy, link_costs=opt.linkCosts,
            telemetry_interval_s=opt.telemetryIntervalS or None, **kw)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)


def run_master(argv) -> int:
    from .utils import config as cfg

    p = argparse.ArgumentParser(prog="master")
    _master_flags(p)
    opt = p.parse_args(argv)
    mconf = cfg.load_config("master")
    if opt.maintenanceScripts == "default":
        toml_scripts = cfg.get_dotted(mconf, "master.maintenance.scripts", "")
        scripts = ([ln.strip() for ln in toml_scripts.splitlines()
                    if ln.strip()] if toml_scripts else None)
    else:
        scripts = [s for s in opt.maintenanceScripts.split(";") if s.strip()]
    if not opt.maintenanceIntervalS:
        mins = cfg.get_dotted(mconf, "master.maintenance.sleep_minutes", 0)
        opt.maintenanceIntervalS = float(mins) * 60 if mins else 0
    ms = _master_server(
        opt, maintenance_scripts=scripts,
        maintenance_interval_s=opt.maintenanceIntervalS or None,
        maintenance_health_driven=opt.maintenanceHealthDriven == "on")
    ms.admin_cron.repair_max_concurrent = opt.maintenanceMaxConcurrentRepairs
    ms.start()
    print(f"master {ms.address} up (http :{opt.httpPort or '-'})",
          flush=True)
    _wait_for_signal()
    ms.stop()
    return 0


def _serve_volume_server(opt, port: int, master: str, grpc_port: int = 0,
                         disk: str = "hdd", index: str = "memory",
                         data_center: str = "", rack: str = "",
                         pulse_seconds: float = 2.0, qos_policy: str = ""):
    """A volume server on the card (or `-device cpu`) over one directory,
    served over gRPC and heartbeating to `master`."""
    from .ec.locate import EcGeometry
    from .ops.coder import resolve_device
    from .server.grpc_service import serve_volume
    from .server.volume_server import VolumeServer
    from .storage.disk_location import DiskLocation
    from .storage.store import Store

    resolve_device(opt.device)  # no card and no -device cpu: refuse
    geo = EcGeometry(*_parse_ec_shards(opt.ecShards)) if opt.ecShards else None
    store = Store(opt.ip, port, f"{opt.ip}:{port}",
                  [DiskLocation(opt.dir, disk, opt.max,
                                needle_map_kind=index)],
                  ec_geometry=geo, coder_name=opt.coder, ec_codec=opt.codec,
                  device=opt.device)
    vs = VolumeServer(store, ip=opt.ip, port=port, data_center=data_center,
                      rack=rack, pulse_seconds=pulse_seconds,
                      guard=_make_guard(opt), qos_policy=qos_policy or None)
    served = serve_volume(vs, grpc_port, master=master)
    print(f"volume server {vs.url} (grpc :{vs.grpc_port}, {vs.device}) "
          f"heartbeating to {master}", flush=True)
    return served


def run_volume(argv) -> int:
    p = argparse.ArgumentParser(prog="volume")
    _volume_flags(p)
    opt = p.parse_args(argv)
    served = _serve_volume_server(
        opt, opt.port, opt.mserver, grpc_port=opt.grpcPort, disk=opt.disk,
        index=opt.index, data_center=opt.dataCenter, rack=opt.rack,
        pulse_seconds=opt.pulseSeconds, qos_policy=opt.qosPolicy)
    _wait_for_signal()
    served.stop()
    return 0


def run_server(argv) -> int:
    """A master and one volume server in one process (reference
    command/server.go:176)."""
    p = argparse.ArgumentParser(prog="server")
    _master_flags(p)
    p.add_argument("-volumePort", type=int, default=8080)
    p.add_argument("-dir", default="./data")
    p.add_argument("-max", type=int, default=8)
    p.add_argument("-coder", default="torch", choices=("torch", "native"))
    p.add_argument("-device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("-codec", default="rs",
                   help="erasure codec for new encodes: rs | piggyback | msr")
    p.add_argument("-filer", action="store_true")
    p.add_argument("-filerPort", type=int, default=8888)
    p.add_argument("-s3", action="store_true")
    p.add_argument("-s3Port", type=int, default=8333)
    p.add_argument("-webdav", action="store_true")
    p.add_argument("-webdavPort", type=int, default=7333)
    p.add_argument("-iam", action="store_true")
    p.add_argument("-iamPort", type=int, default=8111)
    opt = p.parse_args(argv)
    import os

    stopped = _signals()
    ms = _master_server(opt)
    ms.start()
    fs = wd = None
    stop_gateways = None
    try:
        served = _serve_volume_server(opt, opt.volumePort,
                                      f"{opt.ip}:{opt.port}")
        if opt.filer or opt.s3 or opt.iam or opt.webdav:
            filer_dir = os.path.join(opt.dir, "filer")
            os.makedirs(filer_dir, exist_ok=True)
            fs = _filer_server(opt, f"{opt.ip}:{opt.port}",
                               f"sqlite:{filer_dir}/filer.db",
                               os.path.join(filer_dir, "meta.log"),
                               port=opt.filerPort)
            print(f"filer {fs.url} (grpc :{fs.grpc_port})", flush=True)
            stop_gateways = _embedded_gateways(opt, fs, opt.s3Port,
                                               opt.iamPort)
            if opt.webdav:
                from .webdav import WebDavServer
                wd = _started(WebDavServer(fs, ip=opt.ip,
                                           port=opt.webdavPort), "webdav")
                print(f"webdav {wd.url} over filer {fs.url}", flush=True)
    except BaseException:
        ms.stop()
        raise
    stopped.wait()
    if wd is not None:
        wd.stop()
    if stop_gateways is not None:
        stop_gateways()
    if fs is not None:
        fs.stop()
    served.stop()
    ms.stop()
    return 0


def run_shell(argv) -> int:
    from .shell import (ec_commands, fs_commands,  # noqa: F401
                        lifecycle_commands, mq_commands, qos_commands,
                        remote_commands, telemetry_commands,
                        volume_commands)
    from .shell.commands import CommandEnv, repl, run_command

    p = argparse.ArgumentParser(prog="shell")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-filer", default="",
                   help="default filer host:port for fs.* commands")
    p.add_argument("-jwtSigningKey", default="",
                   help="cluster signing key for gRPC auth")
    p.add_argument("-c", dest="script", default="",
                   help="run semicolon-separated commands and exit")
    opt = p.parse_args(argv)
    if opt.jwtSigningKey:
        from .utils.rpc import set_cluster_key
        set_cluster_key(opt.jwtSigningKey)
    env = CommandEnv(opt.master)
    if opt.filer:
        env.option["filer"] = opt.filer
    if not opt.script:
        repl(env)
        return 0
    # scripted mode: a failing command is a non-zero exit, as in the
    # reference, not a printed-and-swallowed error as in the REPL
    try:
        for line in opt.script.split(";"):
            if not run_command(env, line):
                break
    except Exception as e:  # noqa: BLE001
        print(f"error: {e}", file=sys.stderr)
        env.release_lock()
        return 2
    env.release_lock()
    return 0


def run_upload(argv) -> int:
    import json
    import mimetypes
    import os

    from .client import operation
    from .client.master_client import MasterClient
    p = argparse.ArgumentParser(prog="upload")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-jwtSigningKey", default="")
    p.add_argument("files", nargs="+")
    opt = p.parse_args(argv)
    if opt.jwtSigningKey:
        from .utils.rpc import set_cluster_key
        set_cluster_key(opt.jwtSigningKey)
    mc = MasterClient(opt.master)
    for path in opt.files:
        with open(path, "rb") as f:
            data = f.read()
        mime = mimetypes.guess_type(path)[0] or ""
        res = operation.submit(mc, data, name=os.path.basename(path),
                               mime=mime, collection=opt.collection,
                               replication=opt.replication)
        print(json.dumps({"file": path, "fid": res.fid, "size": res.size,
                          "url": f"{res.url}/{res.fid}"}))
    return 0


def run_download(argv) -> int:
    from .client import operation
    from .client.master_client import MasterClient
    p = argparse.ArgumentParser(prog="download")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-o", dest="output", default="")
    p.add_argument("-jwtSigningKey", default="")
    p.add_argument("fids", nargs="+")
    opt = p.parse_args(argv)
    if opt.jwtSigningKey:
        from .utils.rpc import set_cluster_key
        set_cluster_key(opt.jwtSigningKey)
    mc = MasterClient(opt.master)
    for fid in opt.fids:
        data = operation.read(mc, fid)
        out = opt.output or fid.replace(",", "_")
        with open(out, "wb") as f:
            f.write(data)
        print(f"{fid} -> {out} ({len(data)} bytes)")
    return 0


def run_benchmark(argv) -> int:
    from .bench_tool import run as bench_run
    bench_run(argv)
    return 0


def run_backup(argv) -> int:
    """Incrementally back up a volume to a local directory (reference
    command/backup.go)."""
    from .client.backup import backup_volume
    from .client.master_client import MasterClient
    p = argparse.ArgumentParser(prog="backup")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    opt = p.parse_args(argv)
    mc = MasterClient(opt.master).start()
    try:
        mc.wait_connected()
        res = backup_volume(mc, opt.volumeId, opt.dir, opt.collection)
        print(f"backup volume {res['volume_id']}: {res['mode']}, "
              f"{res['records_applied']} records applied, "
              f"{res['size']} bytes")
    finally:
        mc.stop()
    return 0


def run_master_follow(argv) -> int:
    """Read-only master follower (reference command/master_follower.go):
    keeps the leader's vid map through the KeepConnected stream and answers
    LookupVolume locally, without raft membership."""
    from .client.master_client import MasterClient
    from .pb import master_pb2 as mpb
    from .utils.rpc import MASTER_SERVICE, RpcService, serve

    p = argparse.ArgumentParser(prog="master.follow")
    p.add_argument("-masters", default="127.0.0.1:9333",
                   help="leader quorum to follow")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9334)
    opt = p.parse_args(argv)
    mc = MasterClient(opt.masters, client_type="master-follower").start()
    mc.wait_connected()

    svc = RpcService(MASTER_SERVICE)

    @svc.unary("LookupVolume", mpb.LookupVolumeRequest,
               mpb.LookupVolumeResponse)
    def lookup(req, ctx):
        resp = mpb.LookupVolumeResponse()
        for vid_str in req.volume_or_file_ids:
            e = resp.volume_id_locations.add(volume_or_file_id=vid_str)
            try:
                for loc in mc.lookup(int(vid_str.split(",")[0])):
                    e.locations.add(url=loc["url"],
                                    public_url=loc["public_url"],
                                    grpc_port=loc["grpc_port"])
            except Exception as ex:  # noqa: BLE001 — the error rides the answer
                e.error = str(ex)
        return resp

    @svc.unary("GetMasterConfiguration",
               mpb.GetMasterConfigurationRequest,
               mpb.GetMasterConfigurationResponse)
    def conf(req, ctx):
        return mpb.GetMasterConfigurationResponse(leader=mc.leader)

    server = serve(f"{opt.ip}:{opt.port}", [svc])
    print(f"master follower on {opt.ip}:{opt.port} tracking {mc.leader} "
          "(lookup-only)", flush=True)
    _wait_for_signal()
    server.stop(grace=None)
    mc.stop()
    return 0


def run_export(argv) -> int:
    """Dump a volume's live needles to local files (reference
    command/export.go)."""
    import os

    from .storage.volume import Volume
    p = argparse.ArgumentParser(prog="export")
    p.add_argument("-dir", default=".", help="directory holding .dat/.idx")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-o", dest="output", default="export",
                   help="output directory")
    opt = p.parse_args(argv)
    v = Volume(opt.dir, opt.collection, opt.volumeId,
               create_if_missing=False)
    os.makedirs(opt.output, exist_ok=True)
    keys, _offs, _sizes = v.nm.map.items_arrays()
    n = 0
    for i in range(keys.size):
        needle = v.read_needle(int(keys[i]), cookie=None)
        raw = (needle.name.decode(errors="replace")
               if needle.name else f"{int(keys[i]):x}")
        name = os.path.basename(raw.replace("\\", "/"))  # no traversal
        if not name or name in (".", ".."):
            name = f"{int(keys[i]):x}"
        with open(os.path.join(opt.output, name), "wb") as f:
            f.write(needle.data)
        n += 1
    v.close()
    print(f"exported {n} needles from volume {opt.volumeId} to {opt.output}")
    return 0


def run_compact(argv) -> int:
    """Offline-vacuum a volume in place (reference command/compact.go)."""
    from .storage.vacuum import commit_compact, compact
    from .storage.volume import Volume
    p = argparse.ArgumentParser(prog="compact")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    opt = p.parse_args(argv)
    v = Volume(opt.dir, opt.collection, opt.volumeId,
               create_if_missing=False)
    live, reclaimed = compact(v)
    v = commit_compact(v)
    v.close()
    print(f"compacted volume {opt.volumeId}: {live} live needles, "
          f"{reclaimed} bytes reclaimed")
    return 0


def run_version(argv) -> int:
    from . import __version__
    print(f"seaweedfs-tpu-torch {__version__}")
    return 0


def run_fix(argv) -> int:
    """Rebuild .idx by scanning the .dat (reference command/fix.go:74)."""
    from .storage.volume import rebuild_idx_from_dat
    p = argparse.ArgumentParser(prog="fix")
    p.add_argument("dat_path")
    opt = p.parse_args(argv)
    if not opt.dat_path.endswith(".dat"):
        p.error(f"{opt.dat_path!r} is not a .dat file")
    idx = opt.dat_path[:-4] + ".idx"
    n = rebuild_idx_from_dat(opt.dat_path, idx)
    print(f"wrote {n} entries to {idx}")
    return 0


def _filer_server(opt, master: str, store: str, meta_log: str, **kw):
    """A FilerServer from filer flags, started; one whose port cannot be
    bound exits with its message."""
    from .filer.filer_server import FilerServer
    try:
        return FilerServer(master, store_spec=store, ip=opt.ip,
                           meta_log_path=meta_log, **kw).start()
    except (OSError, ValueError) as e:
        print(f"error: filer: {e}", file=sys.stderr)
        sys.exit(2)


def _started(server, what: str):
    """`server.start()`; a server whose port cannot be bound exits with
    its message."""
    try:
        return server.start()
    except OSError as e:
        print(f"error: {what}: {e}", file=sys.stderr)
        sys.exit(2)


def _s3_config(fs, gw, iam_server=None, identities: bool = True):
    """The loaders of the gateway's cluster configuration, kept in the
    filer under /etc (reference `run_s3_standalone`, :422-600): identities
    from /etc/iam/identity.json (unless `identities` is False, when -config
    gave them; through the IAM API's own loader when one runs, so its copy
    stays the file's), the circuit breaker from /etc/s3/circuit_breaker.json
    and the QoS policy from /etc/qos/policy.json. Returns `load_all(stage)`;
    each loader fails on its own, so a bad file leaves the others in
    force."""
    import json

    def read(d: str, n: str):
        entry = fs.filer.find_entry(d, n)
        if entry is None:
            return None
        return json.loads(fs.read_entry_bytes(entry))

    def load_identities():
        if iam_server is not None:
            with iam_server._mu:
                iam_server._load_persisted()
            return
        doc = read("/etc/iam", "identity.json")
        if doc is not None:
            gw.iam.load(doc)
            print("s3: identities loaded from filer /etc/iam/identity.json",
                  file=sys.stderr)

    def load_circuit_breaker():
        doc = read("/etc/s3", "circuit_breaker.json")
        if doc is not None:
            gw.breaker.load(doc)
            print("s3: circuit breaker loaded from filer "
                  "/etc/s3/circuit_breaker.json", file=sys.stderr)

    def load_qos_policy():
        doc = read("/etc/qos", "policy.json")
        if doc is not None:
            gw.qos.load(doc)
            print("s3: qos policy loaded from filer /etc/qos/policy.json",
                  file=sys.stderr)

    def load_all(stage: str) -> None:
        loaders = [("identity", load_identities)] if identities else []
        loaders += [("circuit breaker", load_circuit_breaker),
                    ("qos policy", load_qos_policy)]
        for what, load in loaders:
            try:
                load()
            except Exception as e:  # noqa: BLE001
                print(f"s3: {what} {stage}: {e}", file=sys.stderr)

    return load_all


def _watch_etc(fs, load_all, stop: threading.Event) -> None:
    """Reload the gateway's configuration whenever an entry under /etc
    changes (reference auth_credentials_subscribe.go): the in-process
    filer's meta log, or a remote filer's SubscribeMetadata."""
    import time

    def under_etc(d: str) -> bool:
        return d == "/etc" or d.startswith("/etc/")

    def run():
        since = time.time_ns()
        if hasattr(fs.filer, "subscribe"):  # a remote filer's stream
            events = fs.filer.subscribe(since, stop, path_prefix="/etc")
        else:
            events = fs.filer.meta_log.subscribe(since, stop)
        try:
            for resp in events:
                if under_etc(resp.directory):
                    load_all("reload")
        except Exception as e:  # noqa: BLE001 — the daemon keeps serving
            if not stop.is_set():
                print(f"s3: /etc watch ended: {e}", file=sys.stderr)

    threading.Thread(target=run, daemon=True, name="s3-conf-watch").start()


def _embedded_gateways(opt, fs, s3_port: int, iam_port: int):
    """`-s3` and `-iam` over an in-process filer (the filer and server
    verbs): the gateway with its /etc configuration loaded before it
    serves, and watched after, and the IAM API over its identities.
    Returns a stop function."""
    from .iam import IamApiServer
    from .s3.auth import IdentityAccessManagement
    from .s3.s3_server import S3Gateway
    stop = threading.Event()
    gw = S3Gateway(fs, ip=opt.ip, port=s3_port) if opt.s3 else None
    iam = None
    if opt.iam:
        # loads the filer's identity.json into the gateway's identities
        iam = IamApiServer(gw.iam if gw is not None
                           else IdentityAccessManagement(None),
                           filer_server=fs, ip=opt.ip, port=iam_port)
    if gw is not None:
        load_all = _s3_config(fs, gw, iam)
        load_all("load")
        _watch_etc(fs, load_all, stop)
        _started(gw, "s3")
        print(f"s3 {gw.url} over filer {fs.url}", flush=True)
    if iam is not None:
        _started(iam, "iam")
        print(f"iam {iam.url} over filer {fs.url}", flush=True)

    def stop_all():
        stop.set()
        for srv in (iam, gw):
            if srv is not None:
                srv.stop()
    return stop_all


def run_filer(argv) -> int:
    """The standalone filer daemon (reference command/filer.go and
    `run_filer`, :352). It does no device work and loads no torch. `-s3`
    embeds the S3 gateway and `-iam` (port only) the IAM API over its
    identities; the gateway loads its /etc configuration from this filer
    and reloads it when it changes (the reference's embedded gateway runs
    open and reads no /etc)."""
    import os
    import tempfile

    p = argparse.ArgumentParser(prog="filer")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-grpcPort", type=int, default=0)
    p.add_argument("-store", default="",
                   help="memory | sqlite:/path.db | logdb:/path.logdb | lsm:/dir "
                        "| redis:host:port | mongo:host:port | etcd:host:port "
                        "(default: filer.toml or sqlite ./filer.db)")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-maxMB", type=int, default=4)
    p.add_argument("-encryptVolumeData", action="store_true",
                   help="AES-256-GCM encrypt chunks; keys live in filer "
                        "metadata (reference filer -encryptVolumeData)")
    p.add_argument("-noPeerMeta", action="store_true",
                   help="disable the multi-filer metadata mesh (reference "
                        "filers aggregate peer metadata by default)")
    p.add_argument("-chunkCacheMB", type=int, default=64,
                   help="in-memory chunk-cache bound on the read path")
    p.add_argument("-chunkCacheDir", default="",
                   help="optional disk tier for the chunk cache")
    p.add_argument("-s3", action="store_true",
                   help="embed an S3 gateway over this filer "
                        "(reference `weed filer -s3`)")
    p.add_argument("-s3Port", type=int, default=8333)
    p.add_argument("-iam", action="store_true",
                   help="embed the IAM API over the gateway's identities")
    p.add_argument("-iamPort", type=int, default=8111)
    opt = p.parse_args(argv)
    store = opt.store
    if not store:
        from .utils import config as cfg
        # legacy single-filer layouts keep working, but only on the
        # default port: a second filer on another port never adopts them
        legacy = "./filer.db"
        fallback = (f"sqlite:{legacy}"
                    if opt.port == 8888 and os.path.exists(legacy)
                    else f"sqlite:./filer-{opt.port}.db")
        store = cfg.get_dotted(cfg.load_config("filer"),
                               "filer.options.store", fallback)
    # per-port defaults: the meta log lives next to the store's db file,
    # so two filers started from one directory never share one
    spec_path = store.partition(":")[2]
    meta_dir = (os.path.dirname(os.path.abspath(spec_path)) if spec_path
                else tempfile.mkdtemp(prefix=f"swtpu-filer-{opt.port}-"))
    meta_log = ("./filer-meta.log"
                if opt.port == 8888 and os.path.exists("./filer-meta.log")
                else os.path.join(meta_dir, f"filer-meta-{opt.port}.log"))
    stopped = _signals()
    fs = _filer_server(
        opt, opt.master, store, meta_log, port=opt.port,
        grpc_port=opt.grpcPort or None, collection=opt.collection,
        replication=opt.replication, chunk_size_mb=opt.maxMB,
        encrypt_data=opt.encryptVolumeData,
        meta_aggregate=not opt.noPeerMeta, chunk_cache_mb=opt.chunkCacheMB,
        chunk_cache_dir=opt.chunkCacheDir or None)
    print(f"filer {fs.url} (grpc :{fs.grpc_port}, store {store}) on master "
          f"{opt.master}", flush=True)
    # the embedded gateway rides the in-process filer: S3 GET/PUT go
    # through the streaming large-object data plane directly
    stop_gateways = _embedded_gateways(opt, fs, opt.s3Port, opt.iamPort)
    stopped.wait()
    stop_gateways()
    fs.stop()
    return 0


def run_s3(argv) -> int:
    """The standalone S3 gateway over a remote filer (reference
    command/s3.go and `run_s3_standalone`, :422): identities from -config,
    else from the filer's /etc/iam/identity.json; the circuit breaker and
    the QoS policy from /etc; all reloaded when /etc changes. It loads no
    torch."""
    import json

    from .client.filer_client import FilerClient
    from .s3.s3_server import S3Gateway
    p = argparse.ArgumentParser(prog="s3")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8333)
    p.add_argument("-config", default="", help="identities json file")
    opt = p.parse_args(argv)
    iam_config = None
    if opt.config:
        with open(opt.config) as f:
            iam_config = json.load(f)
    stopped = _signals()
    fc = FilerClient(opt.filer)
    gw = S3Gateway(fc, ip=opt.ip, port=opt.port, iam_config=iam_config)
    load_all = _s3_config(fc, gw, identities=not opt.config)
    load_all("load")
    stop = threading.Event()
    _watch_etc(fc, load_all, stop)
    _started(gw, "s3")
    print(f"s3 {gw.url} over filer {opt.filer}", flush=True)
    stopped.wait()
    stop.set()
    gw.stop()
    fc.close()
    return 0


def run_iam(argv) -> int:
    """The standalone IAM API over a remote filer (reference
    command/iam.go and `run_iam_standalone`, :605): identities persist in
    the filer's /etc/iam/identity.json. It loads no torch."""
    from .client.filer_client import FilerClient
    from .iam import IamApiServer
    from .s3.auth import IdentityAccessManagement
    p = argparse.ArgumentParser(prog="iam")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8111)
    opt = p.parse_args(argv)
    stopped = _signals()
    fc = FilerClient(opt.filer)
    iam = _started(IamApiServer(IdentityAccessManagement(None),
                                filer_server=fc, ip=opt.ip, port=opt.port),
                   "iam")
    print(f"iam {iam.url} over filer {opt.filer}", flush=True)
    stopped.wait()
    iam.stop()
    fc.close()
    return 0


def run_webdav(argv) -> int:
    """The standalone WebDAV gateway over a remote filer (reference
    command/webdav.go and `run_webdav_standalone`, :496). It loads no
    torch."""
    from .client.filer_client import FilerClient
    from .webdav import WebDavServer
    p = argparse.ArgumentParser(prog="webdav")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=7333)
    opt = p.parse_args(argv)
    stopped = _signals()
    fc = FilerClient(opt.filer)
    wd = _started(WebDavServer(fc, ip=opt.ip, port=opt.port), "webdav")
    print(f"webdav {wd.url} over filer {opt.filer}", flush=True)
    stopped.wait()
    wd.stop()
    fc.close()
    return 0


def run_filer_copy(argv) -> int:
    """Copy local files and directories into the filer (reference
    command/filer_copy.go and `run_filer_copy`, :679)."""
    import mimetypes
    import os

    from .client.filer_client import FilerClient
    p = argparse.ArgumentParser(prog="filer.copy")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("files", nargs="+",
                   help="local files/dirs, last arg = filer dest dir")
    opt = p.parse_args(argv)
    *srcs, dest = opt.files
    if not dest.startswith("/"):
        print("destination must be an absolute filer path")
        return 1
    fc = FilerClient(opt.filer)
    n = 0
    for src in srcs:
        if os.path.isdir(src):
            base = os.path.basename(src.rstrip("/"))
            for root, _dirs, names in os.walk(src):
                rel = os.path.relpath(root, src)
                for name in names:
                    local = os.path.join(root, name)
                    remote = "/".join(filter(
                        lambda s: s not in ("", "."),
                        [dest.rstrip("/"), base, rel, name]))
                    with open(local, "rb") as f:
                        fc.write_file("/" + remote.lstrip("/"), f.read(),
                                      mime=mimetypes.guess_type(name)[0] or "")
                    n += 1
        else:
            name = os.path.basename(src)
            with open(src, "rb") as f:
                fc.write_file(f"{dest.rstrip('/')}/{name}", f.read(),
                              mime=mimetypes.guess_type(name)[0] or "")
            n += 1
    print(f"copied {n} files to {opt.filer}{dest}")
    return 0


def _follow(events, apply, ready: str = "") -> None:
    """Apply each event of a filer subscription on a daemon thread until
    SIGINT or SIGTERM; `ready` is printed once the signals are caught. The
    signal never interrupts the stream's gRPC call: an interrupt raised
    inside grpc's wait leaves the channel unable to close, and the process
    then hangs at exit collecting it."""
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    if ready:
        print(ready, flush=True)

    failed: list = []

    def pump():
        try:
            for resp in events:
                apply(resp)
        except Exception as e:  # noqa: BLE001 — raised again below
            failed.append(e)
        finally:
            done.set()

    threading.Thread(target=pump, daemon=True, name="filer-follow").start()
    done.wait()
    if failed:
        raise failed[0]


def run_filer_meta_tail(argv) -> int:
    """Follow the filer's metadata events (reference
    command/filer_meta_tail.go and `run_filer_meta_tail`, :720), one line
    an event, flushed as it comes; SIGINT or SIGTERM ends it."""
    import time

    from .client.filer_client import FilerClient
    p = argparse.ArgumentParser(prog="filer.meta.tail")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-pathPrefix", default="/")
    p.add_argument("-timeAgo", type=float, default=0,
                   help="start N seconds in the past (0 = now)")
    opt = p.parse_args(argv)
    fc = FilerClient(opt.filer, client_name="meta-tail")
    since = time.time_ns() - int(opt.timeAgo * 1e9)  # swtpu-lint: disable=wallclock-duration (wire cursor: filer events carry wall-clock ts_ns)
    stop = threading.Event()

    def show(resp):
        ev = resp.event_notification
        kind = ("delete" if not ev.new_entry.name
                else "create" if not ev.old_entry.name else "update")
        name = ev.new_entry.name or ev.old_entry.name
        print(f"{resp.ts_ns} {kind:7s} {resp.directory}/{name}", flush=True)

    _follow(fc.filer.subscribe(since, stop, path_prefix=opt.pathPrefix),
            show)
    stop.set()
    return 0


def run_filer_cat(argv) -> int:
    """Print a filer file's bytes, read straight from the volume servers
    (reference command/filer_cat.go and `run_filer_cat`, :959)."""
    from .client.filer_client import FilerClient
    from .filer.filer import split_path
    p = argparse.ArgumentParser(prog="filer.cat")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("path", help="absolute filer path")
    opt = p.parse_args(argv)
    fc = FilerClient(opt.filer, client_name="filer-cat")
    d, n = split_path(opt.path)
    entry = fc.filer.find_entry(d, n)
    if entry is None:
        print(f"{opt.path}: not found", file=sys.stderr)
        return 1
    if entry.is_directory:
        print(f"{opt.path}: is a directory", file=sys.stderr)
        return 1
    sys.stdout.buffer.write(fc.read_entry_bytes(entry))
    sys.stdout.buffer.flush()
    return 0


def run_filer_meta_backup(argv) -> int:
    """Back up the filer's metadata into a local sqlite store (reference
    command/filer_meta_backup.go and `run_filer_meta_backup`, :981): a
    full scan on the first run or with -restart, then the event stream
    from the offset kept in the backup store; SIGINT or SIGTERM ends it
    (every applied event is committed as it lands)."""
    import struct

    from .client.filer_client import FilerClient
    from .filer.store import SqliteStore
    p = argparse.ArgumentParser(prog="filer.meta.backup")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-store", default="meta_backup.db",
                   help="sqlite backup store path")
    p.add_argument("-path", default="/", help="subtree to back up")
    p.add_argument("-restart", action="store_true",
                   help="discard the stored offset and re-scan the tree")
    opt = p.parse_args(argv)
    fc = FilerClient(opt.filer, client_name="meta-backup")
    store = SqliteStore(opt.store)
    offset_key = b"meta.backup.offset"
    raw = None if opt.restart else store.kv_get(offset_key)
    since = struct.unpack("<q", raw)[0] if raw else 0
    if since == 0:
        t0 = fc.filer.server_now_ns()  # filer clock (skew-safe offset)
        n = 0

        def join_dir(d, name):
            return (d.rstrip("/") + "/" + name) if d != "/" else "/" + name

        def scan(directory):
            nonlocal n
            for e in fc.filer.list_entries(directory):
                store.delete_entry(directory, e.name)
                store.insert_entry(directory, e)
                n += 1
                if e.is_directory:
                    scan(join_dir(directory, e.name))

        scan(opt.path)
        since = t0
        store.kv_put(offset_key, struct.pack("<q", since))
        print(f"full scan: {n} entries into {opt.store}", flush=True)
    stop = threading.Event()

    def apply(resp):
        ev = resp.event_notification
        try:
            if ev.HasField("old_entry") and ev.old_entry.name:
                store.delete_entry(resp.directory, ev.old_entry.name)
            if ev.HasField("new_entry") and ev.new_entry.name:
                d = ev.new_parent_path or resp.directory
                store.delete_entry(d, ev.new_entry.name)
                store.insert_entry(d, ev.new_entry)
        except Exception as e:  # noqa: BLE001
            print(f"apply {resp.directory}: {e}", file=sys.stderr)
        if resp.ts_ns:
            store.kv_put(offset_key, struct.pack("<q", resp.ts_ns))

    _follow(fc.filer.subscribe(since, stop, path_prefix=opt.path), apply,
            ready=f"tailing {opt.filer}{opt.path} metadata -> {opt.store} "
                  f"(since {since})")
    stop.set()
    return 0


def run_filer_backup(argv) -> int:
    """Continuously mirror a filer subtree into a local directory
    (reference command/filer_backup.go and `run_filer_backup`, :556):
    subscribe to the metadata events and apply them through the local
    replication sink, resuming from the last applied offset kept in the
    SOURCE filer's kv space; each event is tried five times, then
    dead-lettered. SIGINT or SIGTERM ends it."""
    import struct
    import time

    from .client.filer_client import FilerClient
    from .replication.replicator import Replicator
    from .replication.sink import LocalSink

    p = argparse.ArgumentParser(prog="filer.backup")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-dir", required=True, help="local mirror directory")
    p.add_argument("-path", default="/", help="subtree to mirror")
    opt = p.parse_args(argv)
    fc = FilerClient(opt.filer, client_name="filer-backup")
    repl = Replicator(LocalSink(opt.dir), fc.read_entry_bytes, opt.path)
    offset_key = f"backup.offset.{opt.dir}".encode()
    raw = fc.filer.kv_get(offset_key)
    since = struct.unpack("<q", raw)[0] if raw else 0
    stop = threading.Event()

    def apply(resp):
        applied = False
        for attempt in range(5):  # FilerSync-style retry + dead-letter
            try:
                repl.replicate(resp.directory, resp.event_notification)
                applied = True
                break
            except Exception as e:  # noqa: BLE001
                print(f"apply {resp.directory} (try {attempt + 1}/5): {e}",
                      file=sys.stderr)
                time.sleep(0.2 * 2 ** attempt)
        if not applied:
            print(f"DEAD-LETTER {resp.directory}: mirror may diverge; "
                  "re-run with -path to re-scan", file=sys.stderr)
        if resp.ts_ns:
            fc.filer.kv_put(offset_key, struct.pack("<q", resp.ts_ns))

    _follow(fc.filer.subscribe(since, stop, path_prefix=opt.path), apply,
            ready=f"backing up {opt.filer}{opt.path} -> {opt.dir} "
                  f"(since {since})")
    stop.set()
    fc.close()
    return 0


def _run_syncs(syncs) -> int:
    """Run started sync workers until SIGINT or SIGTERM, then stop them."""
    stopped = _signals()
    stopped.wait()
    for s in syncs:
        s.stop()
    return 0


def run_filer_sync(argv) -> int:
    """Continuous filer synchronization (reference command/filer_sync.go
    and `run_filer_sync`, :618): A -> B, and B -> A unless
    -isActivePassive, each worker's offset in its target's store."""
    from .client.filer_client import FilerClient
    from .replication.filer_sync import FilerSync
    p = argparse.ArgumentParser(prog="filer.sync")
    p.add_argument("-a", required=True, help="filer A host:port")
    p.add_argument("-b", required=True, help="filer B host:port")
    p.add_argument("-isActivePassive", action="store_true",
                   help="only sync A -> B")
    p.add_argument("-path", default="/", help="path prefix to sync")
    opt = p.parse_args(argv)
    fa, fb = FilerClient(opt.a), FilerClient(opt.b)
    syncs = [FilerSync(fa, fb, path_prefix=opt.path).start()]
    print(f"syncing {opt.a} -> {opt.b} under {opt.path}", flush=True)
    if not opt.isActivePassive:
        syncs.append(FilerSync(fb, fa, path_prefix=opt.path).start())
        print(f"syncing {opt.b} -> {opt.a} under {opt.path}", flush=True)
    return _run_syncs(syncs)


def run_geo_sync(argv) -> int:
    """Async cross-cluster replication over an expensive link (reference
    `run_geo_sync`, :639, over geo/replication.py): FilerSync with its own
    offsets, maintenance-class applies and the lag gauge
    SeaweedFS_geo_replication_lag_seconds{peer} held to -lagBound (or the
    link-cost policy's replication_lag_bound_s)."""
    from .client.filer_client import FilerClient
    from .geo.policy import LinkCostModel, load_link_costs
    from .geo.replication import GeoSync
    p = argparse.ArgumentParser(prog="geo.sync")
    p.add_argument("-a", required=True, help="local filer host:port")
    p.add_argument("-b", required=True, help="remote filer host:port")
    p.add_argument("-isActivePassive", action="store_true",
                   help="only replicate A -> B")
    p.add_argument("-path", default="/", help="path prefix to replicate")
    p.add_argument("-peerA", default="", help="peer label for the A side "
                   "(defaults to its address)")
    p.add_argument("-peerB", default="", help="peer label for the B side")
    p.add_argument("-linkCosts", default="",
                   help="link-cost policy (inline JSON or file) supplying "
                   "replication_lag_bound_s; -lagBound overrides")
    p.add_argument("-lagBound", type=float, default=-1.0,
                   help="replication lag bound in seconds (<0: use policy)")
    opt = p.parse_args(argv)
    costs = (load_link_costs(opt.linkCosts) if opt.linkCosts
             else LinkCostModel())
    bound = (opt.lagBound if opt.lagBound >= 0
             else costs.replication_lag_bound_s)
    fa, fb = FilerClient(opt.a), FilerClient(opt.b)
    syncs = [GeoSync(fa, fb, peer=opt.peerA or opt.a, lag_bound_s=bound,
                     path_prefix=opt.path).start()]
    print(f"geo-replicating {opt.a} -> {opt.b} under {opt.path} "
          f"(lag bound {bound}s)", flush=True)
    if not opt.isActivePassive:
        syncs.append(GeoSync(fb, fa, peer=opt.peerB or opt.b,
                             lag_bound_s=bound,
                             path_prefix=opt.path).start())
        print(f"geo-replicating {opt.b} -> {opt.a} under {opt.path}",
              flush=True)
    return _run_syncs(syncs)


def _open_sink(spec: str):
    """Replication sink from a spec string (reference `_open_sink`, :1046;
    replication.toml picks the enabled sink the same way): 'local:/dir',
    'filer:host:port[/prefix]', 's3:http://host:port/bucket[?ak:sk]',
    'azure:...' and 'gcs-json:...' as the remote tiers spell them."""
    from .replication.sink import FilerSink, LocalSink, S3Sink
    kind, _, arg = spec.partition(":")
    if kind == "local":
        return LocalSink(arg)
    if kind == "filer":
        from .client.filer_client import FilerClient
        addr, slash, prefix = arg.partition("/")
        return FilerSink(FilerClient(addr), dir_prefix=slash + prefix
                         if prefix else "")
    if kind in ("s3", "b2", "gcs", "wasabi", "minio"):
        url, _, cred = arg.partition("?")
        scheme, sep, rest = url.partition("://")
        host, _, bucket = rest.partition("/")
        ak, _, sk = cred.partition(":")
        return S3Sink(f"{scheme}://{host}", bucket, ak, sk)
    if kind == "azure":
        from .remote.azure import AzureSink, parse_azure_spec
        return AzureSink(parse_azure_spec(arg))
    if kind == "gcs-json":
        from .remote.gcs import GcsSink, parse_gcs_spec
        return GcsSink(parse_gcs_spec(arg))
    raise ValueError(f"unknown sink spec {spec!r}")


def run_filer_replicate(argv) -> int:
    """Consume a notification queue and apply events through a replication
    sink (reference command/filer_replicate.go and `run_filer_replicate`,
    :1074 — the queue-decoupled alternative to filer.sync): the records of
    a `logfile:` queue from the offset kept in `<queue>.offset` (or
    -offsetFile), the offset rewritten after each record. SIGINT or SIGTERM
    ends it with rc 0 (the reference ends on SIGINT alone)."""
    import os

    from .client.filer_client import FilerClient
    from .notification.queues import LogFileQueue
    from .replication.replicator import Replicator
    p = argparse.ArgumentParser(prog="filer.replicate")
    p.add_argument("-filer", default="127.0.0.1:8888",
                   help="source filer (chunk reads)")
    p.add_argument("-queue", required=True,
                   help="notification source: logfile:/path (durable log "
                        "written by the filer/fs.meta.notify)")
    p.add_argument("-sink", required=True,
                   help="local:/dir | filer:host:port | "
                        "s3:http://host:port/bucket[?ak:sk]")
    p.add_argument("-offsetFile", default="",
                   help="resume-offset path (default <queue>.offset)")
    opt = p.parse_args(argv)
    kind, _, qpath = opt.queue.partition(":")
    if kind != "logfile":
        print("filer.replicate consumes a durable queue; use "
              "logfile:/path (mq consumers: use filer.sync)",
              file=sys.stderr)
        return 1
    done = _signals()
    fc = FilerClient(opt.filer, client_name="filer-replicate")
    repl = Replicator(_open_sink(opt.sink), fc.read_entry_bytes)
    queue = LogFileQueue(qpath)
    off_path = opt.offsetFile or qpath + ".offset"
    offset = 0
    if os.path.exists(off_path):
        with open(off_path) as f:
            offset = int(f.read().strip() or 0)
    print(f"replicating {opt.queue} -> {opt.sink} (offset {offset})",
          flush=True)
    while not done.is_set():
        progressed = False
        for next_off, rec in queue.read(offset):
            try:
                repl.replicate(rec.directory, rec.event_notification)
            except Exception as e:  # noqa: BLE001
                print(f"apply {rec.directory}: {e}", file=sys.stderr)
            offset = next_off
            progressed = True
            with open(off_path, "w") as f:
                f.write(str(offset))
            if done.is_set():
                break
        if not progressed:
            done.wait(1.0)
    queue.close()
    fc.close()
    return 0


def run_mq_broker(argv) -> int:
    """The message-queue broker daemon (reference weed mq.broker and
    `run_mq_broker`, :942): standalone, its segments in a local directory
    (`-dir`, '' = memory-only) through mq/broker.LocalSegmentStore. SIGINT
    or SIGTERM stops it cleanly, which flushes every partition's tail (the
    reference waits to be killed)."""
    from .mq.broker import BrokerServer
    p = argparse.ArgumentParser(prog="mq.broker")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=17777)
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-dir", default="./mq-data",
                   help="local segment directory ('' = memory-only)")
    opt = p.parse_args(argv)
    done = _signals()
    broker = _started(BrokerServer(opt.master, ip=opt.ip, port=opt.port,
                                   data_dir=opt.dir or None), "mq.broker")
    print(f"mq broker {broker.address} (segments in "
          f"{opt.dir or 'memory'})", flush=True)
    done.wait()
    broker.stop()
    return 0

def run_filer_remote_sync(argv) -> int:
    """Write local changes under remote-mounted directories back to their
    remote stores (reference command/filer_remote_sync.go and
    `run_filer_remote_sync`, :1126): a subscription from the filer's own
    clock, each event through remote_mount.apply_event_to_remote, the
    mapping table read again when /etc/remote/mount.json changes. SIGINT or
    SIGTERM ends it with rc 0; it loads no torch."""
    from .client.filer_client import FilerClient
    from .remote.remote_mount import (MOUNT_CONF, _load_mappings,
                                      apply_event_to_remote)
    p = argparse.ArgumentParser(prog="filer.remote.sync")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-dir", default="",
                   help="only sync this mounted directory")
    opt = p.parse_args(argv)
    fc = FilerClient(opt.filer, client_name="remote-sync")

    def load_mappings():
        m = _load_mappings(fc)
        return {d: v for d, v in m.items() if d == opt.dir} if opt.dir else m

    mappings = load_mappings()
    if not mappings:
        print("no remote mounts to sync", file=sys.stderr)
        fc.close()
        return 1
    stop = threading.Event()
    prefix = opt.dir or "/"
    # the FILER's clock, taken before the ready line: a skewed client
    # clock would drop events; events in the gap replay from `since`
    since = fc.filer.server_now_ns()

    def apply(resp):
        nonlocal mappings
        ev = resp.event_notification
        if MOUNT_CONF == f"{resp.directory}/" \
                f"{ev.new_entry.name or ev.old_entry.name}":
            mappings = load_mappings()  # a remote.mount/unmount
            return
        try:
            act = apply_event_to_remote(fc, mappings, resp.directory, ev)
            if act:
                print(act, flush=True)
        except Exception as e:  # noqa: BLE001 — one event, not the daemon
            print(f"sync {resp.directory}: {e}", file=sys.stderr, flush=True)

    _follow(fc.filer.subscribe(since, stop, path_prefix=prefix), apply,
            ready=f"remote-sync watching {opt.filer}{prefix} "
                  f"({len(mappings)} mounts)")
    stop.set()
    fc.close()
    return 0


def run_filer_remote_gateway(argv) -> int:
    """Mirror bucket creation and deletion under /buckets into a remote
    store, and their contents as filer.remote.sync does (reference
    command/filer_remote_gateway.go and `run_filer_remote_gateway`,
    :1177). SIGINT or SIGTERM ends it with rc 0; it loads no torch."""
    from .client.filer_client import FilerClient
    from .remote.remote_mount import (_load_mappings, _save_mappings,
                                      apply_event_to_remote)
    from .storage.backend import bucket_spec, open_remote
    p = argparse.ArgumentParser(prog="filer.remote.gateway")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-createBucketAt", required=True,
                   help="remote spec new buckets are created on")
    opt = p.parse_args(argv)
    root_spec = (opt.createBucketAt if ":" in opt.createBucketAt
                 else f"local:{opt.createBucketAt}")
    fc = FilerClient(opt.filer, client_name="remote-gateway")
    client = open_remote(root_spec)
    stop = threading.Event()
    # this process is the only writer under /buckets, so its own updates
    # keep the cached table fresh
    mappings = _load_mappings(fc)
    since = fc.filer.server_now_ns()

    def apply(resp):
        ev = resp.event_notification
        try:
            top = resp.directory == "/buckets"
            if top and ev.HasField("new_entry") and \
                    ev.new_entry.is_directory and ev.new_entry.name:
                b = ev.new_entry.name
                client.create_bucket(b)
                mappings[f"/buckets/{b}"] = {
                    "spec": bucket_spec(root_spec, b), "prefix": ""}
                _save_mappings(fc, mappings)
                print(f"created bucket {b}", flush=True)
            elif top and ev.HasField("old_entry") and \
                    ev.old_entry.is_directory and ev.old_entry.name \
                    and not (ev.HasField("new_entry") and ev.new_entry.name):
                b = ev.old_entry.name
                client.delete_bucket(b)
                mappings.pop(f"/buckets/{b}", None)
                _save_mappings(fc, mappings)
                print(f"deleted bucket {b}", flush=True)
            else:
                act = apply_event_to_remote(fc, mappings, resp.directory, ev)
                if act:
                    print(act, flush=True)
        except Exception as e:  # noqa: BLE001 — one event, not the daemon
            print(f"gateway {resp.directory}: {e}", file=sys.stderr,
                  flush=True)

    _follow(fc.filer.subscribe(since, stop, path_prefix="/buckets"), apply,
            ready=f"remote-gateway: /buckets <-> {opt.createBucketAt}")
    stop.set()
    fc.close()
    return 0


def run_mount(argv) -> int:
    """Kernel FUSE mount of a filer (reference command/mount.go and
    `run_mount`, :902) through the ctypes libfuse binding
    (mount/fuse_binding.py), with the control socket that `shell
    mount.configure` dials. It loads no torch; it needs /dev/fuse,
    fusermount and libfuse.so.2, and ends when the mount is unmounted
    (fusermount -u) or on SIGINT or SIGTERM."""
    from .client.filer_client import FilerClient
    from .mount.control import mount_socket_path, serve_mount_control
    from .mount.fuse_binding import fuse_loop
    from .mount.weedfs import WeedFS
    p = argparse.ArgumentParser(prog="mount")
    p.add_argument("-filer", default="127.0.0.1:8888",
                   help="filer ip:port (its gRPC is port+10000)")
    p.add_argument("-filerGrpc", default="",
                   help="filer gRPC address override")
    p.add_argument("-dir", required=True, help="mountpoint")
    p.add_argument("-chunkSizeLimitMB", type=int, default=4)
    p.add_argument("-concurrentWriters", type=int, default=8)
    p.add_argument("-allowOther", action="store_true")
    p.add_argument("-cacheDir", default="",
                   help="disk tier for the chunk cache (reference -cacheDir)")
    p.add_argument("-cacheSizeMB", type=int, default=1024,
                   help="disk chunk-cache bound (reference -cacheCapacityMB)")
    opt = p.parse_args(argv)
    fc = FilerClient(opt.filer, grpc_address=opt.filerGrpc,
                     client_name="mount", cache_dir=opt.cacheDir or None,
                     cache_disk_mb=opt.cacheSizeMB)
    wfs = WeedFS(fc, chunk_size_mb=opt.chunkSizeLimitMB,
                 concurrency=opt.concurrentWriters)
    sock_path = mount_socket_path(opt.dir)
    stop_ctl = serve_mount_control(wfs, sock_path)
    print(f"mounting {opt.filer} at {opt.dir} (unmount: fusermount -u; "
          f"control: {sock_path})", flush=True)
    try:
        code = fuse_loop(wfs, opt.dir, allow_other=opt.allowOther)
    finally:
        stop_ctl()
    wfs.destroy()
    fc.close()
    return code


def run_fuse(argv) -> int:
    """/etc/fstab-compatible mount wrapper (reference command/fuse.go and
    `run_fuse`, :1273): `python -m seaweedfs_tpu_torch fuse <mountpoint> -o
    "filer=host:port,chunkSizeLimitMB=4"`."""
    p = argparse.ArgumentParser(prog="fuse")
    p.add_argument("mountpoint")
    p.add_argument("-o", default="", help="comma-separated options")
    opt = p.parse_args(argv)
    return run_mount(_fuse_mount_args(opt.mountpoint, opt.o))


def _fuse_mount_args(mountpoint: str, options: str) -> "list[str]":
    """The `mount` flags of a `fuse -o` option string."""
    opts = dict(kv.partition("=")[::2] for kv in options.split(",") if kv)
    fwd = ["-dir", mountpoint, "-filer", opts.get("filer", "127.0.0.1:8888")]
    if "chunkSizeLimitMB" in opts:
        fwd += ["-chunkSizeLimitMB", opts["chunkSizeLimitMB"]]
    if opts.get("allowOthers") in ("", "true") and "allowOthers" in opts:
        fwd += ["-allowOther"]
    return fwd


def run_ftp(argv) -> int:
    """FTP gateway over a remote filer (reference `run_ftp`, :1237; its
    weed/ftpd is an unwired skeleton, this serves an RFC 959 subset).
    SIGINT or SIGTERM stops it with rc 0; it loads no torch."""
    from .client.filer_client import FilerClient
    from .ftpd import FtpServer
    p = argparse.ArgumentParser(prog="ftp")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=2121)
    p.add_argument("-root", default="/", help="filer subtree to expose")
    p.add_argument("-user", default="", help="require this login "
                                             "(default anonymous)")
    p.add_argument("-password", default="")
    p.add_argument("-passivePortStart", type=int, default=0)
    p.add_argument("-passivePortStop", type=int, default=0)
    opt = p.parse_args(argv)
    users = {opt.user: opt.password} if opt.user else None
    rng = ((opt.passivePortStart, opt.passivePortStop)
           if opt.passivePortStart and opt.passivePortStop else None)
    stopped = _signals()
    fc = FilerClient(opt.filer, client_name="ftpd")
    ftp = _started(FtpServer(fc, ip=opt.ip, port=opt.port, root=opt.root,
                             users=users, passive_ports=rng), "ftp")
    print(f"ftp {ftp.url} over filer {opt.filer} (root {opt.root})",
          flush=True)
    stopped.wait()
    ftp.stop()
    fc.close()
    return 0


def run_scaffold(argv) -> int:
    """Print a default TOML config template (reference command/scaffold.go
    and `run_scaffold`, :802); write it with -output."""
    import os
    p = argparse.ArgumentParser(prog="scaffold")
    p.add_argument("-config", default="security",
                   help="master|filer|security|replication|notification|shell")
    p.add_argument("-output", default="",
                   help="directory to write <config>.toml into ('' = stdout)")
    opt = p.parse_args(argv)
    from .utils.scaffold import TEMPLATES
    body = TEMPLATES.get(opt.config)
    if body is None:
        print(f"unknown config {opt.config!r}; have {sorted(TEMPLATES)}")
        return 1
    if opt.output:
        os.makedirs(opt.output, exist_ok=True)
        path = os.path.join(opt.output, f"{opt.config}.toml")
        with open(path, "w") as f:
            f.write(body)
        print(f"wrote {path}")
    else:
        print(body)
    return 0


def run_update(argv) -> int:
    """Self-update verb (reference command/update.go downloads the latest
    release; `run_update`, :1262): a source checkout has no release
    channel, so it says how to update and downloads nothing."""
    p = argparse.ArgumentParser(prog="update")
    p.add_argument("-output", default="", help="(reference parity)")
    p.parse_args(argv)
    print("update: this is a source installation; update with "
          "`git pull` in the repository checkout")
    return 0


AUTOCOMPLETE_MARK = "# swtpu-autocomplete"


def run_autocomplete(argv) -> int:
    """Install bash completion of the verb table into ~/.bashrc (reference
    command/autocomplete.go and `run_autocomplete`, :1293): the
    reference's line, marked with AUTOCOMPLETE_MARK; a second install
    leaves the file as it is."""
    import os
    rc = os.path.expanduser("~/.bashrc")
    line = (f'complete -W "{" ".join(sorted(VERBS))}" -o default swtpu '
            f"{AUTOCOMPLETE_MARK}\n")
    existing = ""
    if os.path.exists(rc):
        with open(rc) as f:
            existing = f.read()
    if AUTOCOMPLETE_MARK in existing:
        print("autocomplete already installed")
        return 0
    with open(rc, "a") as f:
        f.write(line)
    print(f"bash completion installed in {rc}; restart your shell")
    return 0


def run_unautocomplete(argv) -> int:
    """Remove the lines run_autocomplete wrote from ~/.bashrc (reference
    `run_unautocomplete`, :1311)."""
    import os
    rc = os.path.expanduser("~/.bashrc")
    if not os.path.exists(rc):
        print("nothing to remove")
        return 0
    with open(rc) as f:
        lines = f.readlines()
    kept = [ln for ln in lines if AUTOCOMPLETE_MARK not in ln]
    if len(kept) == len(lines):
        print("nothing to remove")
        return 0
    with open(rc, "w") as f:
        f.writelines(kept)
    print("bash completion removed")
    return 0


VERBS = {"master": run_master, "volume": run_volume, "server": run_server,
         "shell": run_shell, "upload": run_upload, "backup": run_backup,
         "master.follow": run_master_follow, "export": run_export,
         "compact": run_compact, "version": run_version,
         "download": run_download, "fix": run_fix,
         "benchmark": run_benchmark, "filer": run_filer,
         "filer.copy": run_filer_copy, "filer.meta.tail": run_filer_meta_tail,
         "filer.cat": run_filer_cat, "filer.meta.backup": run_filer_meta_backup,
         "s3": run_s3, "iam": run_iam, "webdav": run_webdav,
         "filer.backup": run_filer_backup, "filer.sync": run_filer_sync,
         "geo.sync": run_geo_sync, "filer.replicate": run_filer_replicate,
         "mq.broker": run_mq_broker,
         "filer.remote.sync": run_filer_remote_sync,
         "filer.remote.gateway": run_filer_remote_gateway,
         "mount": run_mount, "fuse": run_fuse, "ftp": run_ftp,
         "scaffold": run_scaffold, "update": run_update,
         "autocomplete": run_autocomplete,
         "unautocomplete": run_unautocomplete}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in VERBS:
        print(f"usage: python -m seaweedfs_tpu_torch {{{','.join(VERBS)}}} "
              "[flags]", file=sys.stderr)
        return 2
    _init_tls()
    return VERBS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
