"""Command line of the port: ``python -m seaweedfs_tpu_torch volume ...``.

The counterpart of the JAX package's `run_volume` with `_add_volume_flags`
(seaweedfs_tpu/__main__.py:115, :203): a volume server that serves HTTP and
gRPC and heartbeats to `-mserver`. It runs on the card unless `-device cpu`
is asked for, and exits non-zero on a host without one. `-jwtSigningKey`,
`-jwtReadSigningKey` and `-whiteList` build its security guard (reference
`_add_security_flags` and `_make_guard`, :87-114): flags win, and an absent
flag falls back to security.toml on the config tier chain (utils/config).
The `[grpc]` section of that file (ca, cert, key) puts every gRPC server and
stub of the process under mTLS before any starts (reference `_init_tls`,
:1366); a partial section refuses to start. `-qosPolicy` (a JSON file,
reloaded when it changes) turns on QoS admission.
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
    p.add_argument("-pulseSeconds", type=float, default=2.0)
    p.add_argument("-qosPolicy", default="",
                   help="QoS policy JSON file (tenant/class token buckets, "
                        "weights), reloaded when it changes; empty = "
                        "admission off")
    # empty keys keep security off, as in the reference's default
    p.add_argument("-jwtSigningKey", default="")
    p.add_argument("-jwtReadSigningKey", default="")
    p.add_argument("-whiteList", default="",
                   help="comma-separated IPs/CIDRs allowed without jwt")


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


def run_volume(argv) -> int:
    from .ec.locate import EcGeometry
    from .ops.coder import resolve_device
    from .server.grpc_service import serve_volume
    from .server.volume_server import VolumeServer
    from .storage.disk_location import DiskLocation
    from .storage.store import Store

    p = argparse.ArgumentParser(prog="volume")
    _volume_flags(p)
    opt = p.parse_args(argv)
    resolve_device(opt.device)  # no card and no -device cpu: refuse
    geo = EcGeometry(*_parse_ec_shards(opt.ecShards)) if opt.ecShards else None
    store = Store(opt.ip, opt.port, f"{opt.ip}:{opt.port}",
                  [DiskLocation(opt.dir, opt.disk, opt.max)],
                  ec_geometry=geo, coder_name=opt.coder, ec_codec=opt.codec,
                  device=opt.device)
    vs = VolumeServer(store, ip=opt.ip, port=opt.port,
                      data_center=opt.dataCenter, rack=opt.rack,
                      pulse_seconds=opt.pulseSeconds,
                      guard=_make_guard(opt),
                      qos_policy=opt.qosPolicy or None)
    served = serve_volume(vs, opt.grpcPort, master=opt.mserver)
    print(f"volume server {vs.url} (grpc :{vs.grpc_port}, {vs.device}) "
          f"heartbeating to {opt.mserver}", flush=True)
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    served.stop()
    return 0


VERBS = {"volume": run_volume}


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
