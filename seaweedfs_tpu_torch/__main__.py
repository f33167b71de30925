"""Command line of the port: ``python -m seaweedfs_tpu_torch volume ...``.

The counterpart of the JAX package's `run_volume` with `_add_volume_flags`
(seaweedfs_tpu/__main__.py:115, :203): a volume server that serves HTTP and
gRPC and heartbeats to `-mserver`. It runs on the card unless `-device cpu`
is asked for, and exits non-zero on a host without one. `-jwtSigningKey`,
`-jwtReadSigningKey` and `-whiteList` build its security guard (reference
`_add_security_flags` and `_make_guard`, :87-96) from the flags alone: the
security.toml tier waits for a port of utils/config.
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
    # empty keys keep security off, as in the reference's default
    p.add_argument("-jwtSigningKey", default="")
    p.add_argument("-jwtReadSigningKey", default="")
    p.add_argument("-whiteList", default="",
                   help="comma-separated IPs/CIDRs allowed without jwt")


def _make_guard(opt):
    """The security guard of the flags, or None when every one is empty."""
    from .security import Guard
    if not (opt.jwtSigningKey or opt.jwtReadSigningKey or opt.whiteList):
        return None
    return Guard(white_list=[s for s in opt.whiteList.split(",") if s],
                 signing_key=opt.jwtSigningKey,
                 read_signing_key=opt.jwtReadSigningKey)


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
                      guard=_make_guard(opt))
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
    return VERBS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
