"""Shell commands for the multi-tenant QoS plane (qos/).

The port's copy of seaweedfs_tpu/shell/qos_commands.py.
"""

from __future__ import annotations

import json

from .commands import CommandEnv, command


def _fetch_qos(addr: str) -> dict:
    from ..client import http_util
    return http_util.get(f"http://{addr}/debug/qos", timeout=5).json()


def _print_qos(env: CommandEnv, addr: str, payload: dict) -> None:
    state = "enabled" if payload.get("enabled") else "disabled"
    totals = payload.get("totals") or {}
    env.println(f"{addr}: qos {state} "
                f"(admitted {totals.get('admitted', 0)}, "
                f"shed {totals.get('shed', 0)})")
    node = payload.get("node") or {}
    if node:
        env.println(f"  node: {json.dumps(node)}")
    for klass, st in (payload.get("classes") or {}).items():
        extras = {k: v for k, v in st.items() if k != "max_wait_s"}
        if extras.get("inflight") or len(extras) > 1:
            env.println(f"  class {klass}: {json.dumps(st)}")
    tenants = payload.get("tenants") or []
    if not tenants:
        env.println("  (no tenant state yet)")
        return
    env.println(f"  {'tenant':<20} {'weight':>6} {'admitted':>9} "
                f"{'shed':>6} {'bytes':>12} {'inflight':>8} queued")
    for t in tenants:
        env.println(
            f"  {t.get('tenant', '?'):<20} {t.get('weight', 0):>6} "
            f"{t.get('admitted', 0):>9} {t.get('shed', 0):>6} "
            f"{t.get('bytes', 0):>12} {t.get('inflight', 0):>8} "
            f"{json.dumps(t.get('queued') or {})}")


@command("qos.status",
         "show live QoS scheduler state (buckets, queues, per-tenant "
         "counters) from every volume server, or one -url host:port")
def cmd_qos_status(env: CommandEnv, args: list):
    """qos.status [-url host:port]

    Without -url, walks the master topology and dumps /debug/qos from
    every registered volume server. With -url, queries that one server
    (any enforcement point: a volume server or an S3 gateway whose
    operator gate admits the request)."""
    import argparse
    p = argparse.ArgumentParser(prog="qos.status")
    p.add_argument("-url", default="")
    opt = p.parse_args(args)
    targets = ([opt.url] if opt.url else
               [s["id"] for s in env.collect_volume_servers()])
    if not targets:
        env.println("no volume servers registered")
        return
    failures = 0
    for addr in targets:
        try:
            payload = _fetch_qos(addr)
        except Exception as e:  # noqa: BLE001 — report per node, keep going
            env.println(f"{addr}: unreachable ({e})")
            failures += 1
            continue
        _print_qos(env, addr, payload)
    if failures == len(targets):
        raise RuntimeError("qos.status: every target unreachable")
