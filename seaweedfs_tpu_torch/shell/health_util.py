"""Shared fetch-or-recompute health report for shell commands.

`cluster.check` and `cluster.repair` both need the same input: the
cluster health report (master/health.py shape). With -url it comes from
the master's live engine at /cluster/health (accurate staleness +
stripe-width high-water marks); without it the identical scoring runs
locally over a VolumeList topology dump, probing one holder per EC
volume for its true RS(k,m) — a dump alone undercounts expected_n when
the HIGHEST shard ids are the lost ones. Extracted here so the fetch
logic, the geometry probe, and their failure modes are fixed in one
place instead of drifting between the two commands.

The port's copy of seaweedfs_tpu/shell/health_util.py.
"""

from __future__ import annotations

from ..pb import volume_server_pb2 as vpb
from ..utils.rpc import Stub, VOLUME_SERVICE


def fetch_master_json(base_url: str, path: str, params: "dict | None" = None,
                      timeout: float = 10.0, max_hops: int = 3) -> dict:
    """GET a master HTTP endpoint, following 421 leader redirects.

    Leader-resident endpoints (/cluster/telemetry, the write paths)
    answer 421 Misdirected Request on a follower with the leader's
    FSM-advertised HTTP address in the body's `leader_http` field —
    follow it (bounded hops: elections can bounce the hint) instead of
    handing the operator a JSON error dict that quacks like a report."""
    from ..client import http_util

    url = base_url.rstrip("/")
    if not url.startswith("http"):
        url = f"http://{url}"
    last_err = "no hops attempted"
    for _ in range(max_hops):
        r = http_util.get(f"{url}{path}", params=params, timeout=timeout)
        try:
            body = r.json()
        except ValueError:
            raise RuntimeError(
                f"non-JSON response from {url}{path} ({r.status})") from None
        if r.status == 421:
            nxt = body.get("leader_http", "")
            last_err = body.get("error", "not leader")
            if not nxt:
                break  # follower without a usable hint — report as-is
            url = f"http://{nxt}"
            continue
        if r.status != 200:
            raise RuntimeError(body.get("error") or f"HTTP {r.status}")
        return body
    raise RuntimeError(f"no leader answered {path}: {last_err}")


def fetch_link_costs(url: str = "", override: str = "",
                     timeout: float = 5.0):
    """The geo LinkCostModel a shell planner should price moves with:
    an explicit `-linkCosts` override (inline JSON or file) wins, else
    the master's policy from /cluster/linkcosts (so shell plans match
    the cron's), else the defaults. The fetch is best-effort — a master
    too old to serve the route must not break volume.balance."""
    from ..geo.policy import LinkCostModel, load_link_costs, parse_link_costs
    if override:
        return load_link_costs(override)
    if url:
        try:
            return parse_link_costs(
                fetch_master_json(url, "/cluster/linkcosts",
                                  timeout=timeout))
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (older master: default pricing, not a failed plan)
            pass
    return LinkCostModel()


def fetch_or_compute_health(env, url: str = "", timeout: float = 10.0) -> dict:
    """The health report, from the master's engine (`url`) or recomputed
    locally from a topology dump. Raises on an unreachable -url (the
    caller asked for the live engine; silently degrading to a dump would
    hide a dead master)."""
    if url:
        return fetch_master_json(url, "/cluster/health", timeout=timeout)

    from ..master.health import evaluate, snapshot_from_topology_info

    resp = env.mc.volume_list()
    ti = resp.topology_info
    ec_holders: dict[int, list[tuple[str, int]]] = {}
    for dc in ti.data_center_infos:
        for rack in dc.rack_infos:
            for node in rack.data_node_infos:
                for disk in node.disk_infos.values():
                    for s in disk.ec_shard_infos:
                        ec_holders.setdefault(s.id, []).append(
                            (node.id, node.grpc_port))

    def probe_geometry(vid, present_ids):
        # one holder knows the stripe's true RS(k,m) from its .vif
        for node_id, gport in ec_holders.get(vid, ()):
            try:
                info = Stub(env.grpc_addr(node_id, gport),
                            VOLUME_SERVICE).call(
                    "VolumeEcShardsInfo",
                    vpb.VolumeEcShardsInfoRequest(volume_id=vid),
                    vpb.VolumeEcShardsInfoResponse, timeout=5)
                if info.data_shards:
                    return (info.data_shards + info.parity_shards,
                            info.parity_shards)
            except Exception:  # noqa: BLE001 — try the next holder
                continue
        return (max(present_ids) + 1) if present_ids else 0

    snap = snapshot_from_topology_info(
        ti, volume_size_limit=resp.volume_size_limit_mb << 20,
        expected_n_of=probe_geometry)
    return evaluate(snap)
