"""Master server: heartbeat ingest, client vid-map push, assign/lookup.

Reference: weed/server/master_server.go:83, master_grpc_server.go:62
(SendHeartbeat), :253 (KeepConnected), master_grpc_server_assign.go:38
(Assign), master_grpc_server_volume.go:186 (LookupEcVolume).

The port's copy of seaweedfs_tpu/master/master_server.py: the whole gRPC
service, heartbeats, assign with fid leases, lookups, the admin lock, the
janitor, the health engine, the admin cron, every HTTP route, the raft
quorum with its follower read cache (`-peers` with more than one master),
the leader-resident fleet telemetry with SLOs and the lifecycle plane.
One difference on purpose: a master in a quorum imports the codec
registry (and torch) before its raft node starts, where the reference's
cron imports it at its first ec line (see `start`).
"""

from __future__ import annotations

import queue
import random
import threading
import time

from ..pb import master_pb2 as pb
from ..storage.types import TTL, ReplicaPlacement, file_id
from ..utils import failpoints
from ..utils.log import logger
from ..utils.rpc import MASTER_SERVICE, RpcService, Stub, VOLUME_SERVICE, serve
from .sequencer import MemorySequencer, SnowflakeSequencer
from .topology import EcShardInfo, Topology, VolumeInfo
from .volume_growth import GrowRequest, VolumeGrowth
from .volume_layout import LayoutRegistry

log = logger("master")


class MasterServer:
    def __init__(self, ip: str = "127.0.0.1", port: int = 9333,
                 volume_size_limit_mb: int = 30_000,
                 default_replication: str = "000",
                 sequencer: str = "memory",
                 pulse_seconds: float = 5.0,
                 garbage_threshold: float = 0.3,
                 guard=None, http_port: int | None = None,
                 peers: list[str] | None = None,
                 raft_state_path: str | None = None,
                 maintenance_scripts: "list[str] | None" = None,
                 maintenance_interval_s: float | None = None,
                 maintenance_initial_delay_s: float | None = None,
                 maintenance_health_driven: bool = True,
                 metrics_gateway: str = "", metrics_interval_s: int = 15,
                 ec_parity_shards: int | None = None,
                 lifecycle_policy: str = "",
                 slo_policy: str = "",
                 link_costs: str = "",
                 telemetry_interval_s: float | None = None):
        self.ip = ip
        self.port = port
        self.address = f"{ip}:{port}"
        self.topo = Topology(volume_size_limit_mb * 1024 * 1024)
        self.layouts = LayoutRegistry(self.topo)
        self.growth = VolumeGrowth(self.topo, allocate_fn=self._allocate_volume,
                                   costs_fn=lambda: self.link_costs)
        # per-layout cooldown after a failed writableVolumeCount grow
        # (monotonic deadline); without it every assign on a full
        # cluster re-runs a doomed topology-wide allocation sweep
        self._want_growth_backoff: dict[tuple, float] = {}
        self.sequencer = (SnowflakeSequencer() if sequencer == "snowflake"
                          else MemorySequencer())
        self.default_replication = default_replication
        self.pulse_seconds = pulse_seconds
        self.garbage_threshold = garbage_threshold
        # Multi-master: a raft quorum elects the leader and replicates
        # MaxVolumeId (reference raft_server.go FSM); single master runs
        # leaderless-raft-free with is_leader pinned True.
        self.peers = [p for p in (peers or []) if p] or [self.address]
        self.raft = None
        self._follower = None   # FollowerVidCache when raft is on
        self._raft_state_path = raft_state_path
        # Optional security.Guard: when its signing_key is set, Assign
        # responses carry a single-fid JWT the volume server will demand
        # (reference master_grpc_server_assign.go JWT minting).
        self.guard = guard
        self._subscribers: dict[int, tuple[str, queue.Queue]] = {}
        # sid -> (address, client_type, version, created_at_ns,
        # grpc_port): the cluster membership ListClusterNodes reports
        # (reference cluster.go:104 tracks filers/brokers the same way)
        self._sub_meta: dict[int, tuple[str, str, str, int, int]] = {}
        self._sub_seq = 0
        self._sub_lock = threading.Lock()
        self._admin_locks: dict[str, tuple[int, int, str]] = {}  # name -> (token, ts, client)
        # HTTP status/metrics API (reference master_server_handlers*.go);
        # 0/None disables. gRPC stays on `port`, HTTP on its own port.
        self.http_port = http_port
        # (leader_grpc, leader_http) advertised through the raft FSM by
        # each new leader: followers serve it in 421 bodies so HTTP
        # clients (shell -url fetches) can follow to the leader without
        # guessing its HTTP port from a gRPC hint
        self._leader_http_hint: tuple[str, str] = ("", "")
        self._grpc = None
        self._http = None
        self._http_stop = None
        # profiling plane: loop-lag probe on the fastweb HTTP loop +
        # the process-shared continuous sampler (start()/stop())
        from ..profiling import LoopLagMonitor
        self._loop_lag = LoopLagMonitor("master")
        self._sampler = None
        self._stop = threading.Event()
        # optional push-gateway loop; started in start(), joined in stop()
        self.metrics_gateway = metrics_gateway
        self.metrics_interval_s = metrics_interval_s
        self._metrics_push = None
        # Self-driving maintenance (reference startAdminScripts
        # master_server.go:269): [] disables, None -> repair/balance defaults.
        # DisableVacuum/EnableVacuum RPC toggle: suppresses the cron's
        # vacuum line only (reference command_volume_vacuum_disable.go:
        # "volume.vacuum still works"). In-memory per-master, NOT raft-
        # replicated or persisted — matching the reference, whose flag is
        # a plain topology bool (topology.go:42 isDisableVacuum); operators
        # re-disable after a failover.
        self.vacuum_disabled = False
        # Health plane (master/health.py): scores the topology into
        # severity buckets every janitor tick and on /cluster/health.
        # Heartbeats don't carry RS(k,m), so the engine derives k from
        # each volume's observed stripe width minus the configured
        # parity count (fork default RS(14,2)).
        # Fid-range leases (batched ingest): Assign(count=N) is a lease —
        # the registry tracks outstanding grants for the
        # SeaweedFS_fid_leases_active gauge and supplies the TTL the
        # HTTP assign response advertises / the range JWT expires at.
        from .lease import FidLeaseRegistry
        self.fid_leases = FidLeaseRegistry()
        from .health import DEFAULT_PARITY_SHARDS, HealthEngine
        self.health = HealthEngine(
            self.topo,
            parity=(ec_parity_shards if ec_parity_shards is not None
                    else DEFAULT_PARITY_SHARDS),
            # stale = several missed pulses; stream death already
            # unregisters dead nodes, this catches wedged-but-connected
            stale_after_s=max(4 * pulse_seconds, 5.0))
        from .admin_cron import DEFAULT_INTERVAL_S, AdminCron
        # Tiered-storage lifecycle (lifecycle/): a policy FILE path
        # wires `lifecycle.apply` into the maintenance cron, so cooling
        # collections EC-encode, offload to the remote tier and promote
        # back on heat with zero operator commands. Served (with recent
        # transitions) at /debug/lifecycle.
        self.lifecycle_policy = lifecycle_policy
        if lifecycle_policy:
            import shlex as _shlex
            from .admin_cron import DEFAULT_SCRIPTS
            maintenance_scripts = list(
                DEFAULT_SCRIPTS if maintenance_scripts is None
                else maintenance_scripts)
            if not any(s.split()[:1] == ["lifecycle.apply"]
                       for s in maintenance_scripts):
                maintenance_scripts.append(
                    "lifecycle.apply -policy "
                    + _shlex.quote(lifecycle_policy))
        # health-driven: each sweep consumes the in-process engine's
        # report and runs planner->executor (maintenance/) in place of
        # the blind ec.rebuild / volume.fix.replication lines, falling
        # back to them if the scan itself fails
        self.admin_cron = AdminCron(
            self.address, scripts=maintenance_scripts,
            interval_s=maintenance_interval_s or DEFAULT_INTERVAL_S,
            initial_delay_s=maintenance_initial_delay_s,
            is_leader=lambda: self.is_leader,
            vacuum_enabled=lambda: not self.vacuum_disabled,
            health_fetch=(self.health.scan if maintenance_health_driven
                          else None),
            costs_fn=lambda: self.link_costs)
        # Fleet telemetry & SLO plane (telemetry/): a leader-resident
        # collector scrapes every node's exposition into a ring TSDB,
        # merges histograms into cluster percentiles, tracks heavy
        # hitters and evaluates burn-rate alerts. Follows raft
        # leadership exactly like the admin cron. `slo_policy` is a
        # JSON file path or inline JSON doc of objectives.
        self.slo_policy_source = slo_policy
        from ..telemetry import TelemetryCollector, parse_slo_policy
        policy = None
        if slo_policy:
            doc = slo_policy
            if not slo_policy.lstrip().startswith("{"):
                with open(slo_policy, encoding="utf-8") as f:
                    doc = f.read()
            policy = parse_slo_policy(doc)
        # Geo plane (geo/): the per-link cost model prices replica
        # growth, EC spread, repair fetches and balance moves in
        # cost-weighted bytes (intra_rack < cross_rack < cross_dc).
        # Same inline-JSON-or-file convention as -sloPolicy; the parsed
        # model feeds the placement engine, the raw doc is served at
        # /cluster/linkcosts so shell planners price moves identically.
        self.link_costs_source = link_costs
        from ..geo.policy import LinkCostModel, load_link_costs
        self.link_costs = (load_link_costs(link_costs) if link_costs
                           else LinkCostModel())
        self.telemetry = TelemetryCollector(
            node_id=f"master@{self.address}",
            targets_fn=self._telemetry_targets,
            is_leader=lambda: self.is_leader,
            interval_s=telemetry_interval_s,
            slo_policy=policy,
            local_scrape=self._local_scrape,
            health_stale_fn=self._telemetry_stale_nodes)
        # burning SLOs become health items: the cluster verdict reflects
        # user-facing objectives, not just structural integrity
        self.health.extra_items = self.telemetry.health_items

    @property
    def is_leader(self) -> bool:
        return self.raft.is_leader if self.raft is not None else True

    @property
    def leader_address(self) -> str:
        """Current known leader; empty during elections (clients treat an
        empty hint as 'retry elsewhere' rather than pinning a follower)."""
        if self.raft is None:
            return self.address
        if self.raft.is_leader:
            return self.address
        return self.raft.leader_address or ""

    # -- telemetry wiring ---------------------------------------------------
    def _telemetry_targets(self) -> list[dict]:
        """Scrape targets from live cluster membership: volume servers
        come from the heartbeat-fed topology, filers from the
        KeepConnected subscriber metadata (their metrics live under
        /__metrics__ because / is the filesystem namespace)."""
        targets = []
        for n in self.topo.all_nodes():
            targets.append({"node": f"volume@{n.id}",
                            "url": f"http://{n.url}/metrics",
                            "dc": n.rack.dc.id if n.rack else "",
                            "rack": n.rack.id if n.rack else ""})
        with self._sub_lock:
            metas = list(self._sub_meta.values())
        for address, client_type, _ver, _ts, _grpc in metas:
            if client_type == "filer" and address:
                targets.append({"node": f"filer@{address}",
                                "url": f"http://{address}/__metrics__"})
        return targets

    def _local_scrape(self) -> str:
        from ..stats import scrape_payload
        body, _ctype = scrape_payload()
        return body

    def _telemetry_stale_nodes(self) -> list[str]:
        """Health-plane staleness (missed heartbeats) -> telemetry node
        ids, so dead volume servers drop out of cluster merges even
        before their scrapes start failing."""
        report = self.health.last_report()
        return [f"volume@{nd['id']}" for nd in report.get("nodes", ())
                if nd.get("stale")]

    def _raft_apply(self, command: dict) -> None:
        """FSM apply (reference raft_server.go:53 StateMachine.Apply).
        Runs on every master as entries commit (the leader included), so
        all replicated control state lives here:

        - max_volume_id: vid allocation stays monotonic across leader
          changes (the reference FSM's only state).
        - seq_hwm: the sequencer high-water mark. The leader commits
          `key + count` BEFORE handing out [key, key+count), so a new
          leader's sequencer always starts past every range ever acked —
          zero duplicate fids across failovers, even when the granting
          leader died mid-lease-window.
        - lease: fid-range grant bookkeeping, so the leases-active gauge
          is correct on whichever master is scraped / becomes leader.
        - volume_new: layout mutations from growth, so a new leader's
          layout registry is warm before the first heartbeats arrive
          (locations still come from heartbeats; register is idempotent
          and the janitor drops locationless vids from writables).

        Lock order here is raft._lock -> {topo.lock, sequencer._lock,
        fid_leases._lock}; no path takes them in reverse."""
        mvid = command.get("max_volume_id")
        if mvid:
            with self.topo.lock:
                self.topo.max_volume_id = max(self.topo.max_volume_id, mvid)
        hwm = command.get("seq_hwm")
        if hwm:
            # set_max(seen) bumps past `seen`: next_id() returns >= hwm
            self.sequencer.set_max(hwm - 1)
        lease = command.get("lease")
        if lease:
            self.fid_leases.grant_replicated(int(lease.get("count", 1)),
                                             lease.get("ttl_s"))
        lh = command.get("leader_http")
        if lh:
            self._leader_http_hint = (lh.get("grpc", ""), lh.get("http", ""))
        vol = command.get("volume_new")
        if vol:
            v = VolumeInfo(
                id=int(vol["id"]), collection=vol.get("collection", ""),
                replica_placement=ReplicaPlacement.parse(
                    vol.get("replication", "")),
                ttl=TTL.parse(vol.get("ttl", "")),
                disk_type=vol.get("disk_type", "hdd") or "hdd")
            self.layouts.register_volume(v)

    def _on_raft_state(self, role: str, term: int,
                       leader: "str | None") -> None:
        """Published from the raft _run loop (outside the raft lock)
        whenever (role, term, leader) changes: step the maintenance
        plane up/down and point the follower read cache at the new
        leader promptly instead of on its next poll."""
        lead = role == "leader"
        log.info("%s: raft %s (term %d, leader %s)", self.address, role,
                 term, leader or "?")
        if lead:
            # stale growth backoffs from a previous leadership stint
            # must not delay this leader's first growth
            self._want_growth_backoff.clear()
            if self.http_port:
                # advertise this leader's HTTP address through the FSM
                # (propose blocks on commit, so not on the raft loop)
                threading.Thread(
                    target=self._advertise_leader_http, daemon=True,
                    name="leader-http-advertise").start()
        self.admin_cron.notify_leadership(lead)
        self.telemetry.notify_leadership(lead)
        if self._follower is not None:
            self._follower.poke()

    def _advertise_leader_http(self) -> None:
        if self.raft is None:
            return
        try:
            self.raft.propose({"leader_http": {
                "grpc": self.address,
                "http": f"{self.ip}:{self.http_port}"}})
        except Exception as e:  # noqa: BLE001 — best-effort hint
            log.warning("leader http advertise failed: %s", e)

    def lookup_locations(self, vid: int) -> "tuple[list[dict] | None, str]":
        """(locations, source) for a vid. The leader answers from its
        heartbeat-fed topology (`topo`); a follower answers from the
        replicated read cache (`follower`, bounded staleness). (None,
        "redirect") means the caller must send the client to the leader —
        a follower never serves an authoritative miss (write barrier);
        (None, "miss") is the leader's authoritative not-found."""
        if self.is_leader or self.raft is None:
            nodes = self.topo.lookup(vid)
            if nodes:
                return ([{"url": n.url, "public_url": n.public_url,
                          "grpc_port": n.grpc_port} for n in nodes], "topo")
            return (None, "miss")
        # a deposed leader's topology is stale until its heartbeat
        # streams die; only the replicated cache is staleness-bounded
        if self._follower is not None:
            locs = self._follower.lookup(vid)
            if locs:
                return (locs, "follower")
        return (None, "redirect")

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        from ..profiling import acquire_sampler
        self._sampler = acquire_sampler()
        svc = self._build_service()
        services = [svc]
        if len(self.peers) > 1:
            from .follower import FollowerVidCache
            from .raft import RaftNode
            self.raft = RaftNode(self.address, self.peers,
                                 self._raft_apply,
                                 state_path=self._raft_state_path)
            self.raft.on_state_change = self._on_raft_state
            # while we are NOT the leader, mirror the leader's vid map so
            # /dir/lookup can be served here (bounded staleness)
            self._follower = FollowerVidCache(
                self.address,
                leader_of=lambda: (None if self.raft.is_leader
                                   else self.raft.leader_address))
            services.append(self.raft.build_service())
        key = self.guard.signing_key if self.guard is not None else ""
        if key:
            from ..utils.rpc import set_cluster_key
            set_cluster_key(key)
        self._grpc = serve(f"{self.ip}:{self.port}", services, auth_key=key)
        if self.raft is not None:
            if self.admin_cron.scripts:
                # the cron's ec lines import the codec registry, and torch
                # with it, at their first run: torch's first import holds
                # the GIL for seconds, long enough for this master to miss
                # its raft heartbeats and be deposed mid-sweep (a new
                # leader's cron then runs the same line again), so it is
                # imported before the node joins its quorum
                from ..ops.coder import registered_codecs
                registered_codecs()
            self.raft.start()
            self._follower.start()
        if self.http_port:
            self._start_http()
        threading.Thread(target=self._janitor, daemon=True,
                         name="master-janitor").start()
        self.admin_cron.start()
        self.telemetry.start()
        if self.metrics_gateway:
            from ..stats import start_push_loop
            self._metrics_push = start_push_loop(
                self.metrics_gateway, f"master-{self.address}",
                self.metrics_interval_s)
        log.info("master up at %s (leader)", self.address)

    def stop(self) -> None:
        self._stop.set()
        self.admin_cron.stop()
        self.telemetry.stop()
        if self._metrics_push is not None:
            self._metrics_push.stop()
        if self._follower is not None:
            self._follower.stop()
        if self.raft is not None:
            self.raft.stop()
        if self._grpc:
            self._grpc.stop(grace=0.5)
        if self._http_stop is not None:
            self._http_stop.set()
        self._loop_lag.close()
        if getattr(self, "_sampler", None) is not None:
            from ..profiling import release_sampler
            release_sampler()
            self._sampler = None

    def _start_http(self) -> None:
        """Status/metrics HTTP API (reference master_server_handlers.go:
        /dir/status topology dump, /dir/assign, /dir/lookup, /metrics).

        Served by utils/fastweb so keep-alive /dir/assign costs ~100 us
        round-trip — high-rate small-file writers assign here instead of
        paying Python-grpcio's ~300 us unary overhead."""
        import urllib.parse as _up

        from google.protobuf.json_format import MessageToDict

        from ..utils import fastweb
        from ..utils.fastweb import json_response

        ms = self

        def params_of(req: fastweb.Request) -> dict:
            # form-encoded bodies merge into the query params (the
            # reference Go master reads both via r.FormValue)
            q = req.query
            ctype = req.headers.get("Content-Type", "")
            if req.body and "application/x-www-form-urlencoded" in ctype:
                q = dict(q)
                q.update(_up.parse_qsl(req.body.decode(errors="replace")))
            return q

        def guarded(path: str, handler):
            # The reference wraps master HTTP handlers in guard.WhiteList
            # only; JWT gating applies just to the mutating /dir/assign.
            # /metrics stays open for scrapers. Params are parsed once and
            # handed to the handler (the assign hot path budget is ~100us).
            def h(req: fastweb.Request):
                q = params_of(req)
                if ms.guard is not None:
                    if path == "/dir/assign":
                        ok, why = ms.guard.check_write(req.remote, q,
                                                       req.headers)
                    else:
                        ok, why = ms.guard.check_ip(req.remote)
                    if not ok:
                        return json_response({"error": why}, status=401)
                return handler(req, q)
            return h

        # Handler policy on the single-loop fastweb server: the hot/cheap
        # handlers (assign, lookup, metrics, cluster status) run inline —
        # they are microseconds and an executor hop would double the
        # /dir/assign fast path's cost. Anything that can take visible
        # time (profiling, full-topology dumps, the HTML UI) is offloaded
        # to a thread so it cannot head-of-line-block assigns.
        def offloaded(handler):
            import asyncio
            import contextvars

            async def h(req):
                # carry the active trace span across the executor hop
                ctx = contextvars.copy_context()
                return await asyncio.get_running_loop().run_in_executor(
                    None, ctx.run, handler, req)
            return h

        def metrics(req):
            from ..stats import scrape_payload
            body, ctype = scrape_payload(req.headers.get("Accept", ""))
            return fastweb.Response(body.encode(), content_type=ctype)

        def debug_traces(req, q):
            from .. import tracing
            return json_response(tracing.debug_traces_payload(q))

        def debug_events(req, q):
            from ..ops import events
            return json_response(events.debug_events_payload(q))

        def cluster_health(req, q):
            # a fresh scan per request: the operator asking "is data at
            # risk NOW" must not get a stale janitor-tick answer
            return json_response(ms.health.scan())

        def cluster_telemetry(req, q):
            # leader-resident: only the leader scrapes the fleet, so a
            # follower redirects (421 + hint) like the write paths
            if not ms.is_leader:
                return not_leader_response()
            if q.get("trigger"):
                # force one scrape/evaluate cycle now (tests, bench and
                # `cluster.top -watch` first paint all need fresh data
                # without waiting out the jittered interval)
                ms.telemetry.trigger()
            try:
                top = int(q.get("top", "10") or 10)
            except ValueError:
                top = 10
            # ?profile=1 folds the fleet-merged flamegraph into the
            # snapshot (cluster.profile's fetch); off by default — the
            # folded stacks dwarf the rest of the payload
            return json_response(ms.telemetry.snapshot(
                top_limit=top, include_profile=bool(q.get("profile"))))

        def dir_status(req, q):
            # leader_address, not ms.address: a follower answering here
            # must hint at the real leader (empty mid-election)
            return json_response({"Topology": MessageToDict(ms.topology_info()),
                                  "Leader": ms.leader_address,
                                  "IsLeader": ms.is_leader})

        def not_leader_response():
            # typed redirect: 421 Misdirected Request + the leader hint
            # in the body (the hint is a gRPC address, so no Location
            # header — master_client follows the `leader` field)
            hint = ms.leader_address
            # FSM-advertised HTTP address, served only while it matches
            # the CURRENT leader (a hint from a deposed leader would
            # bounce the client to another follower at best)
            lh_grpc, lh_http = ms._leader_http_hint
            return json_response(
                {"error": (f"not leader; leader is {hint}" if hint
                           else "not leader; leader unknown"),
                 "leader": hint,
                 "leader_http": (lh_http if hint and lh_grpc == hint
                                 else "")}, status=421)

        def dir_lookup(req, q):
            from .. import tracing
            from ..stats import MASTER_LOOKUP_COUNTER
            with tracing.start_span(
                    "master.lookup", component="master",
                    child_of=tracing.extract(req.headers),
                    attrs={"vid": q.get("volumeId", "")}):
                vid = q.get("volumeId", "").split(",")[0]
                try:
                    locs, source = ms.lookup_locations(int(vid))
                except ValueError:
                    locs, source = None, "miss"
                MASTER_LOOKUP_COUNTER.inc(source)
                if locs:
                    body = {"volumeId": vid,
                            "locations": [{"url": l["url"],
                                           "publicUrl": l["public_url"]}
                                          for l in locs]}
                    if source == "follower":
                        # bounded-staleness answer from a non-leader:
                        # advertise where authority lives
                        body["leader"] = ms.leader_address
                    return json_response(body)
                if source == "redirect":
                    # write barrier: a follower never 404s a vid — the
                    # assign may simply not have replicated here yet
                    return not_leader_response()
                return json_response(
                    {"error": f"volume {vid} not found"}, status=404)

        async def dir_assign(req, q):
            from .. import tracing
            with tracing.start_span(
                    "master.assign", component="master",
                    child_of=tracing.extract(req.headers),
                    attrs={"collection": q.get("collection", "")}) as sp:
                try:
                    areq = pb.AssignRequest(
                        count=int(q.get("count", 1)),
                        collection=q.get("collection", ""),
                        replication=q.get("replication", ""),
                        ttl=q.get("ttl", ""),
                        disk_type=q.get("disk_type", ""),
                        # placement preferences (reference
                        # /dir/assign?dataCenter=&rack=): honored by
                        # VolumeGrowth when the assign has to grow
                        data_center=q.get("dataCenter", ""),
                        rack=q.get("rack", ""),
                        writable_volume_count=int(
                            q.get("writableVolumeCount", 0)))
                except ValueError as e:
                    # malformed numerics are a deterministic client
                    # error, not a retryable 500
                    return json_response({"error": f"bad assign: {e}"},
                                         status=400)
                # executor dispatches carry the contextvars context so
                # the growth path's AllocateVolume RPCs inherit this
                # span's trace instead of starting orphan roots
                # (run_in_executor, unlike asyncio.to_thread, does not
                # copy the context)
                import contextvars

                if ms.raft is not None or ms.needs_growth(areq):
                    # growth does AllocateVolume RPCs + a raft commit —
                    # seconds, not microseconds: run it off-loop so other
                    # assigns/lookups/scrapes aren't head-of-line blocked.
                    # With raft on, EVERY assign commits its fid range
                    # through the log (quorum RPCs that can block for the
                    # propose timeout during an election) — so the whole
                    # raft-mode assign path runs off-loop too; follower
                    # lookups stay responsive through election storms.
                    import asyncio
                    if ms.raft is None:
                        sp.add_event("volume_growth")
                    resp = await asyncio.get_running_loop().run_in_executor(
                        None, contextvars.copy_context().run,
                        ms.do_assign, areq)
                else:
                    # inline fast path NEVER grows: a concurrent assign may
                    # have filled the last writable between the check above
                    # and here (TOCTOU) — the sentinel re-dispatches that
                    # loser to the executor instead of blocking the loop
                    resp = ms.do_assign(areq, allow_growth=False)
                    if resp.error == ms.NEEDS_GROWTH:
                        import asyncio
                        sp.add_event("volume_growth")
                        resp = await asyncio.get_running_loop(
                            ).run_in_executor(
                                None, contextvars.copy_context().run,
                                ms.do_assign, areq)
                if resp.error:
                    sp.set_error(resp.error)
                    if resp.error.startswith("not leader"):
                        return not_leader_response()
                    return json_response({"error": resp.error}, status=406)
                sp.set_attr("fid", resp.fid)
                body = {
                    "fid": resp.fid, "count": resp.count,
                    "url": resp.location.url,
                    "publicUrl": resp.location.public_url,
                    "auth": resp.auth}
                if resp.count > 1:
                    # fid-range lease: spell the range out so clients
                    # need no fid arithmetic of their own — first key as
                    # hex (snowflake keys overflow JSON float precision),
                    # the shared cookie, the advertised TTL, and the
                    # replica set the lease's volume lives on
                    from ..storage.types import parse_file_id
                    vid, key, cookie = parse_file_id(resp.fid)
                    body.update({
                        "keyHex": f"{key:x}", "cookie": cookie,
                        "leaseTtlS": ms.fid_leases.ttl_s,
                        "replicas": [{"url": r.url,
                                      "publicUrl": r.public_url}
                                     for r in resp.replicas]})
                return json_response(body)

        def cluster_status(req, q):
            # `leader` (lowercase) is the stable client-facing hint the
            # redirect protocol uses; `Leader` stays for the reference-
            # compatible status shape
            return json_response({
                "IsLeader": ms.is_leader,
                "Leader": ms.leader_address,
                "leader": ms.leader_address,
                "Peers": [p for p in ms.peers if p != ms.address]})

        def ui(req, q):
            # human status UI (reference weed/server/master_ui)
            from ..utils.ui import render_page
            rows = []
            with ms.topo.lock:  # heartbeats mutate per-disk dicts
                nodes = list(ms.topo.all_nodes())
                for node in nodes:
                    vols = list(node.all_volumes())
                    ecs = list(node.all_ec_shards())
                    rack = getattr(node.rack, "id", "-") or "-"
                    rows.append([
                        node.id, rack, len(vols), len(ecs),
                        f"{sum(v.size for v in vols) >> 20} MB"])
            page = render_page(
                f"swtpu master {ms.address}",
                {"Leader": ms.leader_address or "(electing)",
                 "IsLeader": ms.is_leader,
                 "Peers": ", ".join(p for p in ms.peers
                                    if p != ms.address) or "-",
                 "Volume servers": len(nodes),
                 "Max volume id": ms.topo.max_volume_id,
                 "Vacuum automation":
                     "disabled" if ms.vacuum_disabled else "on"},
                [("Volume servers",
                  ["node", "rack", "volumes", "ec volumes", "bytes"], rows)])
            return fastweb.html_response(page)

        def debug_profile(req, q):
            # pprof-style CPU profile trigger (reference exposes
            # net/http/pprof on -debug.port, command/imports.go:4);
            # shared implementation (profiling.handle_profile_query):
            # seconds validation/clamp, continuous/summary modes, hz
            # retune — all four daemons serve the identical contract
            from .. import profiling as prof
            code, ctype, body = prof.handle_profile_query(q)
            return fastweb.Response(body.encode(), status=code,
                                    content_type=ctype)

        def debug_flight(req, q):
            # slowest/errored request ring (profiling/flight.py) —
            # mostly volume-server entries in real deployments, but the
            # endpoint exists on every daemon so the operator never
            # guesses which port carries it
            from .. import profiling as prof
            code, payload = prof.debug_flight_payload(q)
            return json_response(payload, status=code)

        def debug_locks(req, q):
            # lock-order cycles + long holds from the SWTPU_LOCKCHECK=1
            # runtime detector (utils/locktrack.py); cheap no-op payload
            # when the detector is off
            from ..utils import locktrack
            return json_response(locktrack.debug_locks_payload(q))

        def debug_lifecycle(req, q):
            """Lifecycle plane status: the configured policy (parsed
            fresh so edits to the file show without a restart) and the
            recent lifecycle.* journal events — the cron's transitions
            run in THIS process, so its plan/transition/skip history is
            one filter away."""
            from ..ops import events
            policy = None
            err = ""
            if ms.lifecycle_policy:
                try:
                    from ..lifecycle import parse_policy
                    policy = parse_policy(ms.lifecycle_policy).to_doc()
                except Exception as e:  # noqa: BLE001 — show, don't 500
                    err = str(e)
            qq = dict(q)
            qq["type"] = "lifecycle."
            return json_response({
                "policy": policy, "source": ms.lifecycle_policy,
                "policy_error": err,
                "recent": events.debug_events_payload(qq)})

        def cluster_linkcosts(req, q):
            """The master's parsed link-cost model, as a policy doc —
            shell balance planners fetch it so their cost-weighted plans
            match what the master's own cron would produce."""
            return json_response(ms.link_costs.to_doc())

        app = fastweb.FastApp()
        app.route("/metrics", metrics)
        # CPU by thread class, counted at each scrape of /metrics
        from ..profiling import THREAD_CPU
        THREAD_CPU.install()
        app.route("/dir/status", offloaded(guarded("/dir/status", dir_status)))
        app.route("/dir/lookup", guarded("/dir/lookup", dir_lookup))
        app.route("/dir/assign", guarded("/dir/assign", dir_assign))
        app.route("/cluster/status", guarded("/cluster/status", cluster_status))
        app.route("/", offloaded(guarded("/", ui)))
        app.route("/debug/profile",
                  offloaded(guarded("/debug/profile", debug_profile)))
        # guarded like /debug/profile (flight entries carry fids, paths
        # and admit-time queue state)
        app.route("/debug/flight",
                  offloaded(guarded("/debug/flight", debug_flight)))
        # guarded like /debug/profile (spans carry fids and peer
        # addresses) and offloaded: snapshotting + serializing thousands
        # of spans must not head-of-line-block inline assigns
        app.route("/debug/traces",
                  offloaded(guarded("/debug/traces", debug_traces)))
        # same policy: events carry node addresses and volume ids, and a
        # full-topology health scan is milliseconds, not microseconds
        app.route("/debug/events",
                  offloaded(guarded("/debug/events", debug_events)))
        # guarded like the other /debug routes (stacks leak paths)
        app.route("/debug/locks",
                  offloaded(guarded("/debug/locks", debug_locks)))
        app.route("/cluster/health",
                  offloaded(guarded("/cluster/health", cluster_health)))
        app.route("/cluster/telemetry",
                  offloaded(guarded("/cluster/telemetry", cluster_telemetry)))
        app.route("/cluster/linkcosts",
                  guarded("/cluster/linkcosts", cluster_linkcosts))
        # guarded+offloaded like the other /debug routes (the journal
        # filter walks the whole ring)
        app.route("/debug/lifecycle",
                  offloaded(guarded("/debug/lifecycle", debug_lifecycle)))

        self._http_stop = threading.Event()
        threading.Thread(
            target=fastweb.serve_fast_app,
            args=(app, self.ip, self.http_port, self._http_stop),
            kwargs={"logger": log, "on_loop": self._loop_lag.attach},
            daemon=True,
            name="master-http").start()
        log.info("master http api on %s:%d", self.ip, self.http_port)

    # -- volume allocation RPC out to volume servers ------------------------
    def _allocate_volume(self, node, vid: int, req: GrowRequest) -> None:
        stub = Stub(node.grpc_address, VOLUME_SERVICE)
        from ..pb import volume_server_pb2 as vpb
        stub.call("AllocateVolume", vpb.AllocateVolumeRequest(
            volume_id=vid, collection=req.collection,
            replication=req.replication, ttl=req.ttl,
            disk_type=req.disk_type), vpb.AllocateVolumeResponse)
        # optimistic local registration; the next heartbeat confirms
        v = VolumeInfo(id=vid, collection=req.collection,
                       replica_placement=ReplicaPlacement.parse(req.replication),
                       ttl=TTL.parse(req.ttl), disk_type=req.disk_type)
        self.topo.incremental_volumes(node, [v], [])
        self.layouts.register_volume(v)
        if self.raft is not None and self.raft.is_leader:
            # replicate the layout mutation (and the vid watermark) so a
            # new leader knows this volume before its first heartbeat;
            # a failed commit is non-fatal — the volume exists on the
            # server and heartbeats will resync it
            if not self.raft.propose(
                    {"max_volume_id": self.topo.max_volume_id,
                     "volume_new": {"id": vid, "collection": req.collection,
                                    "replication": req.replication,
                                    "ttl": req.ttl,
                                    "disk_type": req.disk_type}},
                    timeout=2.0):
                log.warning("volume_new vid=%d not committed (no quorum); "
                            "heartbeats will resync", vid)
        from ..ops import events
        events.emit("volume.grow", vid=vid, collection=req.collection,
                    replication=req.replication, node=node.id)
        self._broadcast_location(node, new_vids=[vid])

    # -- broadcast to KeepConnected subscribers ------------------------------
    def _broadcast(self, msg: pb.KeepConnectedResponse) -> None:
        with self._sub_lock:
            for _, q in self._subscribers.values():
                try:
                    q.put_nowait(msg)
                except queue.Full:
                    pass

    def _broadcast_location(self, node, new_vids=(), deleted_vids=(),
                            new_ec=(), deleted_ec=()) -> None:
        self._broadcast(pb.KeepConnectedResponse(volume_location=pb.VolumeLocation(
            url=node.url, public_url=node.public_url, grpc_port=node.grpc_port,
            data_center=node.rack.dc.id if node.rack else "",
            new_vids=list(new_vids), deleted_vids=list(deleted_vids),
            new_ec_vids=list(new_ec), deleted_ec_vids=list(deleted_ec))))

    # -- gRPC service --------------------------------------------------------
    def _build_service(self) -> RpcService:
        svc = RpcService(MASTER_SERVICE)
        ms = self

        @svc.stream_stream("SendHeartbeat", pb.Heartbeat, pb.HeartbeatResponse)
        def send_heartbeat(request_iter, context):
            node = None
            try:
                for hb in request_iter:
                    from ..stats import MASTER_RECEIVED_HEARTBEATS
                    MASTER_RECEIVED_HEARTBEATS.inc()
                    node = ms._handle_heartbeat(hb, node)
                    yield pb.HeartbeatResponse(
                        volume_size_limit=ms.topo.volume_size_limit,
                        leader=ms.leader_address)
            finally:
                if node is not None:
                    vids, ec_vids = ms.topo.unregister_node(node)
                    log.info("node %s disconnected; dropped %d vols %d ec",
                             node.id, len(vids), len(ec_vids))
                    from ..ops import events
                    events.emit("node.leave", severity=events.WARN,
                                node=node.id, volumes=len(vids),
                                ec_volumes=len(ec_vids))
                    ms._broadcast_location(node, deleted_vids=vids,
                                           deleted_ec=ec_vids)

        @svc.stream_stream("KeepConnected", pb.KeepConnectedRequest,
                           pb.KeepConnectedResponse)
        def keep_connected(request_iter, context):
            first = next(iter(request_iter))
            q: queue.Queue = queue.Queue(maxsize=1024)
            with ms._sub_lock:
                ms._sub_seq += 1
                sid = ms._sub_seq
                ms._subscribers[sid] = (first.client_address, q)
                ms._sub_meta[sid] = (first.client_address,
                                     first.client_type or "client",
                                     first.version, time.time_ns(),
                                     first.grpc_port)
            log.info("client %s (%s) subscribed", first.client_address,
                     first.client_type)
            try:
                # leader hint first — a client that landed on a follower
                # must re-dial the leader for live vid-map updates
                hint = ms.leader_address
                if hint and hint != ms.address:
                    yield pb.KeepConnectedResponse(
                        volume_location=pb.VolumeLocation(leader=hint))
                # initial full vid map
                for node in ms.topo.all_nodes():
                    vids = sorted({v.id for v in node.all_volumes()})
                    ec_vids = sorted({s.volume_id for s in node.all_ec_shards()})
                    if vids or ec_vids:
                        yield pb.KeepConnectedResponse(
                            volume_location=pb.VolumeLocation(
                                url=node.url, public_url=node.public_url,
                                grpc_port=node.grpc_port,
                                new_vids=vids, new_ec_vids=ec_vids,
                                leader=ms.leader_address))
                while not ms._stop.is_set() and context.is_active():
                    try:
                        yield q.get(timeout=1.0)
                    except queue.Empty:
                        # idle keepalive carrying the current leader
                        # hint: follower read caches use it as their
                        # bounded-staleness liveness signal, and any
                        # subscriber learns of a leadership move without
                        # waiting for the next data event
                        yield pb.KeepConnectedResponse(
                            volume_location=pb.VolumeLocation(
                                leader=ms.leader_address))
            finally:
                with ms._sub_lock:
                    ms._subscribers.pop(sid, None)
                    ms._sub_meta.pop(sid, None)

        @svc.unary("Assign", pb.AssignRequest, pb.AssignResponse)
        def assign(req, context):
            return ms.do_assign(req)

        @svc.unary("LookupVolume", pb.LookupVolumeRequest, pb.LookupVolumeResponse)
        def lookup(req, context):
            failpoints.check("master.lookup")
            resp = pb.LookupVolumeResponse()
            for vf in req.volume_or_file_ids:
                entry = resp.volume_id_locations.add(volume_or_file_id=vf)
                # Full file-id lookups get a write-key token so clients can
                # delete/update (reference master_grpc_server_volume.go:102:
                # auth only when the lookup string is a file id).
                if ("," in vf and ms.guard is not None
                        and ms.guard.signing_key):
                    from ..security import gen_jwt_for_volume_server
                    entry.auth = gen_jwt_for_volume_server(
                        ms.guard.signing_key, ms.guard.expires_after_sec, vf)
                try:
                    vid = int(vf.split(",")[0])
                except ValueError:
                    entry.error = f"bad volume id {vf!r}"
                    continue
                if not ms.is_leader and ms.raft is not None:
                    # follower-served lookup from the replicated cache;
                    # miss/stale -> typed redirect (write barrier: never
                    # an authoritative not-found from a non-leader)
                    locs, source = ms.lookup_locations(vid)
                    from ..stats import MASTER_LOOKUP_COUNTER
                    MASTER_LOOKUP_COUNTER.inc(source)
                    if locs:
                        for l in locs:
                            entry.locations.add(url=l["url"],
                                                public_url=l["public_url"],
                                                grpc_port=l["grpc_port"])
                    else:
                        hint = ms.leader_address
                        entry.error = (f"not leader; leader is {hint}"
                                       if hint else
                                       "not leader; leader unknown")
                    continue
                nodes = ms.topo.lookup(vid)
                if not nodes and vid in ms.topo.ec_locations:
                    seen = set()
                    for sid_nodes in ms.topo.lookup_ec(vid).values():
                        for n in sid_nodes:
                            if n.id not in seen:
                                seen.add(n.id)
                                entry.locations.add(url=n.url,
                                                    public_url=n.public_url,
                                                    grpc_port=n.grpc_port)
                    if not seen:
                        entry.error = f"volume {vid} not found"
                    continue
                if not nodes:
                    entry.error = f"volume {vid} not found"
                    continue
                for n in nodes:
                    entry.locations.add(url=n.url, public_url=n.public_url,
                                        grpc_port=n.grpc_port)
            return resp

        @svc.unary("LookupEcVolume", pb.LookupEcVolumeRequest,
                   pb.LookupEcVolumeResponse)
        def lookup_ec(req, context):
            failpoints.check("master.lookup.ec")
            resp = pb.LookupEcVolumeResponse(volume_id=req.volume_id)
            for sid, nodes in sorted(ms.topo.lookup_ec(req.volume_id).items()):
                e = resp.shard_id_locations.add(shard_id=sid)
                for n in nodes:
                    # data_center lets repair planners classify the link
                    # to each survivor holder (geo plane fold grouping)
                    e.locations.add(url=n.url, public_url=n.public_url,
                                    grpc_port=n.grpc_port,
                                    data_center=(n.rack.dc.id
                                                 if n.rack else ""))
            return resp

        @svc.unary("Statistics", pb.StatisticsRequest, pb.StatisticsResponse)
        def statistics(req, context):
            total = used = files = 0
            for node in ms.topo.all_nodes():
                for v in node.all_volumes():
                    if req.collection and v.collection != req.collection:
                        continue
                    used += v.size
                    files += v.file_count
                for d in node.disks.values():
                    total += d.max_volume_count * ms.topo.volume_size_limit
            return pb.StatisticsResponse(total_size=total, used_size=used,
                                         file_count=files)

        @svc.unary("CollectionList", pb.CollectionListRequest,
                   pb.CollectionListResponse)
        def collection_list(req, context):
            resp = pb.CollectionListResponse()
            for c in sorted(ms.topo.collections()):
                resp.collections.add(name=c)
            return resp

        @svc.unary("CollectionDelete", pb.CollectionDeleteRequest,
                   pb.CollectionDeleteResponse)
        def collection_delete(req, context):
            """Delete every volume of a collection on every holder
            (reference master_grpc_server_collection.go)."""
            from ..pb import volume_server_pb2 as vpb
            targets = []
            with ms.topo.lock:
                for node in ms.topo.all_nodes():
                    for v in node.all_volumes():
                        if v.collection == req.name:
                            targets.append((node, v.id))
            for node, vid in targets:
                try:
                    Stub(node.grpc_address, VOLUME_SERVICE).call(
                        "VolumeDelete",
                        vpb.VolumeDeleteRequest(volume_id=vid),
                        vpb.VolumeDeleteResponse)
                except Exception as e:  # noqa: BLE001
                    log.warning("collection delete vid=%d on %s: %s",
                                vid, node.id, e)
            return pb.CollectionDeleteResponse()

        @svc.unary("EcCollectList", pb.EcCollectListRequest,
                   pb.EcCollectListResponse)
        def ec_collect_list(req, context):  # fork RPC (master.proto:28)
            cols = sorted({c for c in ms.topo.ec_collections.values()})
            return pb.EcCollectListResponse(collections=cols)

        @svc.unary("VolumeList", pb.VolumeListRequest, pb.VolumeListResponse)
        def volume_list(req, context):
            return pb.VolumeListResponse(
                topology_info=ms.topology_info(),
                volume_size_limit_mb=ms.topo.volume_size_limit >> 20)

        @svc.unary("VolumeListWithoutECVolume", pb.VolumeListWithoutECVolumeRequest,
                   pb.VolumeListResponse)
        def volume_list_no_ec(req, context):  # fork RPC (master.proto:30)
            return pb.VolumeListResponse(
                topology_info=ms.topology_info(include_ec=False),
                volume_size_limit_mb=ms.topo.volume_size_limit >> 20)

        @svc.unary("GetMasterConfiguration", pb.GetMasterConfigurationRequest,
                   pb.GetMasterConfigurationResponse)
        def get_conf(req, context):
            return pb.GetMasterConfigurationResponse(
                default_replication=ms.default_replication,
                leader=ms.leader_address,
                volume_size_limit_m_b=ms.topo.volume_size_limit >> 20)

        @svc.unary("LeaseAdminToken", pb.LeaseAdminTokenRequest,
                   pb.LeaseAdminTokenResponse)
        def lease_admin(req, context):
            now = time.monotonic_ns()  # lease age is a duration
            cur = ms._admin_locks.get(req.lock_name)
            if cur and cur[0] != req.previous_token and now - cur[1] < 60e9:
                context.abort(7, f"lock {req.lock_name} held by {cur[2]}")
            token = random.getrandbits(63)
            ms._admin_locks[req.lock_name] = (token, now, req.client_name)
            return pb.LeaseAdminTokenResponse(token=token, lock_ts_ns=now)

        @svc.unary("ReleaseAdminToken", pb.ReleaseAdminTokenRequest,
                   pb.ReleaseAdminTokenResponse)
        def release_admin(req, context):
            cur = ms._admin_locks.get(req.lock_name)
            if cur and cur[0] == req.previous_token:
                ms._admin_locks.pop(req.lock_name, None)
            return pb.ReleaseAdminTokenResponse()

        # -- vacuum automation toggle (reference DisableVacuum/EnableVacuum
        # RPCs; explicit `volume.vacuum` shell runs still work) -------------
        @svc.unary("DisableVacuum", pb.DisableVacuumRequest,
                   pb.DisableVacuumResponse)
        def disable_vacuum(req, context):
            ms.vacuum_disabled = True
            return pb.DisableVacuumResponse()

        @svc.unary("EnableVacuum", pb.EnableVacuumRequest,
                   pb.EnableVacuumResponse)
        def enable_vacuum(req, context):
            ms.vacuum_disabled = False
            return pb.EnableVacuumResponse()

        # -- raft membership (reference RaftAddServer/RaftRemoveServer/
        # RaftListClusterServers; command_cluster_raft_*.go) ----------------
        @svc.unary("RaftAddServer", pb.RaftAddServerRequest,
                   pb.RaftAddServerResponse)
        def raft_add_server(req, context):
            if ms.raft is None:
                context.abort(12, "this master runs without raft")
            if not ms.raft.is_leader:
                context.abort(9, f"not the leader; try {ms.leader_address}")
            if not ms.raft.add_server(req.address):
                context.abort(10, "membership change did not commit")
            ms.peers = list(ms.raft.cluster_members)
            return pb.RaftAddServerResponse()

        @svc.unary("RaftRemoveServer", pb.RaftRemoveServerRequest,
                   pb.RaftRemoveServerResponse)
        def raft_remove_server(req, context):
            if ms.raft is None:
                context.abort(12, "this master runs without raft")
            if not ms.raft.is_leader:
                context.abort(9, f"not the leader; try {ms.leader_address}")
            if req.id not in ms.raft.cluster_members:
                # members are keyed by address; a name that matches nothing
                # must error, not silently commit an unchanged list
                context.abort(5, f"{req.id!r} is not a member "
                                 f"(members: {ms.raft.cluster_members})")
            if not ms.raft.remove_server(req.id):
                context.abort(10, "membership change did not commit")
            ms.peers = list(ms.raft.cluster_members)
            return pb.RaftRemoveServerResponse()

        @svc.unary("RaftListClusterServers", pb.RaftListClusterServersRequest,
                   pb.RaftListClusterServersResponse)
        def raft_list_servers(req, context):
            members = (ms.raft.cluster_members if ms.raft is not None
                       else [ms.address])
            return pb.RaftListClusterServersResponse(cluster_servers=[
                pb.RaftListClusterServersResponse.ClusterServer(
                    id=m, address=m, is_leader=(m == ms.leader_address),
                    suffrage="Voter")
                for m in members])

        @svc.unary("ListClusterNodes", pb.ListClusterNodesRequest,
                   pb.ListClusterNodesResponse)
        def list_cluster_nodes(req, context):
            """Reference cluster.go ListClusterNodes: live filers/brokers
            (anything holding a KeepConnected stream) by client type."""
            with ms._sub_lock:
                metas = list(ms._sub_meta.values())
            return pb.ListClusterNodesResponse(cluster_nodes=[
                pb.ListClusterNodesResponse.ClusterNode(
                    address=addr, version=ver, created_at_ns=ts,
                    grpc_port=gport)
                for addr, ctype, ver, ts, gport in metas
                if not req.client_type or ctype == req.client_type])

        @svc.unary("Ping", pb.PingRequest, pb.PingResponse)
        def ping(req, context):
            now = time.time_ns()
            return pb.PingResponse(start_time_ns=now, remote_time_ns=now,
                                   stop_time_ns=time.time_ns())

        return svc

    # -- heartbeat handling --------------------------------------------------
    def _handle_heartbeat(self, hb: pb.Heartbeat, node):
        if node is None:
            node = self.topo.get_or_create_node(
                hb.ip, hb.port, hb.grpc_port, hb.public_url,
                hb.data_center, hb.rack, dict(hb.max_volume_counts))
            log.info("node %s registered (dc=%s rack=%s)", node.id,
                     hb.data_center, hb.rack)
            from ..ops import events
            events.emit("node.join", node=node.id,
                        dc=hb.data_center or "DefaultDataCenter",
                        rack=hb.rack or "DefaultRack")
        node.last_seen = time.monotonic()
        if hb.max_file_key:
            self.sequencer.set_max(hb.max_file_key)
            node.max_file_key = hb.max_file_key

        if hb.volumes or hb.has_no_volumes:
            vols = [VolumeInfo.from_pb(m) for m in hb.volumes]
            new, deleted = self.topo.sync_volumes(node, vols)
            for v in vols:
                self.layouts.register_volume(v)
            for v in deleted:
                self.layouts.unregister_volume(v)
            if new or deleted:
                self._broadcast_location(
                    node, new_vids=[v.id for v in new],
                    deleted_vids=[v.id for v in deleted])
        if hb.ec_shards or hb.has_no_ec_shards:
            shards = [EcShardInfo(m.id, m.collection, m.ec_index_bits,
                                  m.disk_type or "hdd", m.destroy_time)
                      for m in hb.ec_shards]
            new, deleted = self.topo.sync_ec_shards(node, shards)
            if new or deleted:
                self._broadcast_location(
                    node, new_ec=[s.volume_id for s in new],
                    deleted_ec=[s.volume_id for s in deleted])
        return node

    # -- assign --------------------------------------------------------------
    NEEDS_GROWTH = "__needs_growth__"  # internal redispatch sentinel
    _WANT_GROWTH_COOLDOWN_S = 30.0  # failed writableVolumeCount grows

    def do_assign(self, req: pb.AssignRequest,
                  allow_growth: bool = True) -> pb.AssignResponse:
        # error = master transiently refusing assigns (clients must retry
        # through the envelope); delay = overloaded leader
        failpoints.check("master.assign")
        resp = self._do_assign(req, allow_growth=allow_growth)
        if resp.error != self.NEEDS_GROWTH:
            from ..stats import MASTER_ASSIGN_COUNTER
            MASTER_ASSIGN_COUNTER.inc("error" if resp.error else "ok")
        return resp

    def needs_growth(self, req: pb.AssignRequest) -> bool:
        """True when this assign would have to grow a volume first (the
        slow path: AllocateVolume RPCs + a raft commit). The master HTTP
        handler uses this to keep no-growth assigns inline on the event
        loop and offload growth to a thread."""
        if not self.is_leader:
            return False
        layout = self.layouts.get(req.collection,
                                  req.replication or self.default_replication,
                                  req.ttl, req.disk_type or "hdd")
        layout.ensure_correct_writables()
        want = req.writable_volume_count
        lkey = (req.collection, req.replication or self.default_replication,
                req.ttl, req.disk_type or "hdd")
        if want and layout.active_count() < want and \
                time.monotonic() >= self._want_growth_backoff.get(lkey, 0.0):
            return True
        return layout.pick_for_write() is None

    def _do_assign(self, req: pb.AssignRequest,
                   allow_growth: bool = True) -> pb.AssignResponse:
        if not self.is_leader:
            hint = self.leader_address
            return pb.AssignResponse(
                error=(f"not leader; leader is {hint}" if hint
                       else "not leader; leader unknown"))
        replication = req.replication or self.default_replication
        disk_type = req.disk_type or "hdd"
        layout = self.layouts.get(req.collection, replication, req.ttl, disk_type)
        layout.ensure_correct_writables()
        vid = layout.pick_for_write()
        # writableVolumeCount (reference assign grow option): the caller
        # wants AT LEAST that many writable volumes so concurrent chunk
        # uploads — the filer's windowed fan-out — spread across volume
        # locks instead of serializing on one fsync queue. A cluster
        # that can't host `want` would otherwise pay a doomed
        # topology-wide growth sweep on EVERY assign: failures back off
        # per layout for _WANT_GROWTH_COOLDOWN_S.
        want = req.writable_volume_count or 0
        lkey = (req.collection, replication, req.ttl, disk_type)
        if want and vid is not None and \
                time.monotonic() < self._want_growth_backoff.get(lkey, 0.0):
            want = 0  # recent unsatisfiable ask: serve from what exists
        if vid is None or (want and layout.active_count() < want):
            if not allow_growth:
                # caller (the inline event-loop path) must re-dispatch to
                # a thread: growth is seconds, not microseconds
                return pb.AssignResponse(error=self.NEEDS_GROWTH)
            try:
                self.growth.grow(GrowRequest(
                    collection=req.collection, replication=replication,
                    ttl=req.ttl, disk_type=disk_type,
                    preferred_dc=req.data_center, preferred_rack=req.rack,
                    count=max(1, want - layout.active_count())))
            except Exception as e:  # noqa: BLE001
                if vid is not None:
                    # best-effort spread: the cluster can't host `want`
                    # writables (disks full), but a writable volume
                    # exists — serve the assign rather than failing it,
                    # and stop re-asking for a while
                    self._want_growth_backoff[lkey] = \
                        time.monotonic() + self._WANT_GROWTH_COOLDOWN_S
                    log.warning("writable-count growth to %d failed "
                                "(backing off %.0fs): %s", want,
                                self._WANT_GROWTH_COOLDOWN_S, e)
                else:
                    return pb.AssignResponse(error=f"grow failed: {e}")
            if self.raft is not None:
                # replicate the new MaxVolumeId before handing out fids
                # (reference raft FSM, raft_server.go:53); a failed
                # commit means we lost the quorum — refuse the assign
                # rather than risk split-brain fid allocation
                if not self.raft.propose(
                        {"max_volume_id": self.topo.max_volume_id}):
                    return pb.AssignResponse(
                        error="not leader; commit quorum lost")
            vid = layout.pick_for_write()
            if vid is None:
                return pb.AssignResponse(error="no writable volumes after growth")
        count = max(1, req.count)
        key = self.sequencer.next_id(count)
        cookie = random.getrandbits(32)
        if self.raft is not None:
            # Replicate the sequencer high-water mark (and the lease
            # grant riding the same entry) BEFORE the fids leave this
            # master: an acked range must be durable on a quorum, or a
            # new leader elected after our crash could hand out the same
            # keys again (duplicate fids). A failed commit means the
            # quorum is gone — refuse rather than ack unreplicated keys
            # (the locally-burned range just goes unused).
            cmd: dict = {"seq_hwm": key + count}
            if count > 1:
                cmd["lease"] = {"count": count,
                                "ttl_s": self.fid_leases.ttl_s}
            if not self.raft.propose(cmd):
                return pb.AssignResponse(
                    error="not leader; commit quorum lost")
        nodes = self.topo.lookup(vid)
        if not nodes:
            return pb.AssignResponse(error=f"volume {vid} has no locations")
        primary = random.choice(nodes)
        resp = pb.AssignResponse(
            fid=file_id(vid, key, cookie), count=count,
            location=pb.Location(url=primary.url, public_url=primary.public_url,
                                 grpc_port=primary.grpc_port))
        for n in nodes:
            resp.replicas.add(url=n.url, public_url=n.public_url,
                              grpc_port=n.grpc_port)
        lease_ttl = 0.0
        if count > 1:
            # a multi-count assign IS a fid-range lease: the sequencer
            # reserved [key, key+count) above. With raft on, the grant
            # was recorded by the FSM apply of the entry committed above
            # (on every master, this one included); single-master mode
            # records it directly.
            lease_ttl = (self.fid_leases.ttl_s if self.raft is not None
                         else self.fid_leases.grant(count))
        if self.guard is not None and self.guard.signing_key:
            if count > 1:
                # range-scoped token: ONE signature authorizes all N
                # needles of the lease (per-fid minting at bulk rates
                # would put the master back on the per-needle hot path).
                # exp IS the lease TTL — the token is what makes the
                # TTL real (lease.py contract), so a short lease must
                # mean a short token, never floored by the guard expiry
                from ..security import gen_jwt_for_fid_range
                resp.auth = gen_jwt_for_fid_range(
                    self.guard.signing_key,
                    max(1, int(lease_ttl)),
                    vid, key, count, cookie)
            else:
                from ..security import gen_jwt_for_volume_server
                resp.auth = gen_jwt_for_volume_server(
                    self.guard.signing_key, self.guard.expires_after_sec,
                    resp.fid)
        return resp

    # -- topology dump -------------------------------------------------------
    def topology_info(self, include_ec: bool = True) -> pb.TopologyInfo:
        t = pb.TopologyInfo(id="topo")
        with self.topo.lock:
            for dc in self.topo.dcs.values():
                dci = t.data_center_infos.add(id=dc.id)
                for rack in dc.racks.values():
                    ri = dci.rack_infos.add(id=rack.id)
                    for node in rack.nodes.values():
                        ni = ri.data_node_infos.add(id=node.id,
                                                    grpc_port=node.grpc_port)
                        for dtype, disk in node.disks.items():
                            di = ni.disk_infos[dtype]
                            di.type = dtype
                            di.volume_count = disk.volume_count
                            di.max_volume_count = disk.max_volume_count
                            di.free_volume_count = disk.free_slots()
                            for v in disk.volumes.values():
                                di.volume_infos.add(
                                    id=v.id, size=v.size, collection=v.collection,
                                    file_count=v.file_count,
                                    delete_count=v.delete_count,
                                    deleted_byte_count=v.deleted_byte_count,
                                    read_only=v.read_only,
                                    replica_placement=v.replica_placement.to_byte(),
                                    version=v.version,
                                    compact_revision=v.compact_revision,
                                    disk_type=v.disk_type)
                            if include_ec:
                                for s in disk.ec_shards.values():
                                    di.ec_shard_infos.add(
                                        id=s.volume_id, collection=s.collection,
                                        ec_index_bits=s.shard_bits,
                                        disk_type=s.disk_type,
                                        destroy_time=s.destroy_time)
        return t

    # -- background maintenance ---------------------------------------------
    def _janitor(self) -> None:
        """Dead-node reaping (heartbeat-stream death already unregisters;
        this is belt-and-braces) + layout hygiene. The reference drives
        vacuum/EC cron via shell scripts (master_server.go:269); our shell
        commands call the same seams."""
        while not self._stop.wait(self.pulse_seconds):
            for lo in self.layouts.all_layouts():
                lo.ensure_correct_writables()
            # decay the leases-active gauge even when no assigns arrive
            self.fid_leases.prune()
            try:
                # per-tick health scan keeps the at-risk gauges live for
                # scrapers and journals severity transitions as they
                # happen, not only when someone asks /cluster/health
                self.health.scan()
            except Exception as e:  # noqa: BLE001
                log.warning("health scan: %s", e)
