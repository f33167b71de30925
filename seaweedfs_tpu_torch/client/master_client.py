"""MasterClient: cached vid->locations map fed by the KeepConnected stream.

Reference: weed/wdclient/masterclient.go (+ vid_map.go:72,191). Falls back to
a LookupVolume RPC on cache miss (LookupFileIdWithFallback masterclient.go:59).

The port's copy of seaweedfs_tpu/client/master_client.py.
"""

from __future__ import annotations

import random
import threading
import time

from ..pb import master_pb2 as pb
from ..storage.types import parse_file_id
from ..utils import retry
from ..utils.env import env_float, env_int
from ..utils.log import logger
from ..utils.rpc import MASTER_SERVICE, Stub

log = logger("wdclient")

# fid-range lease client defaults: how many keys one master round-trip
# reserves (the assign amortization factor) and how long the client
# trusts a lease when the master didn't advertise a TTL (the gRPC
# AssignResponse carries no TTL field; HTTP /dir/assign does). The
# client default sits UNDER the master's 60 s default so a clockless
# client never writes on a lease whose range token just expired.
DEFAULT_LEASE_COUNT = env_int("SWTPU_FID_LEASE_COUNT", 4096)
DEFAULT_CLIENT_LEASE_TTL_S = env_float("SWTPU_FID_LEASE_CLIENT_TTL_S", 30.0)


class FidLease:
    """One leased contiguous fid range on one volume: keys
    [next_key, end_key) sharing a single cookie and (when security is
    on) a single range-scoped write JWT. Allocation via take() is local
    arithmetic — zero master round-trips. NOT thread-safe on its own;
    FidLeaseAllocator serializes access."""

    __slots__ = ("vid", "next_key", "end_key", "cookie", "url",
                 "public_url", "auth", "expires_at", "collection")

    def __init__(self, vid: int, first_key: int, count: int, cookie: int,
                 url: str, public_url: str, auth: str, ttl_s: float,
                 collection: str = ""):
        self.vid = vid
        self.next_key = first_key
        self.end_key = first_key + count
        self.cookie = cookie
        self.url = url
        self.public_url = public_url
        self.auth = auth
        self.expires_at = time.monotonic() + ttl_s
        self.collection = collection

    def remaining(self) -> int:
        return max(0, self.end_key - self.next_key)

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def take(self, n: int) -> tuple[int, int]:
        """(start_key, got) — up to n keys off the front of the range.
        Taken keys are NEVER handed out again, even if the write they
        fed fails: fid uniqueness beats key thrift."""
        got = min(n, self.remaining())
        start = self.next_key
        self.next_key += got
        return start, got

    def fid(self, key: int) -> str:
        from ..storage.types import file_id
        return file_id(self.vid, key, self.cookie)


class FidLeaseAllocator:
    """Thread-safe local fid source for bulk ingest: hands out keys from
    the current lease and transparently re-leases (one master assign)
    when the range is exhausted, expired, or discarded after a failed
    bulk write. One allocator is meant to be SHARED across writer
    threads — that is what amortizes the master round-trip N-fold."""

    def __init__(self, mc: "MasterClient", lease_count: int | None = None,
                 collection: str = "", replication: str = "", ttl: str = "",
                 disk_type: str = "", lease_ttl_s: float | None = None):
        self.mc = mc
        self.lease_count = lease_count or DEFAULT_LEASE_COUNT
        self.collection = collection
        self.replication = replication
        self.ttl = ttl
        self.disk_type = disk_type
        # explicit override (tests/chaos force mid-stream expiry);
        # None = trust the master's advertised TTL, capped by the
        # conservative client default
        self.lease_ttl_s = lease_ttl_s
        self.leases_taken = 0  # re-lease round-trips performed
        self._lease: FidLease | None = None
        self._lock = threading.Lock()

    def take(self, n: int) -> tuple[FidLease, int, int]:
        """(lease, start_key, got): up to n contiguous fids, all on the
        lease's volume. got < n near a range boundary — callers loop."""
        with self._lock:
            lease = self._lease
            if lease is None or lease.expired() or not lease.remaining():
                lease = self._lease = self._relet(n)
            start, got = lease.take(n)
            return lease, start, got

    def discard(self, lease: FidLease) -> None:
        """Drop a lease after a failed bulk write: the attempted fids
        are burned (a partial landing is possible), and the NEXT take
        re-leases against live topology instead of re-targeting a
        possibly-dead volume. Un-taken keys simply go unused — the
        sequencer never reissues them, so uniqueness holds."""
        with self._lock:
            if self._lease is lease:
                self._lease = None

    def _relet(self, want: int) -> FidLease:
        count = max(self.lease_count, want)
        lease = self.mc.lease_fids(
            count, collection=self.collection,
            replication=self.replication, ttl=self.ttl,
            disk_type=self.disk_type, lease_ttl_s=self.lease_ttl_s)
        self.leases_taken += 1
        return lease


class _HttpAssignRejected(Exception):
    """Master answered the HTTP assign and refused it (authoritative)."""


class NotLeaderError(RuntimeError):
    """A follower answered a leader-only call. `leader` carries the hint
    from the redirect (empty mid-election) so callers chase the leader
    directly instead of blind round-robin over the quorum."""

    def __init__(self, message: str, leader: str = ""):
        super().__init__(message)
        self.leader = leader


def parse_not_leader(error: str) -> "NotLeaderError | None":
    """Typed view of the master's redirect errors. The wire strings are
    frozen ("not leader; leader is <addr>" / "not leader; leader
    unknown" — the proto has no structured error field), so this is THE
    one place that parses them."""
    if not error.startswith("not leader"):
        return None
    hint = error.rsplit(" ", 1)[-1] if "; leader is " in error else ""
    return NotLeaderError(error, hint)


class _HttpNotLeader(Exception):
    """A healthy follower answered; retry against the leader via gRPC."""

    def __init__(self, message: str, leader: str = ""):
        super().__init__(message)
        self.leader = leader


class VidMap:
    def __init__(self):
        self.locations: dict[int, list[dict]] = {}
        self.ec_locations: dict[int, list[dict]] = {}
        self.lock = threading.RLock()

    def add(self, vid: int, loc: dict, ec: bool = False) -> None:
        with self.lock:
            table = self.ec_locations if ec else self.locations
            cur = table.setdefault(vid, [])
            if not any(c["url"] == loc["url"] for c in cur):
                cur.append(loc)

    def remove(self, vid: int, url: str) -> None:
        # purge BOTH tables: a cache-miss refresh re-adds EC holders into
        # the non-EC table (LookupVolume can't tell them apart), and a
        # later deleted_ec_vids event must still be able to evict them
        with self.lock:
            for table in (self.locations, self.ec_locations):
                cur = table.get(vid)
                if cur:
                    table[vid] = [c for c in cur if c["url"] != url]
                    if not table[vid]:
                        table.pop(vid, None)

    def get(self, vid: int) -> list[dict]:
        with self.lock:
            return list(self.locations.get(vid, [])) or list(
                self.ec_locations.get(vid, []))

    def invalidate(self, vid: int) -> None:
        with self.lock:
            self.locations.pop(vid, None)
            self.ec_locations.pop(vid, None)


class MasterClient:
    def __init__(self, master_address: str, client_type: str = "client",
                 client_address: str = "", grpc_port: int = 0,
                 http_address: str = ""):
        # comma-separated master quorum; leader discovered via hints
        # (reference masterclient.go:190 tryConnectToMaster round-robin)
        self.masters = [m for m in master_address.split(",") if m]
        self.master_address = self.masters[0]
        self.leader = self.masters[0]
        self._master_rr = 0
        self.client_type = client_type
        self.client_address = client_address or f"pyclient-{random.getrandbits(24):x}"
        self.grpc_port = grpc_port  # advertised service grpc port
        # optional master HTTP API address: assigns ride the keep-alive
        # /dir/assign fast path (~3x cheaper than a Python-grpcio unary)
        self.http_address = http_address
        self._http_assign_retry_at = 0.0
        self.vid_map = VidMap()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._connected = threading.Event()
        # per-thread side-channel: the HTTP assign body carries lease
        # fields (leaseTtlS) the pb.AssignResponse cannot (frozen proto);
        # _assign_http stashes them here for lease_fids to read back on
        # the same thread right after the assign returns
        self._tl = threading.local()

    # -- background vid-map subscription ------------------------------------
    def start(self) -> "MasterClient":
        self._thread = threading.Thread(target=self._keep_connected,
                                        daemon=True, name="wdclient-kc")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        stream = getattr(self, "_active_stream", None)
        if stream is not None:
            try:
                stream.cancel()
            except Exception as e:  # noqa: BLE001
                log.debug("keep-connected stream cancel failed: %s", e)

    def wait_connected(self, timeout: float = 5.0) -> bool:
        return self._connected.wait(timeout)

    def _keep_connected(self) -> None:
        while not self._stop.is_set():
            try:
                stub = Stub(self.leader, MASTER_SERVICE)

                def reqs():
                    yield pb.KeepConnectedRequest(
                        client_type=self.client_type,
                        client_address=self.client_address, version="swtpu",
                        grpc_port=self.grpc_port)
                    while not self._stop.is_set():
                        time.sleep(1)
                        return  # half-close after initial message

                stream = stub.stream_stream("KeepConnected", reqs(),
                                            pb.KeepConnectedRequest,
                                            pb.KeepConnectedResponse)
                # kept for stop(): cancelling tears the stream down so the
                # master drops this client from its cluster list promptly
                # instead of listing a dead filer/broker until the channel
                # times out
                self._active_stream = stream
                if self._stop.is_set():
                    # stop() may have raced the assignment and cancelled
                    # the PREVIOUS stream (or None); close this one too or
                    # the thread blocks forever on a quiet cluster and the
                    # master lists a ghost client
                    stream.cancel()
                    return
                self._connected.set()
                for resp in stream:
                    if self._stop.is_set():
                        return
                    vl = resp.volume_location
                    if vl.leader and vl.leader != self.leader:
                        # reconnect to the leader: only it sees volume
                        # heartbeats, a follower's stream would leave the
                        # vid map stale (reference re-dials the same way)
                        self.leader = vl.leader
                        break
                    if not vl.url:
                        continue
                    loc = {"url": vl.url, "public_url": vl.public_url,
                           "grpc_port": vl.grpc_port}
                    for vid in vl.new_vids:
                        self.vid_map.add(vid, loc)
                    for vid in vl.deleted_vids:
                        self.vid_map.remove(vid, vl.url)
                    for vid in vl.new_ec_vids:
                        self.vid_map.add(vid, loc, ec=True)
                    for vid in vl.deleted_ec_vids:
                        self.vid_map.remove(vid, vl.url)
            except Exception as e:  # noqa: BLE001
                if not self._stop.is_set():
                    log.warning("keepconnected to %s: %s; retrying", self.leader, e)
                    self._connected.clear()
                    # rotate through the quorum until a live master
                    # redirects us to the leader
                    if len(self.masters) > 1:
                        self._master_rr = (self._master_rr + 1) % len(self.masters)
                        self.leader = self.masters[self._master_rr]
                    time.sleep(0.5)

    # -- RPC helpers ---------------------------------------------------------
    def _stub(self) -> Stub:
        return Stub(self.leader, MASTER_SERVICE)

    def _call_any(self, method: str, req, resp_cls, timeout: float = 10.0):
        """Unary call with quorum fallback: try the known leader, then
        the rest of the master list (reads work against any master).
        Candidates are ordered healthy-first by their circuit breakers,
        and one jittered second sweep covers an election-in-progress blip
        instead of failing the whole operation on the first pass."""
        last_err: Exception | None = None
        pol = retry.DEFAULT_POLICY
        deadline = time.monotonic() + pol.deadline

        def try_addr(addr: str):
            nonlocal last_err
            br = retry.breaker(addr)
            try:
                resp = Stub(addr, MASTER_SERVICE).call(
                    method, req, resp_cls, timeout=timeout)
            except Exception as e:  # noqa: BLE001
                br.record_failure()
                last_err = e
                return None
            br.record_success()
            retry.BUDGET.deposit()
            return resp

        for sweep in range(2):
            candidates = retry.order_by_breaker(
                [self.leader] + [m for m in self.masters
                                 if m != self.leader])
            skipped = []
            for addr in candidates:
                if not retry.breaker(addr).allow():
                    skipped.append(addr)  # cooling: healthy peers first
                    continue
                resp = try_addr(addr)
                if resp is not None:
                    return resp
            for addr in skipped:
                # every healthy candidate failed: the cooling peers are
                # the last resort — an open breaker must cost latency,
                # never availability
                resp = try_addr(addr)
                if resp is not None:
                    return resp
            delay = pol.backoff(sweep + 1)
            if (sweep == 0 and time.monotonic() + delay <= deadline
                    and retry.BUDGET.withdraw()):
                from ..stats import RETRY_ATTEMPTS
                RETRY_ATTEMPTS.inc(f"master.{method}")
                time.sleep(delay)
                continue
            break
        raise RuntimeError(f"{method}: no reachable master ({last_err})")

    def assign(self, count: int = 1, collection: str = "",
               replication: str = "", ttl: str = "",
               disk_type: str = "",
               deadline: float | None = None,
               writable_count: int = 0) -> pb.AssignResponse:
        """`deadline` (time.monotonic() value) lets an ENCLOSING retry
        envelope (submit, filer _save_blob) bound this call's quorum
        sweeps too, so nested envelopes share one wall-clock budget
        instead of stacking multiplicatively. `writable_count` asks the
        master to keep that many volumes writable (reference
        writableVolumeCount) so concurrent uploads spread across volume
        locks instead of serializing on one fsync queue."""
        from .. import tracing
        with tracing.start_span("client.assign", component="client",
                                attrs={"collection": collection}) as sp:
            resp = self._assign(count, collection, replication, ttl,
                                disk_type, deadline, writable_count)
            sp.set_attr("fid", resp.fid)
            sp.set_attr("master", self.leader)
            return resp

    def _assign(self, count: int, collection: str, replication: str,
                ttl: str, disk_type: str,
                deadline: float | None,
                writable_count: int = 0) -> pb.AssignResponse:
        if self.http_address and time.monotonic() >= self._http_assign_retry_at:
            try:
                return self._assign_http(count, collection, replication, ttl,
                                         disk_type, writable_count)
            except _HttpAssignRejected as e:
                # the master answered and refused (grow failed, quota, …):
                # authoritative — gRPC would say the same, and the HTTP
                # endpoint is healthy, so no backoff and no retry
                raise RuntimeError(f"assign: {e}") from None
            except _HttpNotLeader as e:
                # healthy follower answered with a typed redirect: adopt
                # the hint so the gRPC sweep below starts AT the leader
                # instead of blind round-robin through the quorum
                if e.leader:
                    self.leader = e.leader
            except Exception as e:  # noqa: BLE001 - transport failure
                # back off so a black-holed HTTP endpoint doesn't tax
                # every assign with a connect timeout
                self._http_assign_retry_at = time.monotonic() + 15.0
                log.warning("http assign via %s failed (%s); using grpc "
                            "for 15s", self.http_address, e)
        req = pb.AssignRequest(
            count=count, collection=collection, replication=replication,
            ttl=ttl, disk_type=disk_type,
            writable_volume_count=writable_count)
        # leader hints can be stale right after a failover — fall back
        # through the whole quorum rather than pinning a dead address
        # (reference masterclient round-robin + leader redirect), ordered
        # healthy-first by breaker, and re-swept with jittered backoff so
        # an election in progress delays the assign instead of failing it
        pol = retry.WRITE_POLICY
        stop_at = (deadline if deadline is not None
                   else time.monotonic() + pol.deadline)
        last_err: Exception | None = None
        for sweep in range(1, pol.max_attempts + 1):
            candidates = retry.order_by_breaker(
                [self.leader] + [m for m in self.masters
                                 if m != self.leader])
            for addr in candidates:
                br = retry.breaker(addr)
                try:
                    resp = Stub(addr, MASTER_SERVICE).call(
                        "Assign", req, pb.AssignResponse, timeout=10)
                except Exception as e:  # noqa: BLE001
                    br.record_failure()
                    last_err = e
                    continue
                br.record_success()
                redirect = parse_not_leader(resp.error)
                if redirect is not None:
                    if not redirect.leader:
                        last_err = redirect
                        continue  # election in progress: try next candidate
                    hint = redirect.leader
                    hint_br = retry.breaker(hint)
                    try:
                        resp = Stub(hint, MASTER_SERVICE).call(
                            "Assign", req, pb.AssignResponse, timeout=10)
                    except Exception as e:  # noqa: BLE001
                        hint_br.record_failure()
                        last_err = e
                        continue  # hint dead: try next candidate
                    hint_br.record_success()
                    stale = parse_not_leader(resp.error)
                    if stale is not None:
                        last_err = stale
                        continue  # stale hint: try next candidate
                    if resp.error:
                        # the real leader answered with a genuine failure
                        raise RuntimeError(f"assign: {resp.error}")
                    self.leader = hint
                    return resp
                if resp.error:
                    raise RuntimeError(f"assign: {resp.error}")
                self.leader = addr
                return resp
            delay = pol.backoff(sweep)
            if (sweep >= pol.max_attempts
                    or time.monotonic() + delay > stop_at
                    or not retry.BUDGET.withdraw()):
                break
            from ..stats import RETRY_ATTEMPTS
            RETRY_ATTEMPTS.inc("master.Assign")
            time.sleep(delay)
        raise RuntimeError(f"assign: no reachable leader ({last_err})")

    def _assign_http(self, count: int, collection: str, replication: str,
                     ttl: str, disk_type: str = "",
                     writable_count: int = 0) -> pb.AssignResponse:
        """Keep-alive /dir/assign (reference master HTTP API
        master_server_handlers.go:46 dirAssignHandler)."""
        from . import http_util
        params = {"count": count}
        if collection:
            params["collection"] = collection
        if replication:
            params["replication"] = replication
        if ttl:
            params["ttl"] = ttl
        if disk_type:
            params["disk_type"] = disk_type
        if writable_count:
            params["writableVolumeCount"] = writable_count
        r = http_util.get(f"http://{self.http_address}/dir/assign",
                          params=params, timeout=5)
        try:
            body = r.json()
        except ValueError:
            raise OSError(f"non-JSON assign response ({r.status})") from None
        err = body.get("error", "")
        if r.status != 200 or err:
            if err.startswith("not leader"):
                # 421 redirect body carries the leader's gRPC address
                raise _HttpNotLeader(err, body.get("leader", ""))
            if r.status in (401, 403):
                # the HTTP plane is guard-gated and this client carries no
                # jwt — the gRPC plane may still be open/channel-authed, so
                # stop using HTTP entirely rather than failing every assign
                self.http_address = ""
                log.warning("http assign endpoint requires auth (%s); "
                            "falling back to grpc permanently", err)
                raise _HttpNotLeader(err)
            raise _HttpAssignRejected(err or f"HTTP {r.status}")
        resp = pb.AssignResponse(fid=body["fid"], count=body.get("count", 1),
                                 auth=body.get("auth", ""))
        resp.location.url = body.get("url", "")
        resp.location.public_url = body.get("publicUrl", "")
        self._tl.lease_ttl = float(body.get("leaseTtlS") or 0.0)
        return resp

    def lease_fids(self, count: int, collection: str = "",
                   replication: str = "", ttl: str = "",
                   disk_type: str = "",
                   lease_ttl_s: float | None = None) -> FidLease:
        """Lease a contiguous fid range: one assign(count=N) round-trip
        whose response already IS the lease (fid encodes vid/first key/
        cookie, count is the width, auth is the range-scoped JWT when
        security is on). The client-side expiry is the master-advertised
        TTL minus a safety margin, capped by the conservative client
        default; `lease_ttl_s` overrides (chaos forces mid-stream
        expiry with it)."""
        self._tl.lease_ttl = 0.0
        resp = self.assign(count=count, collection=collection,
                           replication=replication, ttl=ttl,
                           disk_type=disk_type)
        vid, key, cookie = parse_file_id(resp.fid)
        if lease_ttl_s is not None:
            eff_ttl = lease_ttl_s
        else:
            advertised = getattr(self._tl, "lease_ttl", 0.0)
            eff_ttl = DEFAULT_CLIENT_LEASE_TTL_S
            if advertised:
                # 10% safety margin against clock/wire skew
                eff_ttl = min(eff_ttl, max(1.0, advertised * 0.9))
            if resp.auth:
                # the gRPC assign carries no TTL field, but the range
                # token's own exp is authoritative — never outlive it,
                # or every frame past exp 401s on an "expired" lease
                # the client still trusts
                from ..security.jwt import peek_claims
                exp = peek_claims(resp.auth).get("exp")
                if exp:
                    remain = float(exp) - time.time()  # swtpu-lint: disable=wallclock-duration (jwt exp IS wall time; the server compares it against wall clock too)
                    eff_ttl = min(eff_ttl, max(1.0, remain * 0.9))
        return FidLease(vid, key, int(resp.count) or count, cookie,
                        resp.location.url, resp.location.public_url,
                        resp.auth, eff_ttl, collection=collection)

    def lookup(self, vid: int) -> list[dict]:
        cached = self.vid_map.get(vid)
        if cached:
            return cached
        req = pb.LookupVolumeRequest(volume_or_file_ids=[str(vid)])
        resp = self._call_any("LookupVolume", req, pb.LookupVolumeResponse)
        for _ in range(2):  # original answer + at most one leader redirect
            redirect = None
            for e in resp.volume_id_locations:
                if e.error:
                    redirect = parse_not_leader(e.error)
                    if redirect is not None and redirect.leader:
                        break
                    # authoritative miss (or a redirect with no hint —
                    # mid-election; the caller's retry envelope re-asks)
                    raise KeyError(e.error)
                for l in e.locations:
                    self.vid_map.add(vid, {"url": l.url,
                                           "public_url": l.public_url,
                                           "grpc_port": l.grpc_port})
            if redirect is None:
                return self.vid_map.get(vid)
            # a follower's cache couldn't answer (miss or past the
            # staleness bound): follow the typed redirect to the leader
            self.leader = redirect.leader
            resp = Stub(redirect.leader, MASTER_SERVICE).call(
                "LookupVolume", req, pb.LookupVolumeResponse, timeout=10)
        for e in resp.volume_id_locations:
            if e.error:
                raise KeyError(e.error)
        return self.vid_map.get(vid)

    def refresh_lookup(self, vid: int) -> list[dict]:
        """Drop the cached locations and re-query the master — used when a
        replica 404s after a volume move (LookupFileIdWithFallback
        masterclient.go:59 refreshes the same way)."""
        self.vid_map.invalidate(vid)
        return self.lookup(vid)

    @staticmethod
    def location_urls(locs: list[dict], fid: str) -> list[str]:
        """One place that turns location dicts into fetch URLs — read()'s
        refreshed-replica-set comparison relies on this matching
        lookup_file_id exactly."""
        return [f"http://{l['public_url'] or l['url']}/{fid}" for l in locs]

    def lookup_file_id(self, fid: str) -> list[str]:
        vid, _, _ = parse_file_id(fid)
        return self.location_urls(self.lookup(vid), fid)

    def lookup_file_id_jwt(self, fid: str) -> str:
        """Write-key token for mutating an existing fid (reference
        master_grpc_server_volume.go:102 mints auth for file-id lookups)."""
        resp = self._call_any("LookupVolume", pb.LookupVolumeRequest(
            volume_or_file_ids=[fid]), pb.LookupVolumeResponse)
        for e in resp.volume_id_locations:
            return e.auth
        return ""

    def lookup_ec(self, vid: int) -> dict[int, list[str]]:
        resp = self._call_any("LookupEcVolume",
                                 pb.LookupEcVolumeRequest(volume_id=vid),
                                 pb.LookupEcVolumeResponse)
        return {e.shard_id: [l.url for l in e.locations]
                for e in resp.shard_id_locations}

    def collection_list(self) -> list[str]:
        resp = self._call_any("CollectionList", pb.CollectionListRequest(),
                                 pb.CollectionListResponse)
        return [c.name for c in resp.collections]

    def volume_list(self) -> pb.VolumeListResponse:
        return self._call_any("VolumeList", pb.VolumeListRequest(),
                                 pb.VolumeListResponse)
