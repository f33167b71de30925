"""Follower-served lookups: a replicated vid->locations cache on
non-leader masters.

Volume servers heartbeat only the leader, so a follower's own topology
is empty (or stale, right after it was deposed). To let followers take
/dir/lookup traffic off the leader, each follower subscribes to the
leader's KeepConnected stream — the same live vid-map feed clients and
filers consume — and answers lookups from that replica under a BOUNDED
staleness contract:

- freshness: the leader sends a keepalive (with its leader hint) at
  least once a second on an idle stream, so `last_contact` is a live
  leader-liveness signal, not just a data timestamp. A lookup is served
  only while `now - last_contact <= SWTPU_FOLLOWER_READ_MAX_STALENESS_S`
  (default 5s); past the bound the follower redirects to the leader
  rather than serve arbitrarily old locations.
- write barrier: a follower NEVER serves an authoritative "not found".
  A vid missing from the cache may simply not have replicated yet
  (assign on the leader -> immediate lookup on a follower), so misses
  redirect to the leader instead of 404ing a fid that exists.

The port's copy of seaweedfs_tpu/master/follower.py.
"""

from __future__ import annotations

import threading
import time

from ..client.master_client import VidMap
from ..utils.env import env_float
from ..utils.log import logger
from ..utils.rpc import MASTER_SERVICE, Stub

log = logger("follower")

DEFAULT_MAX_STALENESS_S = env_float("SWTPU_FOLLOWER_READ_MAX_STALENESS_S",
                                    5.0)


class FollowerVidCache:
    def __init__(self, address: str, leader_of,
                 max_staleness_s: float | None = None):
        """`leader_of()` returns the current leader address, or a falsy
        value / our own address while we are the leader or mid-election
        (then the cache idles — the leader answers from its topology)."""
        self.address = address
        self.leader_of = leader_of
        self.max_staleness_s = (DEFAULT_MAX_STALENESS_S
                                if max_staleness_s is None
                                else max_staleness_s)
        self.vid_map = VidMap()
        self.last_contact = 0.0     # monotonic time of last leader message
        self.source = ""            # leader the cache was last fed by
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._active_stream = None
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FollowerVidCache":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"follower-cache-{self.address}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._cancel_stream()

    def poke(self) -> None:
        """Leadership changed: re-evaluate who to subscribe to now
        instead of waiting out the current stream's keepalive cadence."""
        self._wake.set()
        self._cancel_stream()

    def _cancel_stream(self) -> None:
        stream = self._active_stream
        if stream is not None:
            try:
                stream.cancel()
            except Exception as e:  # noqa: BLE001
                log.debug("follower stream cancel: %s", e)

    # -- read path -----------------------------------------------------------
    def fresh(self) -> bool:
        return (time.monotonic() - self.last_contact) <= self.max_staleness_s

    def lookup(self, vid: int) -> "list[dict] | None":
        """Locations for vid, or None when the caller must redirect to
        the leader (cache miss OR past the staleness bound — both sides
        of the write barrier)."""
        if not self.fresh():
            return None
        return self.vid_map.get(vid) or None

    # -- subscription loop ---------------------------------------------------
    def _run(self) -> None:
        from ..pb import master_pb2 as pb

        while not self._stop.is_set():
            target = self.leader_of()
            if not target or target == self.address:
                # we are the leader (or nobody is): idle cheaply
                self._wake.wait(0.2)
                self._wake.clear()
                continue
            try:
                self._subscribe(pb, target)
            except Exception as e:  # noqa: BLE001
                if not self._stop.is_set():
                    log.debug("follower subscribe to %s: %s", target, e)
            self._wake.wait(0.2)
            self._wake.clear()

    def _subscribe(self, pb, target: str) -> None:
        stub = Stub(target, MASTER_SERVICE)

        def reqs():
            yield pb.KeepConnectedRequest(
                client_type="master-follower",
                client_address=self.address, version="swtpu")

        stream = stub.stream_stream("KeepConnected", reqs(),
                                    pb.KeepConnectedRequest,
                                    pb.KeepConnectedResponse)
        self._active_stream = stream
        if self._stop.is_set():
            stream.cancel()
            return
        if self.source != target:
            # a new feed replays the full vid map from scratch; stale
            # entries from the previous leader must not linger past it
            self.vid_map = VidMap()
            self.source = target
        log.info("%s: following vid map from leader %s", self.address,
                 target)
        for resp in stream:
            if self._stop.is_set():
                return
            self.last_contact = time.monotonic()
            if self.leader_of() != target:
                return  # leadership moved (or we won): re-evaluate
            vl = resp.volume_location
            if vl.leader and vl.leader != target:
                return  # the peer itself points elsewhere: re-dial
            if not vl.url:
                continue  # keepalive
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
