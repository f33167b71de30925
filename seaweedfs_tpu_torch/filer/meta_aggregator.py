"""Multi-filer metadata mesh.

Reference: weed/filer/meta_aggregator.go:38-103 — every filer subscribes
to each peer's LOCAL metadata stream (SubscribeLocalMetadata), applies
the events to its own store, persists a per-peer resume offset in its
store's KV space, and relies on the signature chain to never re-relay a
relayed event. Filers in one cluster share the blob plane, so events
apply metadata-only: chunk fids are valid cluster-wide and chunk
deletion happens once, at the origin filer.

Peer discovery rides the master cluster list (ListClusterNodes,
reference cluster.go:104) instead of a static peer flag; a filer that
joins later is picked up on the next poll, and its whole retained meta
log replays from offset 0 — the MaybeBootstrapFromOnePeer analogue.

The port's copy of seaweedfs_tpu/filer/meta_aggregator.py, unchanged: a port
filer and a JAX-package filer on one master mesh with each other.
"""

from __future__ import annotations

import struct
import threading

from ..pb import filer_pb2 as fpb
from ..pb import master_pb2 as mpb
from ..utils.log import logger
from ..utils.rpc import MASTER_SERVICE, Stub

log = logger("meta-aggregator")

DISCOVER_INTERVAL_S = 2.0
# Keyed by peer address AND the peer's store signature: a peer wiped and
# recreated at the same address announces a new signature, which resets
# the resume point to 0 so its re-imported history replays (reference
# meta_aggregator.go readFilerStoreSignature does the same).
OFFSET_KEY_FMT = "meta.aggregator.offset.{peer}.{sig}"


class MetaAggregator:
    def __init__(self, filer_server):
        self.fs = filer_server
        self._stop = threading.Event()
        self._peer_threads: dict[str, threading.Thread] = {}
        # peer filer signature -> addr; consulted by SubscribeLocalMetadata
        # to tell mesh-relayed events (drop) from externally-signed local
        # writes like filer.sync imports (relay)
        self.peer_signatures: dict[int, str] = {}
        # peer -> newest applied ts not yet persisted (flushed by the
        # discovery tick and on batch thresholds)
        self._pending_offsets: dict[str, int] = {}
        self._offset_lock = threading.Lock()
        # peer addr -> store signature (fills in when the tail dials)
        self._peer_sig: dict[str, int] = {}
        # peers whose offset is frozen behind a dead-lettered event
        self.diverged_peers: set[str] = set()
        self._discover_thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "MetaAggregator":
        self._discover_thread = threading.Thread(
            target=self._discover_loop, daemon=True,
            name=f"meta-aggr-discover-{self.fs.port}")
        self._discover_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    @property
    def peers(self) -> list[str]:
        return sorted(self._peer_threads)

    # -- discovery ----------------------------------------------------------
    def _discover_loop(self) -> None:
        while not self._stop.is_set():
            try:
                for addr, gport in self._list_filers():
                    if addr != self.fs.url and \
                            addr not in self._peer_threads:
                        t = threading.Thread(
                            target=self._sync_peer, args=(addr, gport),
                            daemon=True,
                            name=f"meta-aggr-{self.fs.port}-{addr}")
                        self._peer_threads[addr] = t
                        t.start()
                        log.info("filer %s: aggregating peer %s",
                                 self.fs.url, addr)
            except Exception as e:  # noqa: BLE001 — master may be electing
                log.warning("peer discovery: %s", e)
            for peer in list(self._pending_offsets):
                self._flush_offset(peer)
            self._stop.wait(DISCOVER_INTERVAL_S)

    def _flush_offset(self, peer: str) -> None:
        # the kv_put happens INSIDE the lock: two racing flushers (the
        # discovery tick + the subscriber's batch path) must not let an
        # older offset land after a newer one and regress the resume point
        with self._offset_lock:
            ts = self._pending_offsets.pop(peer, None)
            if ts is None:
                return
            try:
                key = self._offset_key(peer)
                raw = self.fs.filer.store.kv_get(key)
                if raw and struct.unpack("<q", raw)[0] >= ts:
                    return
                self.fs.filer.store.kv_put(key, struct.pack("<q", ts))
            except Exception as e:  # noqa: BLE001
                log.warning("offset persist for %s: %s", peer, e)
                self._pending_offsets.setdefault(peer, ts)

    def _list_filers(self) -> "list[tuple[str, int]]":
        resp = Stub(self.fs.mc.leader, MASTER_SERVICE).call(
            "ListClusterNodes",
            mpb.ListClusterNodesRequest(client_type="filer"),
            mpb.ListClusterNodesResponse)
        return [(n.address, n.grpc_port) for n in resp.cluster_nodes]

    # -- per-peer tail ------------------------------------------------------
    def _offset_key(self, peer: str) -> bytes:
        sig = self._peer_sig.get(peer, 0)
        return OFFSET_KEY_FMT.format(peer=peer, sig=sig).encode()

    def _sync_peer(self, peer: str, grpc_port: int = 0) -> None:
        try:
            self._sync_peer_inner(peer, grpc_port)
        except Exception as e:  # noqa: BLE001
            log.warning("peer %s tail died: %s (will redial)", peer, e)
        finally:
            # drop the registration so the discovery loop redials — a
            # peer that raced its own startup (gRPC not listening yet)
            # must not be lost forever
            self._peer_threads.pop(peer, None)

    def _sync_peer_inner(self, peer: str, grpc_port: int = 0) -> None:
        from ..client.filer_client import FilerClient
        host = peer.rsplit(":", 1)[0]
        grpc_addr = f"{host}:{grpc_port}" if grpc_port else ""
        fc = FilerClient(peer, grpc_address=grpc_addr,
                         client_name=f"aggr-{self.fs.url}")
        self.peer_signatures[fc.signature] = peer
        self._peer_sig[peer] = fc.signature  # offset key is (peer, sig)
        self.diverged_peers.discard(peer)  # fresh dial re-attempts the event
        key = self._offset_key(peer)
        raw = self.fs.filer.store.kv_get(key)
        since = struct.unpack("<q", raw)[0] if raw else 0
        own = self.fs.filer.signature
        # batch offset persistence: one kv_put per event doubles store
        # writes under a burst; re-applying a few events after a crash is
        # idempotent (create-or-update, delete tolerant of missing). The
        # discovery tick flushes _pending_offsets so an idle tail still
        # records its last event within a couple of seconds.
        last_ts = since
        pending = 0
        for resp in fc.filer.subscribe_local(since, self._stop):
            ev = resp.event_notification
            if own in ev.signatures:
                continue  # should not happen (server filters) — belt
            applied = False
            for attempt in range(5):  # filer_sync-style retry
                try:
                    self._apply(resp.directory, ev)
                    applied = True
                    break
                except Exception as e:  # noqa: BLE001
                    log.warning("apply %s from %s (try %d/5): %s",
                                resp.directory, peer, attempt + 1, e)
                    if self._stop.wait(0.2 * 2 ** attempt):
                        return
            if not applied:
                # freeze the resume offset BEHIND this event: later events
                # still apply (best effort) but the persisted offset stops
                # here, so the next (re)dial replays and re-attempts it
                # rather than making the divergence permanent silently.
                from ..stats.metrics import FILER_AGGR_DEAD_LETTERS
                FILER_AGGR_DEAD_LETTERS.inc(peer)
                self.diverged_peers.add(peer)
                log.error("DEAD-LETTER %s from %s: offset frozen at %d; "
                          "tail will replay from there on redial",
                          resp.directory, peer, last_ts)
            if resp.ts_ns and peer not in self.diverged_peers:
                last_ts = resp.ts_ns
                pending += 1
                with self._offset_lock:
                    self._pending_offsets[peer] = last_ts
                if pending >= 64:
                    self._flush_offset(peer)
                    pending = 0
        self._flush_offset(peer)

    def _apply(self, directory: str, ev: fpb.EventNotification) -> None:
        """Metadata-only apply: chunks are shared cluster-wide, so no
        data moves and no chunk deletion here (the origin filer's own
        GC handles delete_chunks)."""
        f = self.fs.filer
        sigs = list(ev.signatures)
        has_old = ev.HasField("old_entry") and bool(ev.old_entry.name)
        has_new = ev.HasField("new_entry") and bool(ev.new_entry.name)
        new_dir = ev.new_parent_path or directory
        if has_old and (not has_new or ev.old_entry.name != ev.new_entry.name
                        or new_dir != directory):
            try:
                f.delete_entry(directory, ev.old_entry.name,
                               is_recursive=True, is_delete_data=False,
                               signatures=sigs)
            except FileNotFoundError:
                pass
        if has_new:
            e = fpb.Entry()
            e.CopyFrom(ev.new_entry)
            # gc_chunks=False: the origin filer GCs replaced chunks
            # exactly once; a replica GC-ing its (possibly different) old
            # version would delete both sides of a concurrent update
            if f.find_entry(new_dir, e.name) is None:
                f.create_entry(new_dir, e, signatures=sigs,
                               gc_chunks=False)
            else:
                f.update_entry(new_dir, e, signatures=sigs,
                               gc_chunks=False)
