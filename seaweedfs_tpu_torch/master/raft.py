"""Raft consensus for the master quorum.

Reference: weed/server/raft_server.go (seaweedfs/raft backend) and
raft_hashicorp.go; the replicated state machine is deliberately tiny —
`MaxVolumeId` (raft_server.go:53-91 StateMachine.Save/Recovery/Apply) —
because everything else the master knows is rebuilt from volume-server
heartbeats after a leader change.

Compact, correct Raft core: election, log replication, commit, no-op
entry on election, leader-lease step-down on quorum loss, and log
compaction with snapshot install (the FSM snapshot is just the folded
command state, so "InstallSnapshot" piggybacks on AppendEntries).
Indexes are absolute; `log_start` is the absolute index of log[0].
Peer RPCs fan out on a worker pool so one dead peer cannot stall
heartbeats to the healthy ones. Timing defaults suit tests (sub-second
failover); production would raise them.

The port's copy of seaweedfs_tpu/master/raft.py, with one difference:
the leader sends each peer's AppendEntries on that peer's own clock. The
reference's `_broadcast_append` waits on every peer's answer (up to three
RPC timeouts) before the loop sleeps a heartbeat interval, so one stalled
peer spaces every heartbeat past the 0.4 s minimum election timeout and
keeps the healthy followers electing. Here a send is asynchronous: a peer
with an append in flight is skipped until it answers, each answer is folded
in as it lands (match/next index, commit advance), and the quorum lease is
the time the (quorum-1)-th most recent peer answered.
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass, field
from typing import Callable

from ..utils import fsutil
from ..utils.log import logger
from ..utils.rpc import RpcService, Stub

log = logger("raft")

RAFT_SERVICE = "swtpu.raft.Raft"

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

COMPACT_THRESHOLD = 512  # committed entries kept before compaction


@dataclass
class LogEntry:
    term: int
    command: dict = field(default_factory=dict)


def _fold(state: dict, command: dict) -> dict:
    """Fold a command into FSM snapshot state (monotonic maxes)."""
    mvid = command.get("max_volume_id")
    if mvid:
        state["max_volume_id"] = max(state.get("max_volume_id", 0), mvid)
    hwm = command.get("seq_hwm")
    if hwm:
        # sequencer high-water mark must survive compaction: a node that
        # catches up from the snapshot and later becomes leader would
        # otherwise reissue fid keys the old leader already handed out
        state["seq_hwm"] = max(state.get("seq_hwm", 0), hwm)
    members = command.get("raft_members")
    if members:
        # membership rides the snapshot so a compacted log still tells a
        # restarting/lagging node who the cluster is
        state["_members"] = sorted(members)
    # "lease" grants are deliberately NOT folded: they are ephemeral
    # (TTL-bounded observability state) and re-arming them long after the
    # grant would inflate the leases-active gauge forever
    return state


def _fsync_dir(path: str) -> None:
    """fsync the parent directory of `path` so a just-completed
    os.replace / file creation survives a crash. Without it the rename
    itself can be lost, resurrecting a stale voted_for — which lets the
    node vote twice in one term (the exact double-vote raft §5.2
    forbids)."""
    fsutil.fsync_dir(path)


class RaftNode:
    def __init__(self, address: str, peers: list[str],
                 apply_fn: Callable[[dict], None],
                 state_path: str | None = None,
                 election_timeout: tuple[float, float] = (0.4, 0.8),
                 heartbeat_interval: float = 0.12,
                 rpc_timeout: float = 0.3):
        self.address = address
        self.peers = [p for p in peers if p != address]
        self.cluster_members = sorted(set(list(peers) + [address]))
        self.apply_fn = apply_fn
        self.state_path = state_path
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.rpc_timeout = rpc_timeout

        # persistent state
        self.current_term = 0
        self.voted_for: str | None = None
        self.log: list[LogEntry] = []
        self.log_start = 0          # absolute index of log[0]
        self.snapshot_state: dict = {}   # folded commands below log_start
        self.snapshot_term = 0      # term of entry log_start-1
        self._wal = None            # append handle for <state_path>.wal

        # volatile — initialized BEFORE _load(): a loaded snapshot may
        # carry a membership config that _apply_config folds into this
        # state (role, election deadline, peer indices)
        self.role = FOLLOWER
        self.leader_address: str | None = None
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self._quorum_seen = time.monotonic()
        self._election_deadline = 0.0
        self._removed = False       # self decommissioned via raft_members
        # (role, term, leader) last published to on_state_change /
        # metrics; compared each _run tick OUTSIDE the raft lock so the
        # callback (admin cron wakeups, follower re-dials) can never
        # deadlock against raft internals
        self.on_state_change: "Callable[[str, int, str | None], None] | None" \
            = None
        self._published: tuple = (None, -1, None)
        self._load()
        self.commit_index = self.log_start - 1
        self.last_applied = self.log_start - 1

        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._commit_cv = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        # one append in flight a peer, plus room for votes and the
        # config-change courtesy appends
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, 2 * len(self.peers)),
            thread_name_prefix="raft-rpc")
        self._in_flight: set[str] = set()   # peers with an append out
        self._last_ack: dict[str, float] = {}  # peer -> last answer time

    # -- absolute index helpers ---------------------------------------------
    @property
    def _last_index(self) -> int:
        return self.log_start + len(self.log) - 1

    def _term_at(self, index: int) -> int:
        if index == self.log_start - 1:
            return self.snapshot_term
        rel = index - self.log_start
        if 0 <= rel < len(self.log):
            return self.log[rel].term
        return 0

    def _entry(self, index: int) -> LogEntry:
        return self.log[index - self.log_start]

    @property
    def _quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    # -- persistence ---------------------------------------------------------
    # Two files (the reference's hashicorp backend pairs BoltDB log +
    # snapshot files the same way; raft_hashicorp.go:99):
    #   <state_path>        — small JSON metadata (term, vote, log_start,
    #                         snapshot), atomically rewritten when it changes
    #   <state_path>.wal    — append-only log, one JSON line per entry,
    #                         fsync'd per append; O(1) disk work per entry
    #                         instead of rewriting the whole log
    def _load(self) -> None:
        if not self.state_path:
            return
        if not os.path.exists(self.state_path):
            # no metadata yet, but a crash before the FIRST metadata
            # rewrite can still leave fsynced (= acked) WAL appends;
            # ignoring the WAL here would lose committed entries
            try:
                wal_start, self.log = self._read_wal()
                if wal_start is not None:
                    self.log_start = wal_start
            except Exception as e:  # noqa: BLE001
                log.warning("raft wal load: %s", e)
            return
        try:
            with open(self.state_path) as f:
                st = json.load(f)
            self.current_term = st.get("term", 0)
            self.voted_for = st.get("voted_for")
            self.log_start = st.get("log_start", 0)
            self.snapshot_state = st.get("snapshot_state", {})
            self.snapshot_term = st.get("snapshot_term", 0)
            if "log" in st:  # pre-WAL format: whole log inline
                self.log = [LogEntry(e["term"], e["command"])
                            for e in st.get("log", [])]
                # migrate NOW: the next metadata-only persist would drop
                # the inline log and orphan every entry. WAL first: the
                # entries must land in their new home before the
                # metadata rewrite drops the inline copy
                self._persist(wal_first=True)
            else:
                wal_start, self.log = self._read_wal()
                if wal_start is not None:
                    self.log_start = wal_start
            if self.snapshot_state:
                if self.snapshot_state.get("_members"):
                    self._apply_config(self.snapshot_state["_members"])
                self.apply_fn(dict(self.snapshot_state))
        except Exception as e:  # noqa: BLE001
            log.warning("raft state load: %s", e)

    def _read_wal(self) -> "tuple[int | None, list[LogEntry]]":
        """Returns (log_start from the WAL header, entries). The header is
        written atomically WITH the entries, so on a crash between the WAL
        and metadata rewrites the header is the authoritative log_start —
        trusting the stale metadata would shift every entry's index."""
        wal = self.state_path + ".wal"
        out: list[LogEntry] = []
        start = None
        if not os.path.exists(wal):
            return start, out
        with open(wal, "rb") as f:
            for i, line in enumerate(f):
                try:
                    e = json.loads(line)
                    if i == 0 and "log_start" in e:
                        start = e["log_start"]
                        continue
                    out.append(LogEntry(e["t"], e["c"]))
                except Exception:  # noqa: BLE001 — torn tail after a crash
                    break
        return start, out

    def _wal_handle(self):
        if self._wal is None:
            d = os.path.dirname(self.state_path)
            if d:
                os.makedirs(d, exist_ok=True)
            path = self.state_path + ".wal"
            fresh = not os.path.exists(path) or os.path.getsize(path) == 0
            self._wal = open(path, "ab")
            if fresh:
                self._wal.write(
                    json.dumps({"log_start": self.log_start}).encode()
                    + b"\n")
                self._wal.flush()
                os.fsync(self._wal.fileno())
                _fsync_dir(path)  # the file itself must survive a crash
        return self._wal

    def _persist_meta(self) -> None:
        """Atomic rewrite of the small metadata file + fsync."""
        if not self.state_path:
            return
        d = os.path.dirname(self.state_path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.current_term,
                       "voted_for": self.voted_for,
                       "log_start": self.log_start,
                       "snapshot_state": self.snapshot_state,
                       "snapshot_term": self.snapshot_term}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)
        # fsync the rename too: vote/term durability must be complete
        # BEFORE the RPC reply leaves (a crash after replying "granted"
        # but before the rename is durable double-votes in this term)
        _fsync_dir(self.state_path)

    def _wal_append(self, entries: "list[LogEntry]") -> None:
        """Append + fsync just the new entries (the per-propose hot path)."""
        if not self.state_path or not entries:
            return
        f = self._wal_handle()
        for e in entries:
            f.write(json.dumps({"t": e.term, "c": e.command}).encode()
                    + b"\n")
        f.flush()
        os.fsync(f.fileno())

    def _persist(self, wal_first: bool = False) -> None:
        """Full rewrite of metadata + WAL. Ordering is load-bearing:
        every committed entry must exist in (snapshot ∪ WAL) at EVERY
        crash point, so whichever file is gaining entries is written
        before the file losing them is rewritten. Compaction folds
        entries WAL→snapshot, hence metadata first by default — a
        wal-first swap would leave a WAL whose header says log_start=N
        next to metadata whose snapshot still ends below N, and the
        folded committed entries would exist NOWHERE on disk
        (crashsim's raft-commit scenario catches exactly this). The
        reverse window (new snapshot + old longer WAL) merely replays
        folded entries twice, and _fold is idempotent (monotonic
        maxes) by design. The pre-WAL format migration in _load moves
        entries the OTHER way (inline metadata log → WAL) and passes
        wal_first=True for the same reason mirrored. Needed after
        truncation/compaction/snapshot-install; appends use
        _wal_append instead."""
        if not self.state_path:
            return
        d = os.path.dirname(self.state_path)
        if d:
            os.makedirs(d, exist_ok=True)
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        if not wal_first:
            self._persist_meta()
        tmp = self.state_path + ".wal.tmp"
        with open(tmp, "wb") as f:
            f.write(json.dumps({"log_start": self.log_start}).encode()
                    + b"\n")
            for e in self.log:
                f.write(json.dumps({"t": e.term, "c": e.command}).encode()
                        + b"\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path + ".wal")
        _fsync_dir(self.state_path)
        if wal_first:
            self._persist_meta()

    def _maybe_compact(self) -> None:
        """Fold committed prefix into the snapshot (caller holds lock).
        The reference snapshots the FSM the same way — MaxVolumeId only."""
        committed = self.commit_index - self.log_start + 1
        if committed <= COMPACT_THRESHOLD:
            return
        keep_from = self.commit_index  # keep the last committed entry
        for i in range(self.log_start, keep_from):
            self.snapshot_state = _fold(self.snapshot_state,
                                        self._entry(i).command)
        self.snapshot_term = self._term_at(keep_from - 1)
        self.log = self.log[keep_from - self.log_start:]
        self.log_start = keep_from
        self._persist()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "RaftNode":
        self._reset_election_timer()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"raft-{self.address}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._pool.shutdown(wait=False, cancel_futures=True)
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    @property
    def is_leader(self) -> bool:
        return self.role == LEADER

    def _reset_election_timer(self) -> None:
        if self._removed:
            # a decommissioned node never campaigns again (not even after
            # restart — _load replays the config that set the flag)
            self._election_deadline = float("inf")
            return
        lo, hi = self.election_timeout
        self._election_deadline = time.monotonic() + random.uniform(lo, hi)

    # -- main loop -----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                role = self.role
            if role == LEADER:
                self._broadcast_append()
                self._publish_state()
                self._stop.wait(self.heartbeat_interval)
            else:
                if time.monotonic() >= self._election_deadline:
                    self._start_election()
                self._publish_state()
                self._stop.wait(0.02)

    def _publish_state(self) -> None:
        """Poll-publish (role, term, leader) transitions to metrics and
        the on_state_change callback — from the _run loop, outside the
        raft lock, so subscribers (admin cron, follower read cache) can
        take their own locks without an ABBA against raft internals.
        Latency bound: one loop tick (20ms follower / one heartbeat
        interval leader)."""
        with self._lock:
            snap = (self.role, self.current_term, self.leader_address)
        if snap == self._published:
            return
        prev = self._published
        self._published = snap
        try:
            from ..stats import MASTER_LEADER_CHANGES, RAFT_LEADER_CHANGES, \
                RAFT_TERM
            RAFT_TERM.set(value=snap[1])
            if snap[2] and snap[2] != prev[2]:
                # leader identity changed (elections that fizzle without
                # a winner bump terms, not this counter)
                RAFT_LEADER_CHANGES.inc()
                MASTER_LEADER_CHANGES.inc()
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never stall the raft loop)
            pass
        cb = self.on_state_change
        if cb is not None:
            try:
                cb(snap[0], snap[1], snap[2])
            except Exception as e:  # noqa: BLE001
                log.warning("raft state-change callback: %s", e)

    # -- election ------------------------------------------------------------
    def _start_election(self) -> None:
        with self._lock:
            self.role = CANDIDATE
            self.current_term += 1
            self.voted_for = self.address
            self._persist_meta()
            term = self.current_term
            last_idx = self._last_index
            last_term = self._term_at(last_idx)
            self._reset_election_timer()
        log.info("%s: starting election term %d", self.address, term)
        votes = 1
        futs = {self._pool.submit(
                    contextvars.copy_context().run, self._call, peer,
                    "RequestVote", {
                        "term": term, "candidate": self.address,
                        "last_log_index": last_idx,
                        "last_log_term": last_term,
                    }): peer for peer in self.peers}
        try:
            for fut in as_completed(futs, timeout=self.rpc_timeout * 3):
                try:
                    resp = fut.result()
                except Exception:  # noqa: BLE001
                    continue
                with self._lock:
                    if resp.get("term", 0) > self.current_term:
                        self._become_follower(resp["term"], None)
                        return
                    if resp.get("granted") and self.current_term == term:
                        votes += 1
                        if votes >= self._quorum and self.role == CANDIDATE:
                            self._become_leader()
                            return
        except TimeoutError:
            pass

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_address = self.address
        n = self._last_index + 1
        self.next_index = {p: n for p in self.peers}
        self.match_index = {p: -1 for p in self.peers}
        self._quorum_seen = time.monotonic()
        self._last_ack = {}
        # no-op entry: commits all prior-term entries immediately (Raft
        # §8), closing the window where a replicated max_volume_id from
        # the old term sits unapplied on the new leader
        self.log.append(LogEntry(self.current_term, {}))
        self._wal_append(self.log[-1:])
        log.info("%s: LEADER for term %d", self.address, self.current_term)

    def _become_follower(self, term: int, leader: str | None) -> None:
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self._persist_meta()
        if self.role != FOLLOWER:
            log.info("%s: -> follower term %d", self.address, term)
        self.role = FOLLOWER
        if leader:
            self.leader_address = leader
        self._reset_election_timer()

    # -- replication (leader) ------------------------------------------------
    def _append_args_for(self, peer: str) -> dict:
        """Build AppendEntries for one peer (caller holds lock). Peers
        lagging below log_start get the snapshot piggybacked."""
        ni = self.next_index.get(peer, self._last_index + 1)
        args = {"term": self.current_term, "leader": self.address,
                "leader_commit": self.commit_index}
        if ni < self.log_start:
            # follower is behind the compaction horizon: install snapshot
            args["snapshot"] = {"state": self.snapshot_state,
                                "last_index": self.log_start - 1,
                                "last_term": self.snapshot_term}
            ni = self.log_start
        args["prev_log_index"] = ni - 1
        args["prev_log_term"] = self._term_at(ni - 1)
        args["entries"] = [{"term": e.term, "command": e.command}
                           for e in self.log[ni - self.log_start:]]
        args["_ni"] = ni
        return args

    def _broadcast_append(self) -> None:
        """Send AppendEntries to every peer with none in flight, without
        waiting on any answer: each peer runs on its own clock, so a
        stalled peer delays only itself."""
        with self._lock:
            if self.role != LEADER:
                return
            term = self.current_term
            self._check_quorum_locked()
            if self.role != LEADER:
                return
            for peer in self.peers:
                self._send_append_locked(peer, term)
            # a cluster of one commits here; otherwise the answers do
            self._advance_commit_locked()

    def _send_append_locked(self, peer: str, term: int) -> None:
        """Queue one AppendEntries to `peer` unless one is in flight
        (caller holds the lock)."""
        if peer in self._in_flight:
            return
        args = self._append_args_for(peer)
        ni = args.pop("_ni")
        self._in_flight.add(peer)
        try:
            fut = self._pool.submit(contextvars.copy_context().run,
                                    self._call, peer, "AppendEntries", args)
        except RuntimeError:  # pool shut down: the node is stopping
            self._in_flight.discard(peer)
            return
        n_entries = len(args["entries"])
        fut.add_done_callback(
            lambda f: self._on_append_done(f, peer, term, ni, n_entries))

    def _on_append_done(self, fut, peer: str, term: int, ni: int,
                        n_entries: int) -> None:
        with self._lock:
            self._in_flight.discard(peer)
            try:
                resp = fut.result()
            except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (an unreachable peer counts as no answer; the lease check sees its silence)
                return
            if resp.get("term", 0) > self.current_term:
                self._become_follower(resp["term"], None)
                return
            if self.role != LEADER or self.current_term != term:
                return
            self._last_ack[peer] = time.monotonic()
            self._refresh_quorum_seen_locked()
            if resp.get("success"):
                self.match_index[peer] = max(self.match_index.get(peer, -1),
                                             ni + n_entries - 1)
                self.next_index[peer] = max(self.next_index.get(peer, 0),
                                            ni + n_entries)
            else:
                self.next_index[peer] = max(self.log_start - 1, ni - 1)
            self._advance_commit_locked()
            if self._stop.is_set() or peer not in self.peers:
                return
            if not resp.get("success") or \
                    self.next_index[peer] <= self._last_index:
                # entries still to send (or a log to back up): go again
                # now rather than a heartbeat later
                self._send_append_locked(peer, term)

    def _refresh_quorum_seen_locked(self) -> None:
        """A quorum was last reached when the (quorum-1)-th most recent
        peer answered."""
        need = self._quorum - 1
        if need <= 0:
            self._quorum_seen = time.monotonic()
            return
        acks = sorted((self._last_ack.get(p, 0.0) for p in self.peers),
                      reverse=True)
        if len(acks) >= need:
            self._quorum_seen = max(self._quorum_seen, acks[need - 1])

    def _check_quorum_locked(self) -> None:
        """Leader lease: past twice the longest election timeout without a
        quorum's answers, a minority-partitioned leader steps down."""
        self._refresh_quorum_seen_locked()
        now = time.monotonic()
        if now - self._quorum_seen > self.election_timeout[1] * 2:
            # leader lease lost: a minority-partitioned leader must stop
            # serving (split-brain guard)
            log.warning("%s: lost contact with quorum; stepping down",
                        self.address)
            self.role = FOLLOWER
            self.leader_address = None
            self._reset_election_timer()

    def _advance_commit_locked(self) -> None:
        """Advance commit to the highest index replicated on a quorum with
        an entry from the current term (Raft §5.4.2), then apply."""
        for idx in range(self._last_index, self.commit_index, -1):
            if self._term_at(idx) != self.current_term:
                break
            count = 1 + sum(1 for p in self.peers
                            if self.match_index.get(p, -1) >= idx)
            if count >= self._quorum:
                self.commit_index = idx
                self._commit_cv.notify_all()
                break
        self._apply_committed()
        self._maybe_compact()

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            try:
                cmd = self._entry(self.last_applied).command
                if cmd.get("raft_members"):
                    new_members = set(cmd["raft_members"])
                    if self.role == LEADER:
                        # courtesy final append so removed peers learn of
                        # their removal (and go quiet) instead of finding
                        # out by silence
                        for peer in [p for p in self.peers
                                     if p not in new_members]:
                            try:
                                args = self._append_args_for(peer)
                                args.pop("_ni")
                                self._pool.submit(
                                    contextvars.copy_context().run,
                                    self._call, peer, "AppendEntries", args)
                            except Exception as e:  # noqa: BLE001
                                log.debug("config-change catch-up append "
                                          "to %s not queued: %s", peer, e)
                    self._apply_config(cmd["raft_members"])
                elif cmd:
                    self.apply_fn(cmd)
            except Exception as e:  # noqa: BLE001
                log.error("raft apply %d: %s", self.last_applied, e)

    # -- membership change (reference master.proto RaftAddServer/Remove;
    # single-server change applied at commit like hashicorp AddVoter) -------
    def _apply_config(self, members: list[str]) -> None:
        """Adopt a committed membership list (caller holds lock, or is in
        single-threaded _load)."""
        members = sorted(set(members))
        self.cluster_members = members
        if self.address not in members:
            # removed from the cluster: stop voting/campaigning entirely so
            # a stale node can't disrupt the remaining quorum with elections
            self.peers = []
            self.role = FOLLOWER
            self.leader_address = None
            self._removed = True
            self._election_deadline = float("inf")
            log.info("%s: removed from raft cluster", self.address)
            return
        self._removed = False
        self.peers = [m for m in members if m != self.address]
        if self.role == LEADER:
            n = self._last_index + 1
            for p in self.peers:
                self.next_index.setdefault(p, n)
                self.match_index.setdefault(p, -1)
        log.info("%s: raft membership now %s", self.address, members)

    def add_server(self, address: str, timeout: float = 5.0) -> bool:
        """Leader-only: commit a membership list including `address`. The
        new node starts (or restarts) with any seed peer list — the leader
        streams it the log/snapshot, whose config entry teaches it the
        real membership."""
        with self._lock:
            members = set(self.cluster_members) | {address}
        return self.propose({"raft_members": sorted(members)}, timeout)

    def remove_server(self, address: str, timeout: float = 5.0) -> bool:
        """Leader-only; removing the leader itself commits first, then the
        leader steps down when the entry applies."""
        with self._lock:
            members = set(self.cluster_members) - {address}
        return self.propose({"raft_members": sorted(members)}, timeout)

    def propose(self, command: dict, timeout: float = 5.0) -> bool:
        """Leader-only: append + replicate; returns True once committed."""
        with self._lock:
            if self.role != LEADER:
                return False
            self.log.append(LogEntry(self.current_term, command))
            self._wal_append(self.log[-1:])
            idx = self._last_index
        self._broadcast_append()
        deadline = time.monotonic() + timeout
        with self._commit_cv:
            while self.commit_index < idx:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self.role != LEADER:
                    return False
                self._commit_cv.wait(min(remaining, 0.1))
        return True

    # -- RPC plumbing --------------------------------------------------------
    def _call(self, peer: str, method: str, payload: dict) -> dict:
        from ..pb import master_pb2 as pb
        stub = Stub(peer, RAFT_SERVICE)
        if method == "RequestVote":
            req = pb.RequestVoteRequest(
                term=payload["term"], candidate=payload["candidate"],
                last_log_index=payload["last_log_index"],
                last_log_term=payload["last_log_term"])
            r = stub.call(method, req, pb.RequestVoteResponse,
                          timeout=self.rpc_timeout)
            return {"term": r.term, "granted": r.granted}
        req = pb.AppendEntriesRequest(
            term=payload["term"], leader=payload["leader"],
            prev_log_index=payload["prev_log_index"],
            prev_log_term=payload["prev_log_term"],
            leader_commit=payload["leader_commit"])
        snap = payload.get("snapshot")
        for e in payload["entries"]:
            cmd = dict(e["command"])
            req.entries.add(term=e["term"],
                            command=json.dumps(cmd).encode())
        if snap is not None:
            # snapshot piggybacks as the first entry with a marker key
            # (the FSM state is one small dict, so a dedicated
            # InstallSnapshot RPC would be overkill)
            first = pb.RaftLogEntry(
                term=snap["last_term"],
                command=json.dumps({"__snapshot__": snap}).encode())
            entries = [first] + list(req.entries)
            del req.entries[:]
            for e in entries:
                req.entries.add(term=e.term, command=e.command)
        r = stub.call(method, req, pb.AppendEntriesResponse,
                      timeout=self.rpc_timeout)
        return {"term": r.term, "success": r.success}

    def build_service(self) -> RpcService:
        from ..pb import master_pb2 as pb
        svc = RpcService(RAFT_SERVICE)
        node = self

        @svc.unary("RequestVote", pb.RequestVoteRequest,
                   pb.RequestVoteResponse)
        def request_vote(req, context):
            out = node._on_request_vote({
                "term": req.term, "candidate": req.candidate,
                "last_log_index": req.last_log_index,
                "last_log_term": req.last_log_term})
            return pb.RequestVoteResponse(term=out["term"],
                                          granted=out["granted"])

        @svc.unary("AppendEntries", pb.AppendEntriesRequest,
                   pb.AppendEntriesResponse)
        def append_entries(req, context):
            entries = [{"term": e.term,
                        "command": json.loads(e.command or b"{}")}
                       for e in req.entries]
            snapshot = None
            if entries and "__snapshot__" in entries[0]["command"]:
                snapshot = entries[0]["command"]["__snapshot__"]
                entries = entries[1:]
            out = node._on_append_entries({
                "term": req.term, "leader": req.leader,
                "prev_log_index": req.prev_log_index,
                "prev_log_term": req.prev_log_term,
                "entries": entries, "snapshot": snapshot,
                "leader_commit": req.leader_commit})
            return pb.AppendEntriesResponse(term=out["term"],
                                            success=out["success"])

        return svc

    # -- RPC handlers (any role) ---------------------------------------------
    def _on_request_vote(self, p: dict) -> dict:
        with self._lock:
            now = time.monotonic()
            leader_alive = (
                (self.role == LEADER
                 and now - self._quorum_seen < self.election_timeout[0])
                or (self.role != LEADER and self.leader_address is not None
                    and now < self._election_deadline))
            if leader_alive and p["candidate"] not in self.cluster_members:
                # Leader stickiness (hashicorp CheckQuorum analogue): while
                # a live leader exists, a candidate outside our committed
                # membership (removed, or not yet added) can't win or even
                # bump our term — a stale removed node would otherwise
                # depose the leader forever. With NO live leader we vote by
                # the normal rules regardless of config view, else a
                # cluster whose joiner hasn't applied the latest config
                # entry could never elect anyone (liveness).
                return {"term": self.current_term, "granted": False}
            if p["term"] > self.current_term:
                self._become_follower(p["term"], None)
            granted = False
            if p["term"] == self.current_term and \
                    self.voted_for in (None, p["candidate"]):
                last_idx = self._last_index
                last_term = self._term_at(last_idx)
                up_to_date = (p["last_log_term"], p["last_log_index"]) >= \
                             (last_term, last_idx)
                if up_to_date:
                    granted = True
                    self.voted_for = p["candidate"]
                    self._persist_meta()
                    self._reset_election_timer()
            return {"term": self.current_term, "granted": granted}

    def _on_append_entries(self, p: dict) -> dict:
        with self._lock:
            if p["term"] < self.current_term:
                return {"term": self.current_term, "success": False}
            self._become_follower(p["term"], p["leader"])
            if p.get("snapshot"):
                snap = p["snapshot"]
                self.snapshot_state = dict(snap["state"])
                self.snapshot_term = snap["last_term"]
                self.log = []
                self.log_start = snap["last_index"] + 1
                self.commit_index = max(self.commit_index,
                                        snap["last_index"])
                self.last_applied = max(self.last_applied,
                                        snap["last_index"])
                if self.snapshot_state:
                    if self.snapshot_state.get("_members"):
                        self._apply_config(self.snapshot_state["_members"])
                    self.apply_fn(dict(self.snapshot_state))
                self._persist()
            prev_idx = p["prev_log_index"]
            if prev_idx >= self.log_start - 1:
                if prev_idx > self._last_index or \
                        (prev_idx >= self.log_start
                         and self._term_at(prev_idx) != p["prev_log_term"]) \
                        or (prev_idx == self.log_start - 1
                            and self.snapshot_term
                            and p["prev_log_term"] != self.snapshot_term):
                    return {"term": self.current_term, "success": False}
            else:
                # our snapshot is ahead of the leader's prev: stale rpc
                return {"term": self.current_term, "success": False}
            # append, truncating conflicts
            at = prev_idx + 1
            appended: list[LogEntry] = []
            truncated = False
            for i, e in enumerate(p["entries"]):
                idx = at + i
                rel = idx - self.log_start
                if rel < len(self.log):
                    if self.log[rel].term != e["term"]:
                        del self.log[rel:]
                        entry = LogEntry(e["term"], e["command"])
                        self.log.append(entry)
                        truncated = True
                        appended.append(entry)
                else:
                    entry = LogEntry(e["term"], e["command"])
                    self.log.append(entry)
                    appended.append(entry)
            if truncated:
                self._persist()       # conflict: WAL must be rewritten
            elif appended:
                self._wal_append(appended)
            if p["leader_commit"] > self.commit_index:
                self.commit_index = min(p["leader_commit"], self._last_index)
                self._apply_committed()
            return {"term": self.current_term, "success": True}
