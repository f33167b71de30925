"""Balance executor: run a MovePlan against a live cluster.

The throttling half of the rebalance plane (plan.py orders, this
bounds) — the same shape as maintenance/executor.py because rebalance
traffic IS maintenance traffic:

  * every hop is tagged `qos.CLASS_MAINTENANCE` at the source, so the
    copy/move RPCs admit maintenance-class on the nodes that serve
    them (CopyFile / VolumeEcShardsCopy are already enforcement
    points) and yield to queued foreground work;
  * `max_concurrent` moves in flight (defaults conservative — balance
    is never urgent) and `max_moves` admitted per run, the rest journal
    `balance.skipped` reason=budget and wait for the next sweep;
  * EC moves arrive pre-grouped per (volume, src, dst) pair — ONE
    VolumeEcShardsMove RPC per pair;
  * every move journals `balance.move` with its byte cost and rack
    locality, and feeds SeaweedFS_balance_moves_total{kind} /
    SeaweedFS_balance_bytes_moved_total{cross_rack};
  * dry-run journals `balance.plan` (dry_run=true) and returns without
    creating a single stub: zero RPCs, mutating or otherwise —
    `volume.balance -dryRun` / `ec.balance -dryRun` ride this.

The port's copy of seaweedfs_tpu/placement/executor.py.
"""

from __future__ import annotations

import contextvars
import threading
from concurrent.futures import ThreadPoolExecutor

from ..utils.log import logger
from .plan import MOVE_EC, MOVE_VOLUME, Move, MovePlan

log = logger("placement.executor")

SKIP_BUDGET = "budget"


class BalanceExecutor:
    """Executes MovePlans through a shell CommandEnv. One instance per
    balance run — the admin lock serializes runs, so unlike the repair
    executor no cross-run cooldown state is needed."""

    def __init__(self, env, max_concurrent: int = 2, max_moves: int = 64):
        self.env = env
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_moves = max(1, int(max_moves))

    def execute(self, plan: MovePlan, dry_run: bool = False) -> dict:
        """Run the plan; returns {done: [...], failed: [...],
        skipped: [...]} summaries (each entry a move dict + outcome)."""
        from ..ops import events
        events.emit("balance.plan", moves=len(plan.moves),
                    total_bytes=plan.total_bytes,
                    cross_rack_bytes=plan.cross_rack_bytes,
                    skew_before=round(plan.skew_before, 3),
                    skew_after=round(plan.skew_after, 3),
                    dry_run=dry_run,
                    order=[{"kind": m.kind, "vid": m.vid, "src": m.src,
                            "dst": m.dst, "bytes": m.bytes_moved}
                           for m in plan.moves])
        summary: dict = {"done": [], "failed": [], "skipped": []}
        if dry_run or not plan.moves:
            return summary
        admitted = plan.moves[:self.max_moves]
        for m in plan.moves[self.max_moves:]:
            events.emit("balance.skipped", severity=events.WARN,
                        reason=SKIP_BUDGET, kind=m.kind, vid=m.vid)
            summary["skipped"].append({**m.to_dict(),
                                       "reason": SKIP_BUDGET})
        # the volume planner moves each vid at most once per plan, but
        # EC plans legitimately carry several (src, dst) groups of ONE
        # stripe — those touch the same sidecars/mount path, so moves
        # sharing a (kind, vid) run back-to-back in plan order while
        # distinct volumes parallelize
        lock = threading.Lock()
        groups: dict[tuple, list[Move]] = {}
        for m in admitted:
            groups.setdefault((m.kind, m.vid), []).append(m)

        def run_group(ms: "list[Move]") -> None:
            for m in ms:
                self._run_move(m, summary, lock)

        if self.max_concurrent == 1 or len(groups) == 1:
            for ms in groups.values():
                run_group(ms)
        else:
            with ThreadPoolExecutor(
                    max_workers=self.max_concurrent,
                    thread_name_prefix="balance") as pool:
                futs = [pool.submit(contextvars.copy_context().run,
                                    run_group, ms)
                        for ms in groups.values()]
                for f in futs:
                    f.result()
        return summary

    def _run_move(self, m: Move, summary: dict,
                  lock: threading.Lock) -> None:
        from .. import qos, tracing
        from ..ops import events
        # rebalance traffic is maintenance-class AT THE SOURCE: the tag
        # rides the gRPC metadata of every hop below, so the file pulls
        # it triggers on src/dst admit behind foreground work
        with qos.tagged(qos.CLASS_MAINTENANCE), tracing.start_span(
                f"balance.{m.kind}", component="balance",
                attrs={"vid": m.vid, "src": m.src, "dst": m.dst,
                       "bytes": m.bytes_moved}) as sp:
            try:
                if m.kind == MOVE_VOLUME:
                    self._move_volume(m)
                elif m.kind == MOVE_EC:
                    self._move_ec(m)
                else:
                    raise ValueError(f"unknown move kind {m.kind!r}")
            except Exception as e:  # noqa: BLE001 — one move, one verdict
                sp.set_error(str(e))
                events.emit("balance.failed", severity=events.ERROR,
                            kind=m.kind, vid=m.vid, src=m.src, dst=m.dst,
                            error=str(e)[:200])
                log.warning("balance %s vid %s %s->%s failed: %s",
                            m.kind, m.vid, m.src, m.dst, e)
                with lock:
                    summary["failed"].append({**m.to_dict(),
                                              "error": str(e)})
                return
            events.emit("balance.move", kind=m.kind, vid=m.vid,
                        src=m.src, dst=m.dst,
                        bytes_moved=m.bytes_moved,
                        cross_rack=m.cross_rack,
                        shard_ids=list(m.shard_ids) or None)
            self._count(m)
            with lock:
                summary["done"].append(m.to_dict())

    # -- moves ---------------------------------------------------------------
    def _servers(self) -> dict:
        return {s["id"]: s for s in self.env.collect_volume_servers()}

    def _move_volume(self, m: Move) -> None:
        from ..shell.volume_commands import _safe_copy_volume
        servers = self._servers()
        src, dst = servers.get(m.src), servers.get(m.dst)
        if src is None or dst is None:
            raise RuntimeError(
                f"move endpoints gone: src={m.src} dst={m.dst}")
        _safe_copy_volume(self.env, m.vid, m.collection, src, dst,
                          delete_source=True)

    def _move_ec(self, m: Move) -> None:
        from ..pb import volume_server_pb2 as vpb
        from ..utils.rpc import Stub, VOLUME_SERVICE
        servers = self._servers()
        src, dst = servers.get(m.src), servers.get(m.dst)
        if src is None or dst is None:
            raise RuntimeError(
                f"move endpoints gone: src={m.src} dst={m.dst}")
        # ONE RPC for the whole (src, dst) shard group — the fork's
        # VolumeEcShardsMove does copy + source delete, driven from
        # the destination
        Stub(self.env.grpc_addr(dst["id"], dst["grpc_port"]),
             VOLUME_SERVICE).call(
            "VolumeEcShardsMove",
            vpb.VolumeEcShardsMoveRequest(
                volume_id=m.vid, collection=m.collection,
                shard_ids=sorted(m.shard_ids),
                source_data_node=self.env.grpc_addr(
                    src["id"], src["grpc_port"])),
            vpb.VolumeEcShardsMoveResponse, timeout=3600)

    # -- metrics --------------------------------------------------------------
    @staticmethod
    def _count(m: Move) -> None:
        try:
            from ..stats import BALANCE_BYTES_MOVED, BALANCE_MOVES
            BALANCE_MOVES.inc(m.kind)
            BALANCE_BYTES_MOVED.inc("true" if m.cross_rack else "false",
                                    amount=m.bytes_moved)
        except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (metrics must never break a move)
            pass
