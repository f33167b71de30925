"""Master-side maintenance cron: self-driving repair with no operator.

Reference: master_server.go:269 `startAdminScripts` reads shell command lines
from master.toml (scaffold/master.toml:11-16 ships ec.encode / ec.rebuild /
ec.balance / volume.balance / volume.fix.replication, run every 17 minutes by
default, master_server.go:278) and executes them through the embedded shell
machinery, leader-only, under the exclusive cluster lock.

Same shape here: the cron owns a CommandEnv dialing its own master, takes the
admin lease per sweep (so it never races an operator's shell — if a human
holds the lock the sweep is skipped), runs each script line, and releases.
Script failures are logged and do not stop the remaining lines or the loop.

Beyond the reference, the cron is HEALTH-DRIVEN: when wired to the
master's HealthEngine (`health_fetch`), the blind fixed-order
`ec.rebuild` / `volume.fix.replication` lines are replaced each sweep by
the repair plane (maintenance/planner + executor) — the most-at-risk
items repaired first under an admission budget, with cooldowns that
persist across sweeps. If the health fetch fails the sweep falls back to
the legacy script list, so a broken health plane degrades to the
reference behavior instead of to no repair at all.

The port's copy of seaweedfs_tpu/master/admin_cron.py.
"""

from __future__ import annotations

import io
import random
import threading

from ..utils.log import logger

log = logger("admincron")

# Reference default scripts (scaffold/master.toml:11-16): full volumes are
# erasure-coded continuously (EC-on-ingest at volume granularity), lost
# shards rebuilt, shards and volumes balanced, replication repaired.
DEFAULT_SCRIPTS = [
    "ec.encode -collection '*' -fullPercent 95",
    "ec.rebuild",
    "ec.balance",
    "volume.balance",
    "volume.fix.replication",
    "volume.vacuum",
    # periodic bit-rot detection through the device-batched CRC kernel
    # (volume.scrub, storage/scrub.py — BASELINE config 4 in operations).
    # Budgeted: each sweep scans up to 2 min per server from a rotating
    # cursor, so full coverage accrues across sweeps without a
    # whole-disk scan competing with live traffic every 17 minutes
    "volume.scrub -timeBudget 120",
]
DEFAULT_INTERVAL_S = 17 * 60  # master_server.go:278 sleep_minutes default

# script lines the health-driven repair plane supersedes: a sweep with a
# live health report runs planner->executor ONCE in their place
REPAIR_SCRIPTS = ("ec.rebuild", "volume.fix.replication")


class AdminCron:
    def __init__(self, master_address: str, scripts: "list[str] | None" = None,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 is_leader=lambda: True,
                 vacuum_enabled=lambda: True,
                 health_fetch=None,
                 initial_delay_s: float | None = None,
                 repair_max_concurrent: int = 2,
                 repair_cooldown_s: float = 60.0,
                 costs_fn=None):
        self.master_address = master_address
        self.scripts = list(DEFAULT_SCRIPTS if scripts is None else scripts)
        self.interval_s = interval_s
        self.is_leader = is_leader
        self.vacuum_enabled = vacuum_enabled
        # () -> health report dict; None = legacy scripted repair only
        self.health_fetch = health_fetch
        # () -> geo LinkCostModel | None: prices planner items in
        # cost-weighted bytes (the master wires its -linkCosts policy)
        self.costs_fn = costs_fn
        self.repair_max_concurrent = repair_max_concurrent
        self.repair_cooldown_s = repair_cooldown_s
        # A node dying right after a master restart should not wait a full
        # 17-minute interval for its first repair: the first sweep runs
        # after a small delay, jittered as a fraction of the interval so
        # a fleet of masters restarting together doesn't stampede the
        # volume servers with synchronized sweeps. <= 0 restores the
        # legacy wait-a-full-interval behavior; SWTPU_CRON_INITIAL_DELAY_S
        # overrides (the test suite pins it to 0 so long-lived fixture
        # masters never start surprise balance/vacuum sweeps mid-test).
        if initial_delay_s is None:
            from ..utils.env import env_float
            initial_delay_s = env_float("SWTPU_CRON_INITIAL_DELAY_S", -1.0)
            if initial_delay_s < 0:
                initial_delay_s = min(
                    max(5.0, random.uniform(0.05, 0.15) * interval_s), 120.0)
        self.initial_delay_s = initial_delay_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._env = None
        # serializes trigger() against the loop: concurrent sweeps would
        # interleave on one CommandEnv (clobbering env.out mid-script)
        # and double-run repairs
        self._sweep_lock = threading.Lock()
        self._repair_exec = None  # lazy; cooldowns persist across sweeps
        self.sweeps = 0          # completed sweeps (observability + tests)
        self.resumes = 0         # leadership-gain wakeups received
        self._wake = threading.Event()
        self.last_output = ""

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if not self.scripts:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="master-admin-cron")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()  # unblock the loop promptly
        if self._env is not None:
            try:
                self._env.mc.stop()
            except Exception as e:  # noqa: BLE001
                log.debug("cron master-client stop failed: %s", e)

    def trigger(self) -> None:
        """Run one sweep immediately (tests / admin HTTP hook).
        Serialized against the background loop's sweeps."""
        self._sweep()

    def notify_leadership(self, is_leader: bool) -> None:
        """Raft role-change hook (master_server wires raft.on_state_change
        here). A newly-elected leader re-runs the initial-delay schedule
        — repair resumes within the jittered initial delay of a failover
        instead of after the remainder of a 17-minute interval. (With
        initial_delay_s pinned to 0 — the test-suite default — the timer
        just re-arms for a full interval: no surprise sweeps.) Losing
        leadership needs no action: every sweep is already leader-gated,
        and a sweep in flight aborts between script lines."""
        if is_leader:
            self.resumes += 1
            self._wake.set()

    # -- internals ----------------------------------------------------------
    def _get_env(self):
        if self._env is None:
            # import for side effect: registers the command tables
            from ..shell import (commands, ec_commands,  # noqa: F401
                                 fs_commands, lifecycle_commands,
                                 mq_commands, remote_commands,
                                 volume_commands)
            from ..client.master_client import MasterClient
            mc = MasterClient(self.master_address,
                              client_type="admin-cron").start()
            self._env = commands.CommandEnv(self.master_address, mc=mc,
                                            out=io.StringIO())
        return self._env

    def _initial_wait(self) -> float:
        return (min(self.initial_delay_s, self.interval_s)
                if self.initial_delay_s > 0 else self.interval_s)

    def _loop(self) -> None:
        wait = self._initial_wait()
        while not self._stop.is_set():
            woke = self._wake.wait(timeout=wait)
            if self._stop.is_set():
                return
            if woke:
                # leadership gained mid-wait: restart the initial-delay
                # schedule so the new leader's first sweep comes up on
                # the prompt (jittered) timetable, not the stale timer
                self._wake.clear()
                wait = self._initial_wait()
                continue
            wait = self.interval_s
            if not self.is_leader():
                continue
            try:
                self._sweep()
            except Exception as e:  # noqa: BLE001 — cron must survive
                log.warning("maintenance sweep failed: %s", e)

    def _sweep(self) -> None:
        with self._sweep_lock:
            self._sweep_locked()

    def _sweep_locked(self) -> None:
        from ..shell.commands import run_command
        env = self._get_env()
        env.out = out = io.StringIO()
        # checked between the volumes of a long line: a deposed leader
        # stops mid-line instead of racing the new leader's cron
        env.should_stop = lambda: not self.is_leader()
        try:
            env.acquire_lock()
        except Exception as e:  # noqa: BLE001 — operator holds it, or no quorum
            log.info("skipping maintenance sweep (lock unavailable: %s)", e)
            return
        # health-driven mode: fetch the report once per sweep; a fetch
        # failure falls back to the legacy scripted repair lines
        report = None
        if self.health_fetch is not None:
            try:
                report = self.health_fetch()
            except Exception as e:  # noqa: BLE001
                log.warning("health fetch failed (%s); falling back to "
                            "scripted repair", e)
                out.write(f"health fetch failed ({e}); legacy repair\n")
        repaired = False
        try:
            for line in self.scripts:
                if not self.is_leader():
                    # deposed mid-sweep: stop issuing repair commands —
                    # the new leader's cron owns them now (a demoted
                    # master driving moves would race it)
                    out.write("aborting sweep: leadership lost\n")
                    break
                name = line.split()[0] if line.split() else ""
                if report is not None and name in REPAIR_SCRIPTS:
                    if repaired:
                        out.write("skipped (health-driven repair already "
                                  f"ran): {line}\n")
                        continue
                    repaired = True
                    try:
                        env.acquire_lock()  # renew before the repair burst
                        self._run_repair(env, report, out)
                    except Exception as e:  # noqa: BLE001
                        log.warning("health-driven repair failed: %s", e)
                        out.write(f"error: health-driven repair: {e}\n")
                    continue
                if line.startswith("volume.vacuum") and not self.vacuum_enabled():
                    out.write(f"skipped (vacuum disabled): {line}\n")
                    continue
                try:
                    # renew the admin lease before each line: the master's
                    # lease expires after 60s (master_server.py LeaseAdminToken)
                    # and balance/rebuild lines can run far longer; renewing
                    # with the held token keeps operators locked out mid-sweep
                    env.acquire_lock()
                    run_command(env, line)
                except Exception as e:  # noqa: BLE001
                    log.warning("maintenance script %r failed: %s", line, e)
                    out.write(f"error: {line}: {e}\n")
        finally:
            try:
                env.release_lock()
            except Exception as e:  # noqa: BLE001
                log.debug("sweep admin-lock release failed: %s", e)
        self.last_output = out.getvalue()
        self.sweeps += 1
        if self.last_output.strip():
            log.info("maintenance sweep #%d:\n%s", self.sweeps,
                     self.last_output.rstrip())

    def _run_repair(self, env, report: dict, out) -> None:
        """planner -> executor over this sweep's health report. ONE
        executor lives across sweeps so failed repairs keep cooling
        instead of being retried every 17 minutes at full rate."""
        from ..maintenance import RepairExecutor, build_plan, make_probes
        remount_probe, geometry_probe = make_probes(env)
        costs = self.costs_fn() if self.costs_fn is not None else None
        plan = build_plan(report, probe_remountable=remount_probe,
                          probe_geometry=geometry_probe, costs=costs)
        if self._repair_exec is None:
            self._repair_exec = RepairExecutor(
                env, max_concurrent=self.repair_max_concurrent,
                cooldown_s=self.repair_cooldown_s)
        if not plan.items and not plan.unrepairable:
            out.write("health-driven repair: nothing to do\n")
            # still publish the (empty) plan event + zeroed pending gauge
            self._repair_exec.execute(plan, dry_run=True)
            return
        plan.render(lambda *a: out.write(" ".join(str(x) for x in a) + "\n"))
        res = self._repair_exec.execute(plan)
        out.write(f"health-driven repair: {len(res['done'])} done, "
                  f"{len(res['failed'])} failed, "
                  f"{len(res['skipped'])} skipped\n")
