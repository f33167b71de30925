"""Self-healing repair plane: health-driven planner + budgeted executor.

The health plane (master/health.py) makes data-at-risk *visible*
(OK/DEGRADED/AT_RISK/DATA_LOSS with distance_to_data_loss per item); this
package makes it *actionable*. The planner turns one health report into a deterministic,
prioritized repair plan (most-at-risk stripes first), and the executor
runs that plan under an admission budget — bounded concurrency,
per-volume locks, cooldown-with-backoff after failures — journaling
every decision to ops/events and publishing repair metrics.

Consumers:
  * `cluster.repair` (shell/volume_commands.py) — operator/CI surface,
    with a -dryRun plan-only mode;
  * the master's AdminCron in health-driven mode — the closed loop from
    detect (master/health.py) to heal, replacing the blind fixed-order
    ec.rebuild / volume.fix.replication sweep.

The port's copy of seaweedfs_tpu/maintenance/__init__.py.
"""

from .planner import (ACTION_EC_REBUILD, ACTION_EC_REMOUNT,
                      ACTION_REPLICATE, RepairItem, RepairPlan, build_plan)
from .executor import (RepairExecutor, make_geometry_probe, make_probes,
                       make_remount_probe)

__all__ = [
    "ACTION_EC_REBUILD", "ACTION_EC_REMOUNT", "ACTION_REPLICATE",
    "RepairItem", "RepairPlan", "build_plan",
    "RepairExecutor", "make_geometry_probe", "make_probes",
    "make_remount_probe",
]
