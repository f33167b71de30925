"""Scale-out placement & rebalance plane.

One scoring core (engine.py) shared by admission-time placement
(VolumeGrowth replica picks, VolumeLayout.pick_for_write, ec.encode's
rack-capped shard spread) and the rebalance planner (plan.py), executed
byte-costed and maintenance-class-tagged by executor.py. The shell's
volume.balance / ec.balance are thin shells over this package.

The port's copy of seaweedfs_tpu/placement/__init__.py.
"""

from .engine import (NodeView, Snapshot, pick_best, rank, score,
                     snapshot_from_servers, snapshot_from_topology,
                     spread_ec_shards)
from .executor import BalanceExecutor
from .plan import (DEFAULT_CROSS_RACK_LIMIT, DEFAULT_TARGET_SKEW,
                   MOVE_EC, MOVE_VOLUME, Move, MovePlan,
                   build_ec_balance_plan, build_volume_balance_plan)

__all__ = [
    "NodeView", "Snapshot", "score", "rank", "pick_best",
    "snapshot_from_servers", "snapshot_from_topology",
    "spread_ec_shards",
    "Move", "MovePlan", "MOVE_VOLUME", "MOVE_EC",
    "DEFAULT_TARGET_SKEW", "DEFAULT_CROSS_RACK_LIMIT",
    "build_volume_balance_plan", "build_ec_balance_plan",
    "BalanceExecutor",
]
