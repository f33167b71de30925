"""Tiered-storage lifecycle plane: policy-driven hot → EC-cold → remote.

Data cools on a predictable curve (the f4 warm-BLOB observation,
PAPERS.md): most objects are read hard for days, then almost never.
Keeping cold data 3x-replicated on the hot tier wastes disks; keeping it
erasure-coded on local SSD still wastes the fast tier. The fork's own
behaviors all point at automated temperature management — EC volumes
carry DestroyTime TTLs and are reaped, shards move to a target disk
type, EC sources must be SSD — but every one of those verbs is manual.
This package turns them into an automated, observable, budgeted plane:

  * `policy.py` — per-collection rules: cool-down ages (from the
    per-volume access stats the storage layer keeps and the read-cache
    counters), a remote tier spec, a promote-on-heat threshold and an
    optional TTL;
  * `planner.py` — scans the live topology + per-server heat reports
    into a deterministic `LifecyclePlan` of transitions: cooling
    replicated volumes EC-encode through the overlapped device pipeline
    and land rack-safe via the placement core; cold EC
    shards offload their payload behind `storage/backend.py` with lazy
    ranged read-through; hot offloaded volumes promote back; expired
    `DestroyTime` volumes reap through the existing soft-delete trash
    path on the volume servers;
  * `executor.py` — runs plans as maintenance-class QoS traffic
    under a byte-costed admission budget (the repair planner's
    cheapest-first ordering + bytes budget), journaling every
    move as a `lifecycle.transition` event and metering
    `SeaweedFS_lifecycle_{transitions,bytes_moved}_total{from,to}`.

Operator surface: shell `lifecycle.status` / `lifecycle.apply
[-dryRun]`, master `-lifecyclePolicy` wiring the plane into the
maintenance cron (zero operator commands end-to-end), and
`/debug/lifecycle` on master (policy + recent transitions) and volume
servers (per-volume heat + tier state).

The port's copy of seaweedfs_tpu/lifecycle/__init__.py.
"""

from __future__ import annotations

# tier names: the {from,to} label values on lifecycle metrics/events.
# A tiny closed set by construction (metrics-lint enforces a ceiling).
TIER_HOT = "hot"        # replicated, writable, local .dat
TIER_EC = "ec"          # erasure-coded, local shards
TIER_REMOTE = "remote"  # erasure-coded, shard payload in a remote tier
TIER_TRASH = "trash"    # soft-deleted (DestroyTime reap), restorable
TIERS = (TIER_HOT, TIER_EC, TIER_REMOTE, TIER_TRASH)

from .policy import LifecyclePolicy, LifecycleRule, parse_policy  # noqa: E402
from .planner import (LifecyclePlan, Transition,  # noqa: E402
                      build_lifecycle_plan, fetch_heat)
from .executor import LifecycleExecutor  # noqa: E402

__all__ = [
    "TIER_HOT", "TIER_EC", "TIER_REMOTE", "TIER_TRASH", "TIERS",
    "LifecyclePolicy", "LifecycleRule", "parse_policy",
    "LifecyclePlan", "Transition", "build_lifecycle_plan", "fetch_heat",
    "LifecycleExecutor",
]
