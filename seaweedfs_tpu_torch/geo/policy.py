"""Per-link cost policy: what a byte costs by where it travels.

The Facebook warehouse study's core observation is that repair and
rebalance traffic is priced by the *link it crosses*, not its raw
size — a cross-DC byte contends for the thinnest, most expensive pipe
in the fleet. This policy gives every plane that moves bytes one
shared price list:

    {
      "intra_rack": 1.0,
      "cross_rack": 4.0,
      "cross_dc": 25.0,
      "overrides": [{"a": "dc1", "b": "dc2", "cost": 50.0}],
      "cross_dc_budget": "10GiB",
      "replication_lag_bound_s": 60
    }

All keys are optional; costs must satisfy intra_rack <= cross_rack <=
cross_dc (a price list that rewards distance would invert every
planner preference this plane exists to create). `overrides` price a
specific unordered DC pair — e.g. a pair joined by a thin transit
link — and must be >= cross_rack. `cross_dc_budget` (bytes, qos-style
size strings accepted, 0 = unlimited) caps planner cross-DC traffic
per sweep; `replication_lag_bound_s` is the geo-replication invariant
(geo/replication.py) and the chaos lane's recovery bound.

Same doc-or-file convention as -qosPolicy/-lifecyclePolicy/-sloPolicy:
the master's `-linkCosts` flag accepts inline JSON or a path.

The port's copy of seaweedfs_tpu/geo/policy.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..qos.policy import parse_size

LINK_CLASSES = ("intra_rack", "cross_rack", "cross_dc")

_TOP_KEYS = {"intra_rack", "cross_rack", "cross_dc", "overrides",
             "cross_dc_budget", "replication_lag_bound_s"}
_OVERRIDE_KEYS = {"a", "b", "cost"}

DEFAULT_INTRA_RACK = 1.0
DEFAULT_CROSS_RACK = 4.0
DEFAULT_CROSS_DC = 25.0


def _cost(doc: dict, key: str, default: float) -> float:
    v = doc.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"link costs: {key} must be a number, got {v!r}")
    if v <= 0:
        raise ValueError(f"link costs: {key} must be > 0")
    return float(v)


@dataclass(frozen=True)
class LinkCostModel:
    """Frozen price list; `cost()` is the one lookup every plane uses."""
    intra_rack: float = DEFAULT_INTRA_RACK
    cross_rack: float = DEFAULT_CROSS_RACK
    cross_dc: float = DEFAULT_CROSS_DC
    # unordered dc-pair overrides: {frozenset({a, b}): cost}
    overrides: dict = field(default_factory=dict)
    cross_dc_budget: float = 0.0
    replication_lag_bound_s: float = 0.0

    def classify(self, dc_a: str, rack_a: str, dc_b: str, rack_b: str,
                 ) -> str:
        """Link class between two endpoints. Unknown ("") locations
        compare equal — absence of topology info must never surcharge
        a single-site fleet."""
        if dc_a != dc_b:
            return "cross_dc"
        if rack_a != rack_b:
            return "cross_rack"
        return "intra_rack"

    def cost(self, dc_a: str, rack_a: str, dc_b: str, rack_b: str,
             ) -> float:
        """Cost multiplier for one byte between the two endpoints."""
        link = self.classify(dc_a, rack_a, dc_b, rack_b)
        if link == "cross_dc":
            ov = self.overrides.get(frozenset((dc_a, dc_b)))
            return ov if ov is not None else self.cross_dc
        return getattr(self, link)

    def weighted(self, nbytes: float, dc_a: str, rack_a: str,
                 dc_b: str, rack_b: str) -> float:
        return nbytes * self.cost(dc_a, rack_a, dc_b, rack_b)

    def to_doc(self) -> dict:
        """Round-trippable policy doc (`parse_link_costs(to_doc())` ==
        self) — the master serves this at /cluster/linkcosts so shell
        planners price moves with the exact fleet policy."""
        return {
            "intra_rack": self.intra_rack,
            "cross_rack": self.cross_rack,
            "cross_dc": self.cross_dc,
            "overrides": [{"a": a, "b": b, "cost": c}
                          for (a, b), c in sorted(
                              (tuple(sorted(k)), v)
                              for k, v in self.overrides.items())],
            "cross_dc_budget": int(self.cross_dc_budget),
            "replication_lag_bound_s": self.replication_lag_bound_s,
        }


def parse_link_costs(doc: "dict | None") -> LinkCostModel:
    """Validate + freeze one policy document. None/{} parses to the
    default price list (still ordered, so geo preferences apply even
    without an explicit policy)."""
    if not doc:
        return LinkCostModel()
    if not isinstance(doc, dict):
        raise ValueError("link costs: document must be a JSON object")
    unknown = set(doc) - _TOP_KEYS
    if unknown:
        raise ValueError(f"link costs: unknown key(s) {sorted(unknown)}")
    intra = _cost(doc, "intra_rack", DEFAULT_INTRA_RACK)
    cross_rack = _cost(doc, "cross_rack", DEFAULT_CROSS_RACK)
    cross_dc = _cost(doc, "cross_dc", DEFAULT_CROSS_DC)
    if not intra <= cross_rack <= cross_dc:
        raise ValueError(
            "link costs: must order intra_rack <= cross_rack <= cross_dc "
            f"(got {intra} / {cross_rack} / {cross_dc})")
    overrides: dict = {}
    ov_list = doc.get("overrides") or []
    if not isinstance(ov_list, list):
        raise ValueError("link costs: overrides must be a list")
    for i, ov in enumerate(ov_list):
        if not isinstance(ov, dict):
            raise ValueError(f"link costs: overrides[{i}] must be an object")
        unknown = set(ov) - _OVERRIDE_KEYS
        if unknown:
            raise ValueError(f"link costs: unknown key(s) {sorted(unknown)} "
                             f"in overrides[{i}]")
        a, b = ov.get("a"), ov.get("b")
        if not (isinstance(a, str) and a and isinstance(b, str) and b
                and a != b):
            raise ValueError(f"link costs: overrides[{i}] needs distinct "
                             "non-empty dc names a/b")
        c = _cost(ov, "cost", cross_dc)
        if c < cross_rack:
            raise ValueError(f"link costs: overrides[{i}].cost {c} below "
                             f"cross_rack {cross_rack} would misorder links")
        key = frozenset((a, b))
        if key in overrides:
            raise ValueError(f"link costs: duplicate override for {a}/{b}")
        overrides[key] = c
    lag = doc.get("replication_lag_bound_s", 0.0)
    if isinstance(lag, bool) or not isinstance(lag, (int, float)) or lag < 0:
        raise ValueError("link costs: replication_lag_bound_s must be a "
                         f"number >= 0, got {lag!r}")
    return LinkCostModel(
        intra_rack=intra, cross_rack=cross_rack, cross_dc=cross_dc,
        overrides=overrides,
        cross_dc_budget=parse_size(doc.get("cross_dc_budget", 0),
                                   "cross_dc_budget"),
        replication_lag_bound_s=float(lag))


def load_link_costs(arg: "str | None") -> LinkCostModel:
    """`-linkCosts` flag value: inline JSON ("{...}") or a file path;
    empty/None -> defaults."""
    if not arg:
        return LinkCostModel()
    if arg.lstrip().startswith("{"):
        return parse_link_costs(json.loads(arg))
    with open(arg, encoding="utf-8") as f:
        return parse_link_costs(json.load(f))
