"""QoS policy document: the operator-owned knob surface (the port's copy
of seaweedfs_tpu/qos/policy.py).

One JSON document configures both tiers, hot-reloadable exactly like
the S3 circuit breaker's config (stored at /etc/qos/policy.json in the
filer for gateways, passed as `-qosPolicy <file>` to volume servers,
POSTable to /debug/qos for live retuning). Shape:

    {
      "enabled": true,
      "node":    {"rps": 0, "bytes_per_s": "64MB", "max_inflight": 0},
      "classes": {
        "interactive": {"max_wait_s": 1.0},
        "ingest":      {"max_wait_s": 5.0},
        "maintenance": {"max_wait_s": 30.0, "rps": 0,
                        "bytes_per_s": "8MB", "max_inflight": 2}
      },
      "default": {"weight": 10, "rps": 0, "burst": 0,
                  "bytes_per_s": 0, "burst_bytes": 0, "max_queue": 64},
      "tenants": {
        "victim": {"weight": 100},
        "antag":  {"weight": 10, "bytes_per_s": "2MB",
                   "burst_bytes": "4MB"}
      },
      "max_tenants": 64,
      "quantum_bytes": 65536
    }

Semantics:
  * 0 / absent = unlimited for every rate/cap knob;
  * byte knobs accept ints or "4MB"/"512KB"/"1GB" strings;
  * `default` is the profile a tenant NOT named in `tenants` gets;
  * `max_tenants` bounds distinct tenant states (and the metric label
    space) — the long tail past it shares the "~other" overflow bucket;
  * burst defaults to one second of rate when left 0 alongside a rate.

`parse_policy` validates hard (ValueError with the offending key) so a
typo'd document is rejected at load instead of silently admitting
everything.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import CLASSES

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([KMGT]?)I?B?\s*$",
                      re.IGNORECASE)
_UNITS = {"": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}

# class-level defaults: how long a request may queue before it sheds
_DEFAULT_MAX_WAIT_S = {"interactive": 1.0, "ingest": 5.0,
                       "maintenance": 30.0}


def parse_size(v, key: str = "") -> float:
    """Int/float pass through; "4MB"-style strings parse; anything else
    raises. 0 means unlimited by convention."""
    if isinstance(v, bool):
        raise ValueError(f"qos policy: {key or 'size'} must be a number "
                         f"or size string, got {v!r}")
    if isinstance(v, (int, float)):
        if v < 0:
            raise ValueError(f"qos policy: {key or 'size'} must be >= 0")
        return float(v)
    if isinstance(v, str):
        m = _SIZE_RE.match(v)
        if m:
            return float(m.group(1)) * _UNITS[m.group(2).upper()]
    raise ValueError(f"qos policy: bad size {v!r} for {key or 'value'}")


def _num(section: dict, key: str, default: float = 0.0,
         where: str = "") -> float:
    v = section.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"qos policy: {where}{key} must be a number, "
                         f"got {v!r}")
    if v < 0:
        raise ValueError(f"qos policy: {where}{key} must be >= 0")
    return float(v)


@dataclass(frozen=True)
class BucketSpec:
    """One token-bucket pair spec: request rate + byte rate (0 = off)."""
    rps: float = 0.0
    burst: float = 0.0
    bytes_per_s: float = 0.0
    burst_bytes: float = 0.0
    max_inflight: int = 0


@dataclass(frozen=True)
class TenantSpec(BucketSpec):
    weight: int = 10
    max_queue: int = 64


@dataclass(frozen=True)
class ClassSpec(BucketSpec):
    max_wait_s: float = 5.0


@dataclass(frozen=True)
class QosPolicy:
    enabled: bool = False
    node: BucketSpec = field(default_factory=BucketSpec)
    classes: "dict[str, ClassSpec]" = field(default_factory=dict)
    default: TenantSpec = field(default_factory=TenantSpec)
    tenants: "dict[str, TenantSpec]" = field(default_factory=dict)
    max_tenants: int = 64
    quantum_bytes: int = 65536

    def tenant_spec(self, name: str) -> TenantSpec:
        return self.tenants.get(name, self.default)

    def class_spec(self, klass: str) -> ClassSpec:
        spec = self.classes.get(klass)
        if spec is None:
            spec = ClassSpec(
                max_wait_s=_DEFAULT_MAX_WAIT_S.get(klass, 5.0))
        return spec


def _bucket_fields(section: dict, where: str) -> dict:
    out = {
        "rps": _num(section, "rps", 0.0, where),
        "burst": _num(section, "burst", 0.0, where),
        "bytes_per_s": parse_size(section.get("bytes_per_s", 0),
                                  where + "bytes_per_s"),
        "burst_bytes": parse_size(section.get("burst_bytes", 0),
                                  where + "burst_bytes"),
        "max_inflight": int(_num(section, "max_inflight", 0, where)),
    }
    # burst credit defaults to one second of the configured rate — a
    # bucket with rate but zero burst could never admit anything
    if out["rps"] and not out["burst"]:
        out["burst"] = max(1.0, out["rps"])
    if out["bytes_per_s"] and not out["burst_bytes"]:
        out["burst_bytes"] = out["bytes_per_s"]
    return out


_TENANT_KEYS = {"rps", "burst", "bytes_per_s", "burst_bytes",
                "max_inflight", "weight", "max_queue"}
_CLASS_KEYS = {"rps", "burst", "bytes_per_s", "burst_bytes",
               "max_inflight", "max_wait_s"}
_NODE_KEYS = {"rps", "burst", "bytes_per_s", "burst_bytes",
              "max_inflight"}
_TOP_KEYS = {"enabled", "node", "classes", "default", "tenants",
             "max_tenants", "quantum_bytes"}


def _check_keys(section: dict, allowed: set, where: str) -> None:
    unknown = set(section) - allowed
    if unknown:
        raise ValueError(
            f"qos policy: unknown key(s) {sorted(unknown)} in {where}")


def _tenant_spec(section: dict, where: str) -> TenantSpec:
    if not isinstance(section, dict):
        raise ValueError(f"qos policy: {where} must be an object")
    _check_keys(section, _TENANT_KEYS, where)
    weight = int(_num(section, "weight", 10, where))
    if weight <= 0:
        raise ValueError(f"qos policy: {where}weight must be >= 1")
    return TenantSpec(weight=weight,
                      max_queue=int(_num(section, "max_queue", 64, where)),
                      **_bucket_fields(section, where))


def parse_policy(doc: "dict | None") -> QosPolicy:
    """Validate + freeze one policy document. None/{} (or enabled:false)
    parses to a DISABLED policy — the scheduler short-circuits."""
    if not doc:
        return QosPolicy(enabled=False)
    if not isinstance(doc, dict):
        raise ValueError("qos policy: document must be a JSON object")
    _check_keys(doc, _TOP_KEYS, "top level")
    enabled = doc.get("enabled", True)
    if not isinstance(enabled, bool):
        raise ValueError("qos policy: enabled must be true/false")

    node_sec = doc.get("node") or {}
    if not isinstance(node_sec, dict):
        raise ValueError("qos policy: node must be an object")
    _check_keys(node_sec, _NODE_KEYS, "node.")
    node = BucketSpec(**_bucket_fields(node_sec, "node."))

    classes: dict[str, ClassSpec] = {}
    for klass, sec in (doc.get("classes") or {}).items():
        if klass not in CLASSES:
            raise ValueError(f"qos policy: unknown class {klass!r} "
                             f"(know {list(CLASSES)})")
        if not isinstance(sec, dict):
            raise ValueError(f"qos policy: classes.{klass} must be an "
                             "object")
        _check_keys(sec, _CLASS_KEYS, f"classes.{klass}.")
        classes[klass] = ClassSpec(
            max_wait_s=_num(sec, "max_wait_s",
                            _DEFAULT_MAX_WAIT_S.get(klass, 5.0),
                            f"classes.{klass}."),
            **_bucket_fields(sec, f"classes.{klass}."))

    default = _tenant_spec(doc.get("default") or {}, "default.")
    tenants = {}
    for name, sec in (doc.get("tenants") or {}).items():
        if not isinstance(name, str) or not name:
            raise ValueError(f"qos policy: bad tenant name {name!r}")
        tenants[name] = _tenant_spec(sec, f"tenants.{name}.")

    max_tenants = int(_num(doc, "max_tenants", 64))
    if max_tenants < 1:
        raise ValueError("qos policy: max_tenants must be >= 1")
    quantum = int(_num(doc, "quantum_bytes", 65536))
    if quantum < 1:
        raise ValueError("qos policy: quantum_bytes must be >= 1")
    return QosPolicy(enabled=enabled, node=node, classes=classes,
                     default=default, tenants=tenants,
                     max_tenants=max_tenants, quantum_bytes=quantum)
