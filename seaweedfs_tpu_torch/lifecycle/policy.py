"""Lifecycle policy: per-collection temperature rules.

One JSON/dict document (the shape every other control-plane knob here
uses — qos policy, breaker config), hot-attachable to the master via
`-lifecyclePolicy FILE` and to `lifecycle.apply -policy FILE`:

    {"rules": [
        {"collection": "logs",        # exact name, or "*" for any
         "ec_after_s": 86400,         # hot→EC once writes AND reads
                                      #   have been quiet this long
         "remote_after_s": 604800,    # EC→remote once reads have been
         "remote": "s3:http://...",   #   quiet this long, to this tier
         "promote_reads": 16,         # remote→local after this many
                                      #   ranged remote reads
         "ttl_s": 2592000,            # DestroyTime stamped at encode
         "min_size_bytes": 4096}]}    # ignore near-empty volumes

Rules are matched in document order, exact collection names before the
"*" wildcard would shadow them — put specific rules first. Thresholds
left out (None) disable that transition for the matched collection.

The port's copy of seaweedfs_tpu/lifecycle/policy.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class LifecycleRule:
    collection: str = "*"
    ec_after_s: "float | None" = None
    remote_after_s: "float | None" = None
    remote: str = ""
    promote_reads: int = 0
    ttl_s: "float | None" = None
    min_size_bytes: int = 1

    def validate(self) -> None:
        if self.remote_after_s is not None and not self.remote:
            raise ValueError(
                f"rule for {self.collection!r}: remote_after_s needs a "
                "`remote` backend spec")
        for name in ("ec_after_s", "remote_after_s", "ttl_s"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"rule for {self.collection!r}: "
                                 f"{name} must be >= 0")
        if self.promote_reads < 0:
            raise ValueError(f"rule for {self.collection!r}: "
                             "promote_reads must be >= 0")

    def matches(self, collection: str) -> bool:
        return self.collection == "*" or self.collection == collection


@dataclass
class LifecyclePolicy:
    rules: "list[LifecycleRule]" = field(default_factory=list)
    source: str = ""  # file path when loaded from disk (status display)

    def rule_for(self, collection: str) -> "LifecycleRule | None":
        """First matching rule in document order ('' collection matches
        the same way any name does — 'default' data is not special)."""
        for r in self.rules:
            if r.matches(collection):
                return r
        return None

    def to_doc(self) -> dict:
        out = []
        for r in self.rules:
            d = {"collection": r.collection}
            for k in ("ec_after_s", "remote_after_s", "ttl_s"):
                if getattr(r, k) is not None:
                    d[k] = getattr(r, k)
            if r.remote:
                d["remote"] = r.remote
            if r.promote_reads:
                d["promote_reads"] = r.promote_reads
            if r.min_size_bytes != 1:
                d["min_size_bytes"] = r.min_size_bytes
            out.append(d)
        return {"rules": out}


_RULE_KEYS = {"collection", "ec_after_s", "remote_after_s", "remote",
              "promote_reads", "ttl_s", "min_size_bytes"}


def parse_policy(doc: "dict | str") -> LifecyclePolicy:
    """dict = an inline policy document; str = a JSON file path."""
    source = ""
    if isinstance(doc, str):
        source = doc
        with open(doc, encoding="utf-8") as f:
            doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"lifecycle policy must be a dict, got "
                         f"{type(doc).__name__}")
    rules = []
    for i, rd in enumerate(doc.get("rules", [])):
        unknown = set(rd) - _RULE_KEYS
        if unknown:
            raise ValueError(f"rule #{i}: unknown keys {sorted(unknown)}")
        rule = LifecycleRule(
            collection=rd.get("collection", "*"),
            ec_after_s=rd.get("ec_after_s"),
            remote_after_s=rd.get("remote_after_s"),
            remote=rd.get("remote", ""),
            promote_reads=int(rd.get("promote_reads", 0)),
            ttl_s=rd.get("ttl_s"),
            min_size_bytes=int(rd.get("min_size_bytes", 1)))
        rule.validate()
        rules.append(rule)
    return LifecyclePolicy(rules=rules, source=source)
