"""filer.conf: per-path-prefix storage rules, stored IN the filer.

Reference: weed/filer/filer_conf.go — a protobuf text entry at
/etc/seaweedfs/filer.conf holds `locations` rules; the longest matching
location_prefix decides collection / replication / ttl / disk_type / fsync
(+ volume_growth_count) for writes under that prefix, hot-reloaded whenever
the entry changes. Here the payload is JSON (same rule fields), e.g.:

    {"locations": [
        {"location_prefix": "/buckets/logs/", "collection": "logs",
         "ttl": "7d", "disk_type": "hdd"},
        {"location_prefix": "/hot/", "replication": "010",
         "disk_type": "ssd", "fsync": true}]}

The port's copy of seaweedfs_tpu/filer/filer_conf.py, unchanged.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

CONF_DIR = "/etc/seaweedfs"
CONF_NAME = "filer.conf"
CONF_PATH = f"{CONF_DIR}/{CONF_NAME}"


@dataclass(frozen=True)
class PathRule:
    location_prefix: str
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    disk_type: str = ""
    fsync: bool = False
    volume_growth_count: int = 0
    # set when an S3 PutBucketLifecycle created/claimed this rule's TTL;
    # DeleteBucketLifecycle strips only marked rules, so TTLs an admin
    # set via fs.configure under the bucket survive S3 lifecycle churn
    from_lifecycle: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "PathRule":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class FilerConf:
    rules: list[PathRule] = field(default_factory=list)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "FilerConf":
        if not raw:
            return cls()
        doc = json.loads(raw.decode())
        return cls([PathRule.from_dict(r) for r in doc.get("locations", [])])

    def to_bytes(self) -> bytes:
        return json.dumps(
            {"locations": [
                {k: getattr(r, k) for k in PathRule.__dataclass_fields__
                 if getattr(r, k) not in ("", False, 0)}
                for r in self.rules]},
            indent=2).encode()

    def match(self, path: str) -> "PathRule | None":
        """Longest matching location_prefix wins (filer_conf.go MatchStorageRule)."""
        best: PathRule | None = None
        for r in self.rules:
            if path.startswith(r.location_prefix):
                if best is None or len(r.location_prefix) > len(best.location_prefix):
                    best = r
        return best

    def upsert(self, rule: PathRule) -> None:
        self.rules = [r for r in self.rules
                      if r.location_prefix != rule.location_prefix]
        self.rules.append(rule)

    def delete(self, location_prefix: str) -> None:
        self.rules = [r for r in self.rules
                      if r.location_prefix != location_prefix]
