"""Process-local heavy-hitter recording for the data-plane daemons.

The volume server calls `record()` on every request with whatever
dimensions it knows (volume id, qos tenant, RPC method, payload
bytes); each dimension feeds a space-saving sketch pair (requests +
bytes). A pre-scrape hook mirrors the sketches into the bounded
`SeaweedFS_hot_requests{kind,key}` / `SeaweedFS_hot_bytes{kind,key}`
gauge families on every /metrics render, which is how the leader's
fleet collector sees them: it scrapes the gauges, computes per-key
deltas, and merges them into cluster-wide top-k sketches. One
pipeline, no side channel.

The sketches are unbounded-key-safe by construction (top-k eviction,
telemetry/topk.py), so this is the ONLY sanctioned way for volume ids
or long-tail tenants to reach a metric label.

The port's copy of seaweedfs_tpu/telemetry/hot.py: the gauges are the
port's `stats.HOT_REQUESTS` / `HOT_BYTES`, so a JAX-package collector
scraping a port volume server's /metrics merges its hot keys.
"""

from __future__ import annotations

from ..utils.env import env_int
from .topk import SpaceSaving

KINDS = ("volume", "tenant", "method")


class HotKeys:
    def __init__(self, capacity: "int | None" = None):
        cap = capacity or env_int("SWTPU_HOT_KEYS", 32)
        self.requests = {k: SpaceSaving(cap) for k in KINDS}
        self.bytes = {k: SpaceSaving(cap) for k in KINDS}

    def record(self, volume=None, tenant=None, method=None,
               nbytes: int = 0) -> None:
        for kind, key in (("volume", volume), ("tenant", tenant),
                          ("method", method)):
            if key in (None, ""):
                continue
            key = str(key)
            self.requests[kind].offer(key)
            if nbytes > 0:
                self.bytes[kind].offer(key, float(nbytes))

    def refresh_gauges(self) -> None:
        from ..stats import HOT_BYTES, HOT_REQUESTS
        for gauge, sketches in ((HOT_REQUESTS, self.requests),
                                (HOT_BYTES, self.bytes)):
            gauge.clear()
            for kind, sk in sketches.items():
                for item in sk.items():
                    gauge.set(kind, item["key"], value=item["count"])

    def snapshot(self, limit: int = 10) -> dict:
        return {"requests": {k: sk.items(limit)
                             for k, sk in self.requests.items()},
                "bytes": {k: sk.items(limit)
                          for k, sk in self.bytes.items()}}

    def clear(self) -> None:
        for sk in (*self.requests.values(), *self.bytes.values()):
            sk.clear()


HOT = HotKeys()


def record(volume=None, tenant=None, method=None, nbytes: int = 0) -> None:
    """Hot-path entry point — must never raise into a request."""
    try:
        HOT.record(volume=volume, tenant=tenant, method=method,
                   nbytes=nbytes)
    except Exception:  # noqa: BLE001  # swtpu-lint: disable=silent-except (observability must never break serving)
        pass


def _install_scrape_hook() -> None:
    from ..stats import register_scrape_hook
    register_scrape_hook(HOT.refresh_gauges)


_install_scrape_hook()
