"""Per-action concurrent-request circuit breaker for the S3 gateway.

Reference: weed/s3api/s3api_circuit_breaker.go — global and per-bucket
limits on in-flight requests per action; exceeding a limit returns 503
SlowDown so SDK clients back off and retry, protecting the filer behind
the gateway.

Both of the reference's limit TYPES are enforced: request COUNTS and
in-flight BYTES (the reference keys its actions map `<action>:count` /
`<action>:bytes`, s3_constants LimitTypeCount/LimitTypeBytes). Byte
values accept ints or "512MB"-style strings via the qos size grammar.
Like the reference, byte accounting comes from the request's
Content-Length — it bounds in-flight UPLOAD payloads (Write/Tagging
actions); a `Read:bytes` limit never binds since GETs carry no body
(response-byte pacing is the QoS scheduler's post-charge job).

Config shape (mirrors the spirit of s3_constants circuit-breaker
config):

    {"global": {"Read": 64, "Write:count": 32, "Write:bytes": "64MB"},
     "buckets": {"mybucket": {"Write": 4, "Write:bytes": "16MB"}}}

A bare action key is a count limit (back-compat with the earlier config
documents). Absent actions are unlimited; an empty/None config disables
the breaker. The gateway folds these in-flight limits into the same
admission decision as the QoS scheduler (s3_server._route): one 503
SlowDown + Retry-After path whichever mechanism refuses.

The port's copy of seaweedfs_tpu/s3/circuit_breaker.py, unchanged in
behaviour; sizes parse through the port's qos/policy.parse_size and the
proto-shaped sections through the port's pb/s3_pb2.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from ..qos.policy import parse_size
from .auth import S3Error


class ErrTooManyRequests(S3Error):
    def __init__(self, retry_after_s: int = 1):
        super().__init__("SlowDown",
                         "Please reduce your request rate.", 503)
        # surfaced as the 503's Retry-After header (real S3 SlowDown
        # semantics: back off, then retry the identical request)
        self.retry_after_s = max(1, int(retry_after_s))


def _split_limits(section: dict) -> "tuple[dict, dict]":
    """(count_limits, byte_limits) from one action map. Keys: bare
    action or `action:count` for counts, `action:bytes` for bytes."""
    counts: dict[str, int] = {}
    nbytes: dict[str, float] = {}
    for k, v in section.items():
        action, _, kind = k.partition(":")
        kind = kind.lower()
        if kind in ("", "count"):
            counts[action] = int(v)
        elif kind == "bytes":
            nbytes[action] = parse_size(v, k)
        else:
            raise ValueError(f"circuit breaker: unknown limit type in "
                             f"{k!r} (want :count or :bytes)")
    return counts, nbytes


class CircuitBreaker:
    def __init__(self, config: "dict | None" = None):
        self._lock = threading.Lock()
        self._inflight: dict[tuple[str, str], int] = {}  # (scope, action)
        self._inflight_bytes: dict[tuple[str, str], float] = {}
        self.load(config)

    def load(self, config: "dict | None") -> None:
        """(Re)apply a config — hot-reloaded from the filer at
        /etc/s3/circuit_breaker.json (reference s3api_circuit_breaker.go
        subscribes to the same path; the document is
        s3_pb.S3CircuitBreakerConfig, pb/s3.proto). In-flight counters
        survive. Both shapes load: the proto form
        {global:{actions:{...}}} and the terse {global:{Action:N}}."""
        config = config or {}

        def limits(section: dict) -> "tuple[dict, dict]":
            if "actions" in section or "enabled" in section:
                # proto S3CircuitBreakerOptions shape — validate it.
                # `enabled` semantics: an EXPLICIT false disables; an
                # absent key counts as on (divergence from strict proto3
                # omission noted: our shell always writes explicit keys,
                # and silently enforcing a disabled config is the worse
                # failure mode of the two).
                from google.protobuf import json_format

                from ..pb import s3_pb2 as spb
                opts = json_format.ParseDict(section,
                                             spb.S3CircuitBreakerOptions(),
                                             ignore_unknown_fields=True)
                if section.get("enabled") is False:
                    return {}, {}  # kept on disk but switched off
                merged = dict(opts.actions)
                # terse top-level action keys overlay (the shell's
                # s3.circuitbreaker writes Action:N at section level;
                # dropping them silently would ignore operator edits).
                # Byte limits may arrive as "64MB" strings, which the
                # proto's int64 map can't carry — overlay those too.
                for k, v in section.items():
                    if k not in ("enabled", "actions") and \
                            isinstance(v, (int, float, str)):
                        merged[k] = v
                return _split_limits(merged)
            return _split_limits(dict(section))

        with self._lock:
            self.global_limits, self.global_byte_limits = \
                limits(config.get("global") or {})
            self.bucket_limits = {}
            self.bucket_byte_limits = {}
            for b, v in (config.get("buckets") or {}).items():
                counts, nbytes = limits(v)
                self.bucket_limits[b] = counts
                self.bucket_byte_limits[b] = nbytes
            self.enabled = bool(
                self.global_limits or self.bucket_limits
                or self.global_byte_limits
                or any(self.bucket_byte_limits.values()))

    @contextmanager
    def acquire(self, action: str, bucket: str, nbytes: int = 0):
        """Admit one request of `nbytes` payload (0 = size-free read).
        Count and byte caps share this one enforcement path — exceeding
        EITHER sheds with 503 SlowDown before any work happens."""
        if not self.enabled:
            yield
            return
        keys = []       # ((scope, action), count_limit | None)
        byte_keys = []  # ((scope, action), byte_limit)
        g_limit = self.global_limits.get(action)
        if g_limit is not None:
            keys.append((("", action), g_limit))
        b_limit = self.bucket_limits.get(bucket, {}).get(action)
        if b_limit is not None:
            keys.append(((bucket, action), b_limit))
        gb = self.global_byte_limits.get(action)
        if gb is not None:
            byte_keys.append((("", action), gb))
        bb = self.bucket_byte_limits.get(bucket, {}).get(action)
        if bb is not None:
            byte_keys.append(((bucket, action), bb))
        taken: list = []
        taken_bytes: list = []
        with self._lock:
            try:
                for key, limit in keys:
                    if self._inflight.get(key, 0) >= limit:
                        raise ErrTooManyRequests()
                    self._inflight[key] = self._inflight.get(key, 0) + 1
                    taken.append(key)
                for key, limit in byte_keys:
                    cur = self._inflight_bytes.get(key, 0.0)
                    # an over-sized single request must still pass an
                    # idle gateway (cur == 0), or it could NEVER run
                    if cur > 0 and cur + nbytes > limit:
                        raise ErrTooManyRequests()
                    self._inflight_bytes[key] = cur + nbytes
                    taken_bytes.append(key)
            except ErrTooManyRequests:
                for k in taken:  # roll back partial acquisition
                    self._inflight[k] -= 1
                for k in taken_bytes:
                    self._inflight_bytes[k] -= nbytes
                raise
        try:
            yield
        finally:
            with self._lock:
                for key in taken:
                    self._inflight[key] -= 1
                for key in taken_bytes:
                    self._inflight_bytes[key] -= nbytes
