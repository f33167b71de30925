"""Multi-tenant QoS plane: admission, fairness, and priority classes.

The port's copy of seaweedfs_tpu/qos/ (no JAX in it): the same classes,
header, policy document and scheduler, so a policy file and the
`x-swtpu-qos` tag mean the same on either package's servers. The port
enforces it at the volume server's HTTP plane and on its maintenance RPCs.

The batched data planes (`/bulk`, `/bulk-read`, streaming) make single
workloads fast; this package keeps those wins under ADVERSARIAL mixes.
The warehouse-cluster study (PAPERS.md arXiv:1309.0186) measured repair
traffic alone dominating shared links — noisy neighbors are not hypothetical at
production scale, they are the steady state. Three mechanisms, one
scheduler core (scheduler.py), one policy document (policy.py):

  * hierarchical token buckets — per-tenant request + byte rates with
    burst credit, nested under per-class and node-wide buckets;
  * weighted-fair queueing — deficit round-robin over per-tenant
    queues, weights from the hot-reloadable policy doc;
  * priority classes — interactive reads > ingest > maintenance;
    repair/replication/rebuild traffic is tagged at the source and
    YIELDS to queued foreground work instead of competing for the same
    read pools and volume locks.

Enforcement points live at both tiers: the S3 gateway (tenant = access
key / bucket) and the volume server HTTP plane (tenant = collection),
each answering sheds with 503 + Retry-After like real S3's SlowDown.

This module holds the class-tag plumbing: a contextvar carried across
threads (contextvars.copy_context is already threaded through every
executor hop), injected on outbound HTTP (client/http_util) and gRPC
(utils/rpc) hops as the `x-swtpu-qos` header/metadata so a repair
driven by the maintenance executor stays maintenance-class across every
machine it touches.
"""

from __future__ import annotations

import contextlib
import contextvars

# priority classes, highest first (scheduler serves in this order)
CLASS_INTERACTIVE = "interactive"
CLASS_INGEST = "ingest"
CLASS_MAINTENANCE = "maintenance"
CLASSES = (CLASS_INTERACTIVE, CLASS_INGEST, CLASS_MAINTENANCE)

# the tag a request carries across process hops (HTTP header form; the
# same key travels as gRPC metadata)
QOS_HEADER = "x-swtpu-qos"

# overflow tenant: past the policy's max_tenants ceiling, the long tail
# of tenant ids shares one bucket/label so metrics cardinality and
# scheduler state stay bounded no matter how many tenants exist
OVERFLOW_TENANT = "~other"

_class_var: contextvars.ContextVar[str] = contextvars.ContextVar(
    "swtpu_qos_class", default="")


def current_class() -> str:
    """The traffic class tagged on the current execution flow
    ('' = untagged: the enforcement point picks from the verb)."""
    return _class_var.get()


@contextlib.contextmanager
def tagged(klass: str):
    """Tag everything inside (and every copy_context hop below) with a
    traffic class — the maintenance executor wraps repair dispatch in
    `tagged(CLASS_MAINTENANCE)` so its reads yield to foreground."""
    token = _class_var.set(klass)
    try:
        yield
    finally:
        _class_var.reset(token)


def set_class(klass: str):
    """Imperative form for server-side extraction (gRPC handler threads
    set the inbound tag, then reset with the returned token)."""
    return _class_var.set(klass)


def reset_class(token) -> None:
    _class_var.reset(token)


def injectable() -> str:
    """Header value to attach to an outbound hop ('' = nothing)."""
    return _class_var.get()


def inject(headers: dict) -> dict:
    """Attach the current class tag to an outbound header dict (mirrors
    tracing.inject; mutates AND returns `headers`)."""
    klass = _class_var.get()
    if klass:
        headers[QOS_HEADER] = klass
    return headers


def class_from_headers(headers, default: str) -> str:
    """The effective class of an inbound request. An explicit tag is
    honored only as a DOWNGRADE from the verb-derived default: internal
    maintenance flows legitimately demote themselves, but a client must
    never self-classify UP (an antagonist stamping its bulk PUTs
    `interactive` would jump the priority queues and escape its ingest
    caps — the exact traffic the classes exist to contain). Unknown tag
    values can't mint scheduler state either."""
    try:
        tag = headers.get(QOS_HEADER, "")
    except Exception:  # noqa: BLE001 — headers-like of any shape
        tag = ""
    if tag in CLASSES and default in CLASSES and \
            CLASSES.index(tag) >= CLASSES.index(default):
        return tag
    return default


from .policy import QosPolicy, parse_policy  # noqa: E402
from .scheduler import Grant, QosScheduler, QosShed  # noqa: E402

__all__ = [
    "CLASS_INTERACTIVE", "CLASS_INGEST", "CLASS_MAINTENANCE", "CLASSES",
    "QOS_HEADER", "OVERFLOW_TENANT",
    "current_class", "tagged", "set_class", "reset_class",
    "injectable", "inject", "class_from_headers",
    "QosPolicy", "parse_policy", "QosScheduler", "QosShed", "Grant",
]
