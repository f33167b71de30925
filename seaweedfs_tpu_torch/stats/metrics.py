"""Metric primitives + the framework's standard metric families.

The port's copy of seaweedfs_tpu/stats/metrics.py: the same families,
metric names, label names and help text, so dashboards read either
package's /metrics alike.

Text output follows the Prometheus exposition format so the reference's
grafana/prometheus assets (docker/prometheus) work against our /metrics
endpoints (reference stats/metrics.go:335 mounts the scrape handler; :306
runs the optional push-gateway loop).
"""

from __future__ import annotations

import threading
import time
import urllib.request

from ..utils.log import logger

log = logger("stats")

_DEFAULT_BUCKETS = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Exposition content types: strict Prometheus scrapers require the
# version parameter on text/plain; exemplar-aware scrapers negotiate the
# OpenMetrics format via Accept.
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")


def _escape_label_value(v: str) -> str:
    # text-format spec: backslash, double-quote and newline must be
    # escaped inside label values or the exposition is unparseable
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(label_names: tuple[str, ...], label_values: tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"'
             for k, v in zip(label_names, label_values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labels: tuple[str, ...] = ()):
        self.name = name
        self.help = help_text
        self.label_names = labels
        self._lock = threading.Lock()

    def expose(self, openmetrics: bool = False
               ) -> list[str]:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_text, labels=()):
        super().__init__(name, help_text, labels)
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        lv = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[lv] = self._values.get(lv, 0.0) + amount

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def expose(self, openmetrics: bool = False) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            return [f"{self.name} 0"]
        return [f"{self.name}{_fmt_labels(self.label_names, lv)} {v}"
                for lv, v in items]

    def om_header(self) -> tuple[str, str]:
        """(family, kind) for the OpenMetrics HELP/TYPE header. Sample
        names NEVER change between formats (a scraper negotiating OM
        must not silently rename series under existing dashboards), so:
        `X_total` counters expose the spec-compliant suffix-free family
        `X`; legacy counters without the suffix degrade to `unknown`,
        whose samples may legally carry the bare family name."""
        if self.name.endswith("_total"):
            return self.name[:-len("_total")], "counter"
        return self.name, "unknown"


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text, labels=()):
        super().__init__(name, help_text, labels)
        self._values: dict[tuple[str, ...], float] = {}

    def set(self, *label_values: str, value: float) -> None:
        lv = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[lv] = float(value)

    def add(self, *label_values: str, amount: float = 1.0) -> None:
        lv = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[lv] = self._values.get(lv, 0.0) + amount

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def clear(self) -> None:
        """Drop every label set. For gauges mirroring an external
        bounded structure (the heavy-hitter sketches): the structure
        evicts keys, so the mirror must too or evicted keys scrape
        stale forever."""
        with self._lock:
            self._values.clear()

    def expose(self, openmetrics: bool = False) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(self.label_names, lv)} {v}"
                for lv, v in items]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, labels=(),
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        super().__init__(name, help_text, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}
        # labelset -> bucket index -> (trace_id, value, unix_ts): the
        # latest traced observation landing in that bucket (index
        # len(buckets) = +Inf). Exposed only in the OpenMetrics rendering
        # — plain text/plain 0.0.4 scrapers would reject exemplars.
        self._exemplars: dict[tuple[str, ...],
                              dict[int, tuple[str, float, float]]] = {}

    def observe(self, *label_values: str, value: float,
                trace_id: str | None = None) -> None:
        """Record one observation. `trace_id` links the latency to a
        trace (an OpenMetrics exemplar); when omitted, the active
        sampled trace — if any — is captured automatically."""
        if trace_id is None:
            try:
                from ..tracing import current_trace_id
                trace_id = current_trace_id()
            except Exception:  # noqa: BLE001 — exemplars must never break IO
                trace_id = ""
        lv = tuple(str(v) for v in label_values)
        with self._lock:
            counts = self._counts.setdefault(lv, [0] * len(self.buckets))
            idx = len(self.buckets)  # +Inf unless a finite bucket matches
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    idx = min(idx, i)
            self._sums[lv] = self._sums.get(lv, 0.0) + value
            self._totals[lv] = self._totals.get(lv, 0) + 1
            if trace_id:
                self._exemplars.setdefault(lv, {})[idx] = (
                    trace_id, value, time.time())

    def time(self, *label_values: str):
        """Context manager observing elapsed seconds."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(*label_values,
                             value=time.perf_counter() - self.t0)
                return False

        return _Timer()

    def count(self, *label_values: str) -> int:
        with self._lock:
            return self._totals.get(tuple(str(v) for v in label_values), 0)

    def sum(self, *label_values: str) -> float:
        with self._lock:
            return self._sums.get(tuple(str(v) for v in label_values), 0.0)

    def expose(self, openmetrics: bool = False) -> list[str]:
        out = []
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
            totals = dict(self._totals)
            exemplars = {lv: dict(ex) for lv, ex in self._exemplars.items()}

        def _ex(lv, idx) -> str:
            if not openmetrics:
                return ""
            ex = exemplars.get(lv, {}).get(idx)
            if ex is None:
                return ""
            tid, val, ts = ex
            return f' # {{trace_id="{tid}"}} {val} {ts:.3f}'

        for lv, counts in items:
            for i, b in enumerate(self.buckets):
                le = f'le="{b}"'
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels(self.label_names, lv, le)}"
                    f" {counts[i]}{_ex(lv, i)}")
            inf = 'le="+Inf"'
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(self.label_names, lv, inf)}"
                       f" {totals[lv]}{_ex(lv, len(self.buckets))}")
            out.append(f"{self.name}_sum{_fmt_labels(self.label_names, lv)}"
                       f" {sums[lv]}")
            out.append(f"{self.name}_count{_fmt_labels(self.label_names, lv)}"
                       f" {totals[lv]}")
        return out


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            self._metrics.append(metric)
        return metric

    def gather(self, openmetrics: bool = False) -> str:
        """Prometheus text format (reference metrics.go:31 Gather).
        `openmetrics=True` renders the OpenMetrics dialect instead:
        histogram bucket lines carry `# {trace_id="..."} value ts`
        exemplars linking latencies to /debug/traces, and the exposition
        ends with the mandatory `# EOF` terminator."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            body = m.expose(openmetrics=openmetrics)
            if not body:
                continue
            family, kind = m.name, m.kind
            if openmetrics and isinstance(m, Counter):
                family, kind = m.om_header()
            lines.append(f"# HELP {family} {m.help}")
            lines.append(f"# TYPE {family} {kind}")
            lines.extend(body)
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def metrics(self) -> "list[_Metric]":
        """Registered families snapshot (metrics-lint, tests)."""
        with self._lock:
            return list(self._metrics)


REGISTRY = Registry()


def _counter(name, help_text, labels=()):
    return REGISTRY.register(Counter(name, help_text, labels))


def _gauge(name, help_text, labels=()):
    return REGISTRY.register(Gauge(name, help_text, labels))


def _histogram(name, help_text, labels=(), **kw):
    return REGISTRY.register(Histogram(name, help_text, labels, **kw))


# Standard families (names follow reference stats/metrics.go so that
# existing dashboards keep working).
MASTER_RECEIVED_HEARTBEATS = _counter(
    "SeaweedFS_master_received_heartbeats", "master heartbeats received")
MASTER_ASSIGN_COUNTER = _counter(
    "SeaweedFS_master_assign_requests", "assign requests", ("state",))
MASTER_LEADER_CHANGES = _counter(
    "SeaweedFS_master_leader_changes", "raft leader changes")
# HA control plane. Per-process in production; test fixtures that run a
# whole quorum in one process multiplex these (last-writer-wins on the
# gauge), so in-process assertions read the RaftNode directly instead.
RAFT_TERM = _gauge(
    "SeaweedFS_raft_term", "current raft term on this master")
RAFT_LEADER_CHANGES = _counter(
    "SeaweedFS_raft_leader_changes_total",
    "raft leader identity changes observed by this node")
MASTER_LOOKUP_COUNTER = _counter(
    "SeaweedFS_master_lookup_requests",
    "dir lookups served, by answering source (topo=leader authoritative, "
    "follower=bounded-staleness replicated cache, redirect=sent to leader)",
    ("source",))
VOLUME_REQUEST_COUNTER = _counter(
    "SeaweedFS_volumeServer_request_total", "volume server requests",
    ("type", "code"))
VOLUME_REQUEST_SECONDS = _histogram(
    "SeaweedFS_volumeServer_request_seconds", "volume request latency",
    ("type",))
VOLUME_SERVER_VOLUME_GAUGE = _gauge(
    "SeaweedFS_volumeServer_volumes", "volumes on this server",
    ("collection", "type"))
VOLUME_SERVER_EC_SHARD_GAUGE = _gauge(
    "SeaweedFS_volumeServer_ec_shards", "EC shards on this server",
    ("collection",))
VOLUME_SERVER_DISK_SIZE_GAUGE = _gauge(
    "SeaweedFS_volumeServer_total_disk_size", "disk usage bytes",
    ("collection", "type"))
FILER_REQUEST_COUNTER = _counter(
    "SeaweedFS_filer_request_total", "filer requests", ("type",))
FILER_REQUEST_SECONDS = _histogram(
    "SeaweedFS_filer_request_seconds", "filer request latency", ("type",))
# Large-object data plane (filer/S3 streaming pipeline): per-chunk blob
# upload/fetch latency through the windowed fan-out, and how many chunk
# ops are in flight right now. upload ≈ assign+volume PUT under the
# retry envelope; fetch ≈ volume GET on a ReaderCache miss. A wide
# upload histogram with a full inflight gauge means the window
# (SWTPU_FILER_UPLOAD_CONC) is the bottleneck; a narrow one with low
# throughput means the volume tier is. Exemplar-linked to the
# filer.blob.* spans via the shared Histogram plumbing.
FILER_CHUNK_UPLOAD_SECONDS = _histogram(
    "SeaweedFS_filer_chunk_upload_seconds",
    "per-chunk blob upload latency on the filer large-object write path",
    buckets=(0.001, 0.005, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0))
FILER_CHUNK_FETCH_SECONDS = _histogram(
    "SeaweedFS_filer_chunk_fetch_seconds",
    "per-chunk blob fetch latency on the filer large-object read path",
    buckets=(0.001, 0.005, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0))
FILER_INFLIGHT_CHUNKS = _gauge(
    "SeaweedFS_filer_inflight_chunks",
    "chunk operations currently in flight through the filer data plane",
    ("op",))
S3_REQUEST_COUNTER = _counter(
    "SeaweedFS_s3_request_total", "s3 requests", ("type", "code", "bucket"))
S3_REQUEST_SECONDS = _histogram(
    "SeaweedFS_s3_request_seconds", "s3 request latency", ("type",))
# Device EC pipeline throughput (the device plane's own addition).
EC_ENCODE_BYTES = _counter(
    "SeaweedFS_ec_encode_bytes_total", "bytes EC-encoded", ("coder",))
EC_REBUILD_BYTES = _counter(
    "SeaweedFS_ec_rebuild_bytes_total", "bytes EC-rebuilt", ("coder",))
# EC encode pipeline stage breakdown (ec/stream.py): per encode_volumes
# call, seconds spent filling host batches, dispatching to the coder,
# blocked draining device results, and inside writer-pool pwrites. write
# >> the others with low write_overlap on the span means the writeback
# plane — not the coder — bounds the encode. Exemplar-linked to the
# ec.encode trace via the shared Histogram plumbing.
EC_PIPELINE_SECONDS = _histogram(
    "SeaweedFS_ec_pipeline_seconds",
    "EC encode pipeline stage seconds per encode_volumes call",
    ("stage",),
    buckets=(0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
             60.0, 120.0, 300.0))
EC_WRITER_QUEUE_DEPTH = _gauge(
    "SeaweedFS_ec_writer_queue_depth",
    "shard-write runs queued to the EC writeback writer pool")
# Mesh divergence: events a filer could not apply from a peer after
# retries (operators should alarm on any non-zero rate).
FILER_AGGR_DEAD_LETTERS = _counter(
    "SeaweedFS_filer_aggregator_dead_letters",
    "peer metadata events dropped after apply retries", ("peer",))
# Fault-tolerance layer (utils/retry.py): recovery behavior is observable,
# not just tested — retries per logical op, per-peer circuit state
# (0=closed, 1=open, 2=half-open), and EC reads that had to reconstruct.
RETRY_ATTEMPTS = _counter(
    "SeaweedFS_retry_attempts_total",
    "cross-node call retries after a failed attempt", ("op",))
BREAKER_STATE = _gauge(
    "SeaweedFS_breaker_state",
    "per-peer circuit breaker state (0=closed,1=open,2=half-open)",
    ("peer",))
BREAKER_TRANSITIONS = _counter(
    "SeaweedFS_breaker_transitions_total",
    "circuit breaker state transitions", ("peer", "to"))
DEGRADED_EC_READS = _counter(
    "SeaweedFS_degraded_ec_reads_total",
    "EC reads served by reconstructing from surviving shards")
# The port's own: the degraded EC read's layers inside the volume
# server's `store` stage, timed by tracing.stage (each also a range in a
# running device capture). phase: gather (survivors in hand), stage (the
# coder call: the host stack, the H2D enqueue, K1 and the D2H enqueue),
# wait (blocked on the D2H), decode (the piggyback strip and msr, which
# interleave fetches and coder calls); one shard fetch from its holders
# on the calling thread (role: survivor, a reconstruct's or a rebuild's
# survivor, or direct, a healthy interval's shard held elsewhere), that
# fetch divided (phase: first, the call to the first response message;
# rest, that message to the joined bytes) and the calling thread's own CPU across it; one
# VolumeEcShardRead answer on the serving peer (kind: range or fragment).
# `phase`, `role` and `kind` are closed sets.
_EC_READ_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
EC_DEGRADED_READ_SECONDS = _histogram(
    "SeaweedFS_ec_degraded_read_seconds",
    "degraded EC read seconds per interval and phase "
    "(gather, stage, wait, decode)",
    ("phase",), buckets=_EC_READ_BUCKETS)
EC_SHARD_FETCH_SECONDS = _histogram(
    "SeaweedFS_ec_shard_fetch_seconds",
    "remote EC shard fetch seconds, call to last byte, failed holders "
    "included, by role (survivor, direct)", ("role",),
    buckets=_EC_READ_BUCKETS)
EC_SHARD_FETCH_PHASE_SECONDS = _histogram(
    "SeaweedFS_ec_shard_fetch_phase_seconds",
    "remote EC shard fetch seconds on the fetching side by role and phase "
    "(first, rest)", ("role", "phase"), buckets=_EC_READ_BUCKETS)
EC_SHARD_FETCH_CPU_SECONDS = _histogram(
    "SeaweedFS_ec_shard_fetch_cpu_seconds",
    "the calling thread's CPU seconds across a remote EC shard fetch, "
    "by role", ("role",), buckets=(0.0001, 0.00025) + _EC_READ_BUCKETS)
EC_SHARD_SERVE_SECONDS = _histogram(
    "SeaweedFS_ec_shard_serve_seconds",
    "VolumeEcShardRead answer seconds on the serving peer, entry to the "
    "stream's end", ("kind",), buckets=_EC_READ_BUCKETS)
# The port's own: user + system CPU seconds of this process by thread
# class (profiling/threadcpu.py, read from /proc when /metrics is
# scraped): profiling.sampler's classes of the Python threads, `capture`
# for a device capture's own start and stop, and `native`, the rest of
# the process (gRPC core, the CUDA driver, torch's own pools). `class` is
# a closed set.
PROCESS_THREAD_CPU = _counter(
    "SeaweedFS_process_thread_cpu_seconds_total",
    "user + system CPU seconds of this process's threads by thread class",
    ("class",))
# Tracing layer (tracing/trace.py): spans recorded per component, and
# spans evicted from the bounded ring buffer before anyone read them.
TRACE_SPANS = _counter(
    "SeaweedFS_trace_spans_total",
    "finished sampled trace spans recorded", ("component",))
# Health plane (master/health.py): the master's per-scan data-at-risk
# roll-up — items per severity bucket, plus the raw repair-debt totals
# the Facebook warehouse study identifies as THE operational signal of
# an RS(k,m) store (stripes at reduced redundancy awaiting repair).
VOLUMES_AT_RISK = _gauge(
    "SeaweedFS_volumes_at_risk",
    "health items per severity bucket (OK/DEGRADED/AT_RISK/DATA_LOSS)",
    ("severity",))
EC_SHARDS_MISSING = _gauge(
    "SeaweedFS_ec_shards_missing",
    "EC shards missing vs. each volume's expected RS stripe width")
REPLICA_DEFICIT = _gauge(
    "SeaweedFS_replica_deficit",
    "replicas missing vs. each volume's replication policy")
NODES_STALE = _gauge(
    "SeaweedFS_nodes_stale",
    "registered volume servers whose last heartbeat is overdue")
# Repair plane (maintenance/): the queue the planner built but the
# executor hasn't drained (pending, per severity; DATA_LOSS pending =
# unrepairable items, an alert not a queue) and every repair outcome
# (result: ok/error/skipped) per action (ec.remount/ec.rebuild/
# volume.replicate).
REPAIRS_PENDING = _gauge(
    "SeaweedFS_repairs_pending",
    "planned repairs not yet executed, per item severity", ("severity",))
REPAIRS_TOTAL = _counter(
    "SeaweedFS_repairs_total",
    "repair executions by action and result (ok/error/skipped)",
    ("action", "result"))
# Repair traffic in BYTES, per codec — the warehouse-cluster metric the
# piggybacked code exists to move: a single-data-shard rebuild under
# codec "piggyback" reads ~(d+|group|)/2 half-shards where plain "rs"
# reads d full shards. bench-repair asserts the ratio; operators graph
# read-bytes-per-written-byte to see the codec win in production.
REPAIR_BYTES_READ = _counter(
    "SeaweedFS_repair_bytes_read_total",
    "survivor bytes read (local + ranged remote) to execute repairs",
    ("codec",))
REPAIR_BYTES_WRITTEN = _counter(
    "SeaweedFS_repair_bytes_written_total",
    "shard bytes written by repairs", ("codec",))
# Geo plane (geo/): the same repair traffic split by the LINK CLASS the
# fetch crossed — the warehouse-study point is that a cross-DC byte
# contends for the thinnest pipe in the fleet, so operators graph the
# cross_dc series against the link-cost policy's budget. Off-node
# fetches are attributed by the holder's data center vs this server's
# (same-DC remote hops book as cross_rack: the master's shard-location
# answers carry DC, not rack); local disk reads never book here.
# `link` is the closed geo/policy.LINK_CLASSES set (tier ceiling).
REPAIR_BYTES_BY_LINK = _counter(
    "SeaweedFS_repair_bytes_by_link_total",
    "off-node survivor bytes fetched by repairs, by link class "
    "(intra_rack/cross_rack/cross_dc)", ("codec", "link"))
# Cross-cluster async replication (geo/replication.py): age of the
# oldest filer metadata event not yet applied on the remote cluster.
# The bounded-lag invariant (link-cost policy replication_lag_bound_s,
# slo-able) is evaluated over this gauge; the chaos DC-sever lane
# asserts it returns under bound after a partition heals.
GEO_REPLICATION_LAG = _gauge(
    "SeaweedFS_geo_replication_lag_seconds",
    "cross-cluster replication lag per peer (newest unreplicated "
    "filer event age)", ("peer",))
# Per-DC fleet census from the master's health engine — the `dc` label
# family is bounded by the fleet's data-center count and gets its own
# lint ceiling (stats/expo_lint.py DC_CARDINALITY_CEILING).
CLUSTER_NODES_BY_DC = _gauge(
    "SeaweedFS_cluster_nodes",
    "registered volume servers per data center", ("dc",))
# Rebalance plane (placement/): moves executed by kind (volume / ec
# shard group) and the bytes they dragged across the fleet, split by
# rack locality — the warehouse-cluster lesson is that CROSS-RACK
# rebalance bytes compete with repair and foreground reads for the
# inter-rack fabric, so operators graph the cross_rack="true" series
# against the planner's per-run cap. Both label spaces are bounded by
# construction (kind ∈ {volume, ec}, cross_rack ∈ {true, false}).
BALANCE_MOVES = _counter(
    "SeaweedFS_balance_moves_total",
    "rebalance moves executed, by kind (volume / ec shard group)",
    ("kind",))
BALANCE_BYTES_MOVED = _counter(
    "SeaweedFS_balance_bytes_moved_total",
    "bytes moved by rebalance, by rack locality of the hop",
    ("cross_rack",))
# Tiered-storage lifecycle plane (lifecycle/): every tier transition by
# its {from,to} edge — hot->ec (policy EC-encode), ec->remote (shard
# payload offload), remote->ec (promote-on-heat), ec->trash / remote->
# trash (DestroyTime reap) — and the bytes each edge moved. The tier
# label space is a tiny CLOSED set (lifecycle.TIERS); the registry lint
# enforces a ceiling on the pair like peer/bucket/tenant.
LIFECYCLE_TRANSITIONS = _counter(
    "SeaweedFS_lifecycle_transitions_total",
    "lifecycle tier transitions completed, by from/to tier",
    ("from", "to"))
LIFECYCLE_BYTES_MOVED = _counter(
    "SeaweedFS_lifecycle_bytes_moved_total",
    "bytes moved by lifecycle tier transitions, by from/to tier",
    ("from", "to"))
# Batched ingest plane (fid-range leases + bulk PUT): outstanding leases
# on the master (a drained system reads 0 — the bench-ingest smoke
# asserts it), the per-frame batching the /bulk handler actually sees
# (low percentiles = clients not amortizing), and client keep-alive
# pool reuse (a bulk workload should reuse ~every request).
FID_LEASES_ACTIVE = _gauge(
    "SeaweedFS_fid_leases_active",
    "fid-range leases granted by this master and not yet expired")
BULK_PUT_NEEDLES = _histogram(
    "SeaweedFS_bulk_put_needles",
    "needles per bulk PUT frame accepted by the volume server",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
HTTP_POOL_REUSE = _counter(
    "SeaweedFS_http_pool_reuse_total",
    "client HTTP requests served over a reused keep-alive connection")
# Read-path data plane (hot-needle cache + framed bulk GET): cache
# effectiveness (hit ratio = hits / (hits + misses)), eviction churn,
# resident bytes (delta-accounted so several caches in one process
# compose and the gauge can't scrape negative), and the per-frame
# batching the /bulk-read handler sees. GET latency exemplars live on
# SeaweedFS_volumeServer_request_seconds{type="get"}; the cache-status
# span attr links a traced GET to its hit/miss outcome.
READ_CACHE_HITS = _counter(
    "SeaweedFS_read_cache_hits_total",
    "volume-server reads served from the hot-needle cache")
READ_CACHE_MISSES = _counter(
    "SeaweedFS_read_cache_misses_total",
    "volume-server cache lookups that fell through to storage")
READ_CACHE_EVICTIONS = _counter(
    "SeaweedFS_read_cache_evictions_total",
    "needles evicted from the hot-needle cache to make room")
READ_CACHE_BYTES = _gauge(
    "SeaweedFS_read_cache_bytes",
    "bytes resident in hot-needle read caches")
BULK_READ_NEEDLES = _histogram(
    "SeaweedFS_bulk_read_needles",
    "needles per bulk-GET frame answered by the volume server",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
# Multi-tenant QoS plane (qos/scheduler.py): every admission decision
# per tenant/class (outcome: admitted = fast path, queued = granted
# after a WFQ wait, shed = refused with 503 + Retry-After), bytes
# charged through the token buckets, live queue depth, and how long
# queued requests waited (exemplar-linked so a throttled trace is one
# click away). The `tenant` label space is BOUNDED by the policy's
# max_tenants ceiling — the long tail shares the "~other" overflow
# bucket — which the registry lint enforces like peer/bucket.
QOS_REQUESTS = _counter(
    "SeaweedFS_qos_requests_total",
    "admission decisions by tenant, class and outcome "
    "(admitted/queued/shed)", ("tenant", "class", "outcome"))
QOS_BYTES = _counter(
    "SeaweedFS_qos_bytes_total",
    "bytes charged through qos token buckets", ("tenant", "class"))
QOS_QUEUE_DEPTH = _gauge(
    "SeaweedFS_qos_queue_depth",
    "requests queued in the qos scheduler right now", ("tenant",))
QOS_WAIT_SECONDS = _histogram(
    "SeaweedFS_qos_wait_seconds",
    "time queued requests waited before being granted", ("class",),
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
             2.5, 5.0, 10.0, 30.0))
# Fleet telemetry plane (telemetry/): per-stage wall time inside the
# volume server's request envelope. The stages are CONTIGUOUS segments
# of one perf_counter timeline (recv/parse -> auth/admit -> store ->
# serialize/flush), so per-{type} stage sums account for ~100% of
# SeaweedFS_volumeServer_request_seconds — the per-hop protocol
# breakdown the ROADMAP's protocol-ceiling teardown needs (BENCH_r05:
# 6.7 us store read under 93-139 us/hop). Microsecond-resolution
# buckets; exemplar-linked to /debug/traces via the shared Histogram
# plumbing. `stage` is a closed set the registry lint caps at the tier
# ceiling.
VOLUME_STAGE_SECONDS = _histogram(
    "SeaweedFS_volumeServer_stage_seconds",
    "volume request per-stage seconds (contiguous segments: recv/parse, "
    "queue_wait, auth/admit, store, serialize/flush)",
    ("type", "stage"),
    buckets=(0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025,
             0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.5, 1.0))
# Continuous profiling plane (profiling/): the always-on sampler's
# thread-sample counts by thread class and run state — the cheap
# "where do the threads sit" rollup (full folded stacks live at
# /debug/profile?mode=continuous, not in the registry). thread_class,
# state, pool and loop are all closed sets capped at the tier ceiling
# by stats/expo_lint.py.
PROFILE_SAMPLES = _counter(
    "SeaweedFS_profile_samples_total",
    "continuous-profiler thread samples by class and state",
    ("thread_class", "state"))
# Event-loop lag: how late a loop.call_later probe fired vs asked —
# pure event-loop queueing, the number that de-confounds the
# queueing-inflated recv_parse stage (profiling/lag.py).
EVENT_LOOP_LAG = _histogram(
    "SeaweedFS_event_loop_lag_seconds",
    "scheduled-callback probe lateness per event loop (loop queueing)",
    ("loop",),
    buckets=(0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
             0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0))
# Executor pool accounting (profiling/lag.MonitoredPool): queue depth
# (submitted-not-yet-started, gauge deltas so same-labelled pools in
# one process compose) and queue wait (submit -> worker pickup).
POOL_QUEUE_DEPTH = _gauge(
    "SeaweedFS_pool_queue_depth",
    "executor tasks submitted but not yet picked up, per pool",
    ("pool",))
POOL_QUEUE_WAIT = _histogram(
    "SeaweedFS_pool_queue_wait_seconds",
    "executor queue wait (submit to worker pickup) per pool",
    ("pool",),
    buckets=(0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
             0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0))
# Flight recorder (profiling/flight.py): admissions into the
# slow/errored request ring, by admission reason.
FLIGHT_RECORDS = _counter(
    "SeaweedFS_flight_records_total",
    "requests admitted to the flight-recorder ring (slow/error)",
    ("why",))
# Heavy hitters: the space-saving sketches' current top-k per dimension
# (kind: volume/tenant/method), refreshed at scrape time by a
# pre-scrape hook. Gauges, not counters — sketch keys get evicted and
# inherit counts, so values are top-k *estimates* (each key's
# guaranteed error rides the sketch, see telemetry/topk.py). Label
# cardinality is bounded by the sketch capacity (SWTPU_HOT_KEYS).
HOT_REQUESTS = _gauge(
    "SeaweedFS_hot_requests",
    "space-saving top-k request counts by dimension (volume/tenant/"
    "method)", ("kind", "key"))
HOT_BYTES = _gauge(
    "SeaweedFS_hot_bytes",
    "space-saving top-k byte counts by dimension (volume/tenant/"
    "method)", ("kind", "key"))
# SLO plane (telemetry/slo.py): burn rate per objective per evaluation
# window side (window label: "<pair>_long"/"<pair>_short"). Burn 1.0 =
# spending the error budget exactly at the sustainable rate; the
# policy's threshold per window pair is where slo.burn fires.
SLO_BURN_RATE = _gauge(
    "SeaweedFS_slo_burn_rate",
    "SLO error-budget burn rate per objective and evaluation window",
    ("slo", "window"))
# Leader-resident collector health: scrape outcomes and the live/stale
# split of its target set (stale ties into the health plane's
# nodes_stale signal — a node the collector can't scrape is a node
# whose series are marked, not dropped).
TELEMETRY_SCRAPES = _counter(
    "SeaweedFS_telemetry_scrapes_total",
    "fleet metric scrapes by the leader collector", ("outcome",))
TELEMETRY_TARGETS = _gauge(
    "SeaweedFS_telemetry_targets",
    "collector scrape targets by state (live/stale)", ("state",))


# Pre-scrape hooks: callables run (errors swallowed) before every
# scrape_payload render, for families mirroring external structures —
# the heavy-hitter sketches register their gauge refresh here so every
# exposition carries the sketch's current top-k.
_SCRAPE_HOOKS: list = []


def register_scrape_hook(fn) -> None:
    if fn not in _SCRAPE_HOOKS:
        _SCRAPE_HOOKS.append(fn)


def scrape_payload(accept: str = "") -> tuple[str, str]:
    """(body, content_type) for a /metrics response, negotiated on the
    scraper's Accept header: OpenMetrics (with trace exemplars) when
    requested, else the Prometheus text format with the strict
    `version=0.0.4` parameter scrapers require."""
    for hook in list(_SCRAPE_HOOKS):
        try:
            hook()
        except Exception as e:  # noqa: BLE001 — a hook must never break a scrape
            log.warning("scrape hook %s failed: %s", hook, e)
    if "application/openmetrics-text" in (accept or ""):
        return REGISTRY.gather(openmetrics=True), OPENMETRICS_CONTENT_TYPE
    return REGISTRY.gather(), PROM_CONTENT_TYPE


async def aiohttp_metrics_handler(request):
    """Shared /metrics handler for the aiohttp-based servers."""
    from aiohttp import web
    body, ctype = scrape_payload(request.headers.get("Accept", ""))
    return web.Response(body=body.encode(),
                        headers={"Content-Type": ctype})


class PushLoop:
    """Handle for a running push-gateway loop: `stop()` sets the event
    AND joins the thread, so server shutdown paths can tear it down
    deterministically instead of leaking a daemon thread mid-PUT."""

    def __init__(self, thread: threading.Thread, stop_event: threading.Event):
        self.thread = thread
        self._stop = stop_event

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self.thread.is_alive():
            self.thread.join(timeout)

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def is_alive(self) -> bool:
        return self.thread.is_alive()


def start_push_loop(gateway_url: str, job: str, interval_seconds: int = 15,
                    registry: Registry = REGISTRY,
                    stop_event: threading.Event | None = None) -> PushLoop:
    """Push-gateway loop (reference metrics.go:306 LoopPushingMetric).
    Returns a PushLoop whose stop() joins the thread — callers' shutdown
    paths (master/volume/filer stop()) use it."""
    stop = stop_event or threading.Event()

    def loop():
        url = f"{gateway_url.rstrip('/')}/metrics/job/{job}"
        while not stop.wait(interval_seconds):
            try:
                req = urllib.request.Request(
                    url, data=registry.gather().encode(), method="PUT",
                    headers={"Content-Type": PROM_CONTENT_TYPE})
                urllib.request.urlopen(req, timeout=5)
            except Exception as e:  # noqa: BLE001
                log.warning("metrics push to %s: %s", gateway_url, e)

    t = threading.Thread(target=loop, daemon=True, name="metrics-push")
    t.start()
    return PushLoop(t, stop)
