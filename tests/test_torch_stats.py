"""The port's stats registry (seaweedfs_tpu_torch/stats/) against the JAX
package's: the same families, types, label names, help text and buckets;
fresh registries given the same metrics and increments render the same
text, which the port's expo_lint passes; and the metric hooks of the
ported EC paths — encode_volumes, rebuild_shards, the repair counter, the
read cache and the degraded read — move the same counters by the same
amounts as the reference's on the same inputs, measured as deltas (the
module-wide registries carry counts of earlier tests in the process).

The coder label is the coder's class name, which differs between the
packages on the device path (TorchCoder here, JaxCoder there), so amounts
are compared per operation."""

import concurrent.futures as cf
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec import stream as ref_stream
from seaweedfs_tpu.ec.locate import EcGeometry as RefGeo
from seaweedfs_tpu.ops.coder import JaxCoder
from seaweedfs_tpu.ops.coder import NumpyCoder as RefNumpyCoder
from seaweedfs_tpu.stats import expo_lint as ref_lint
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.stats import parse as ref_parse
from seaweedfs_tpu.storage import read_cache as ref_read_cache
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import encoder, files, stream
from seaweedfs_tpu_torch.ec.locate import EcGeometry
from seaweedfs_tpu_torch.ops.coder import NumpyCoder, TorchCoder
from seaweedfs_tpu_torch.server.volume_server import make_shard_reader
from seaweedfs_tpu_torch.stats import expo_lint, metrics, parse
from seaweedfs_tpu_torch.storage import read_cache
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store

GEO = EcGeometry(d=4, p=2, large_block=4096, small_block=512)
REF_GEO = RefGeo(d=4, p=2, large_block=4096, small_block=512)


def _family(m):
    return (type(m).__name__, m.name, m.kind, m.help, m.label_names,
            getattr(m, "buckets", None))


# the port's own families, which the JAX package has no counterpart of:
# the degraded EC read's stage histograms, a shard fetch divided, and the
# process's thread CPU by class
PORT_ONLY = ("SeaweedFS_ec_degraded_read_seconds",
             "SeaweedFS_ec_shard_fetch_cpu_seconds",
             "SeaweedFS_ec_shard_fetch_phase_seconds",
             "SeaweedFS_ec_shard_fetch_seconds",
             "SeaweedFS_ec_shard_serve_seconds",
             "SeaweedFS_process_thread_cpu_seconds_total")
PORT_ONLY_NAMES = ("EC_DEGRADED_READ_SECONDS", "EC_SHARD_FETCH_SECONDS",
                   "EC_SHARD_FETCH_PHASE_SECONDS",
                   "EC_SHARD_FETCH_CPU_SECONDS", "EC_SHARD_SERVE_SECONDS",
                   "PROCESS_THREAD_CPU")


def test_registry_families_match_reference():
    fams = [_family(m) for m in stats.REGISTRY.metrics()]
    got = [f for f in fams if f[1] not in PORT_ONLY]
    want = [_family(m) for m in ref_stats.REGISTRY.metrics()]
    assert got == want and len(got) > 50
    assert sorted(f[1] for f in fams if f[1] in PORT_ONLY) == list(PORT_ONLY)
    assert [n for n in stats.__all__ if n not in PORT_ONLY_NAMES] == \
        ref_stats.__all__
    assert set(PORT_ONLY_NAMES) <= set(stats.__all__)
    assert (stats.PROM_CONTENT_TYPE, stats.OPENMETRICS_CONTENT_TYPE) == \
        (ref_stats.PROM_CONTENT_TYPE, ref_stats.OPENMETRICS_CONTENT_TYPE)


def _populate(mod):
    """The same metrics and increments on a fresh Registry of `mod`."""
    reg = mod.Registry()
    c = reg.register(mod.Counter("t_requests_total", "requests", ("type", "code")))
    legacy = reg.register(mod.Counter("t_legacy", "no _total suffix"))
    g = reg.register(mod.Gauge("t_depth", "queue depth", ("pool",)))
    h = reg.register(mod.Histogram("t_seconds", "latency", ("op",),
                                   buckets=(0.001, 0.01, 0.1, 1.0)))
    reg.register(mod.Counter("t_unused_total", "never incremented"))
    c.inc("get", "200")
    c.inc("get", "200", amount=2.5)
    c.inc('put"\n\\', "500")  # escaped label value
    legacy.inc()
    g.set("ec", value=7)
    g.add("ec", amount=-2)
    g.add("other", amount=3)
    for v in (0.0005, 0.005, 0.05, 0.5, 5.0):
        h.observe("read", value=v, trace_id="")
    h.observe("write", value=0.02, trace_id="")
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
def test_fresh_registries_render_the_same_text(openmetrics):
    got = _populate(metrics).gather(openmetrics=openmetrics)
    want = _populate(ref_metrics).gather(openmetrics=openmetrics)
    assert got == want
    assert expo_lint.check_exposition(got) == ref_lint.check_exposition(want)
    assert _families(parse.parse_exposition(got)) == \
        _families(ref_parse.parse_exposition(want))


def _families(parsed):
    return {k: (f.name, f.kind, f.help, [tuple(s) for s in f.samples])
            for k, f in parsed.items()}


def test_module_registry_passes_the_lint(capsys):
    for om in (False, True):
        expo_lint.check_exposition(stats.REGISTRY.gather(openmetrics=om))
    assert expo_lint.lint_registry() == []
    assert expo_lint.main([]) == 0
    assert "registry: clean" in capsys.readouterr().out
    body, ctype = metrics.scrape_payload("application/openmetrics-text")
    assert ctype == stats.OPENMETRICS_CONTENT_TYPE and body.endswith("# EOF\n")


def _snap(mod):
    """Current values of every counter the EC hooks move."""
    s = mod
    out = {}
    for m in (s.EC_ENCODE_BYTES, s.EC_REBUILD_BYTES, s.REPAIR_BYTES_READ,
              s.REPAIR_BYTES_WRITTEN):
        with m._lock:
            out[m.name] = dict(m._values)
    with s.EC_PIPELINE_SECONDS._lock:
        out["stages"] = dict(s.EC_PIPELINE_SECONDS._totals)
    out["queue"] = s.EC_WRITER_QUEUE_DEPTH.value()
    return out


def _delta(before, after):
    out = {}
    for name in after:
        if name == "queue":
            out[name] = after[name] - before[name]
            continue
        out[name] = {k: v - before[name].get(k, 0)
                     for k, v in after[name].items()
                     if v != before[name].get(k, 0)}
    return out


def _jobs(tmp, tag, srcs):
    return [(src, str(tmp / f"{tag}{i}"), None) for i, src in enumerate(srcs)]


def _sources(tmp):
    rng = np.random.default_rng(11)
    srcs = []
    for i, size in enumerate((100, GEO.large_block * GEO.d + 5, 9000)):
        path = tmp / f"src{i}.dat"
        path.write_bytes(rng.bytes(size))
        srcs.append(str(path))
    return srcs


@pytest.mark.parametrize("path", ["sync", "async"])
def test_encode_and_rebuild_hooks_move_counters_like_reference(tmp_path, path):
    """One encode_volumes and one rebuild_shards in each package, on the
    same volumes: equal deltas of EC_ENCODE_BYTES, EC_REBUILD_BYTES,
    REPAIR_BYTES_* and EC_PIPELINE_SECONDS observations (sync: NumpyCoder
    in both, the same label; async: TorchCoder on the CPU against the
    JAX package's JaxCoder), the writer gauge back where it was, and the
    same span names with the same attribute keys."""
    from seaweedfs_tpu import tracing as ref_tracing
    from seaweedfs_tpu_torch import tracing
    srcs = _sources(tmp_path)
    if path == "sync":
        port_coder, ref_coder = NumpyCoder(4, 2), RefNumpyCoder(4, 2)
    else:
        port_coder, ref_coder = TorchCoder(4, 2, device="cpu"), JaxCoder(4, 2)
    deltas, spans = [], []
    for mod, strm, enc, geo, coder, trc, tag in (
            (stats, stream, encoder, GEO, port_coder, tracing, "port"),
            (ref_stats, ref_stream, ref_encoder, REF_GEO, ref_coder,
             ref_tracing, "ref")):
        trc.configure(sample=1.0)
        # the spans already buffered, by id: a ring buffer left full by
        # earlier tests keeps its length while the new spans go in
        seen = {d["span_id"] for d in trc.BUFFER.snapshot(limit=5000)}
        before = _snap(mod)
        strm.encode_volumes(_jobs(tmp_path, tag, srcs), geo, coder, batch=4)
        base = str(tmp_path / f"{tag}1")
        for s in (0, 5):
            os.unlink(base + files.shard_ext(s))
        assert enc.rebuild_shards(base, geo, coder, chunk=512, batch=4) == [0, 5]
        deltas.append(_delta(before, _snap(mod)))
        new = [d for d in trc.BUFFER.snapshot(limit=5000)
               if d["span_id"] not in seen]
        spans.append({s["name"]: sorted(s["attrs"]) for s in new
                      if s["name"] in ("ec.encode", "ec.rebuild")})
    got, want = deltas
    label = type(port_coder).__name__
    ref_label = type(ref_coder).__name__
    for name in ("SeaweedFS_ec_encode_bytes_total",
                 "SeaweedFS_ec_rebuild_bytes_total"):
        assert list(got[name]) == [(label,)] and list(want[name]) == [(ref_label,)]
        assert got[name][(label,)] == want[name][(ref_label,)] > 0
    for name in ("SeaweedFS_repair_bytes_read_total",
                 "SeaweedFS_repair_bytes_written_total", "stages"):
        assert got[name] == want[name] and got[name]
    assert got["stages"] == {(s,): 1 for s in ("fill", "dispatch", "drain", "write")}
    assert got["queue"] == want["queue"] == 0
    assert spans[0] == spans[1] and set(spans[0]) == {"ec.encode", "ec.rebuild"}


def test_read_cache_hooks_match_reference():
    """The same gets, puts, overwrites and invalidations on a port and a
    reference ReadCache move hits, misses, evictions and resident bytes by
    the same amounts."""
    from seaweedfs_tpu.storage.needle import Needle as RefNeedle
    deltas = []
    for mod, rc, needle in ((stats, read_cache, Needle),
                            (ref_stats, ref_read_cache, RefNeedle)):
        fams = (mod.READ_CACHE_HITS, mod.READ_CACHE_MISSES,
                mod.READ_CACHE_EVICTIONS, mod.READ_CACHE_BYTES)
        before = [f.value() for f in fams]
        cache = rc.ReadCache(4096, max_obj_bytes=2048)
        for i in range(12):
            n = needle(id=i, cookie=7, data=bytes(300 + 10 * i))
            cache.put(1, i, n, cache.epoch(1))
            cache.get(1, i, cookie=7)
            cache.get(1, i, cookie=8)   # a cookie mismatch is a miss
            cache.get(1, i + 100)
        cache.invalidate(1, 11)
        cache.invalidate(1)
        cache.put(2, 1, needle(id=1, cookie=1, data=bytes(500)), cache.epoch(2))
        deltas.append([f.value() - b for f, b in zip(fams, before)])
        cache.clear()
    assert deltas[0] == deltas[1]
    hits, misses, evictions, resident = deltas[0]
    assert hits > 0 and misses > 0 and evictions > 0 and resident > 0


def test_degraded_read_counts_degraded_ec_reads(tmp_path):
    """make_shard_reader moves SeaweedFS_degraded_ec_reads_total by the
    reconstructs its stats= dict counts, one per degraded interval."""
    geo = EcGeometry(d=10, p=4, large_block=8192, small_block=1024)
    store = Store("127.0.0.1", 0, "", [DiskLocation(str(tmp_path / "a"))],
                  ec_geometry=geo, coder_name="torch", device="cpu")
    try:
        store.add_volume(3)
        rng = np.random.default_rng(3)
        want = {i: rng.bytes(int(rng.integers(0, 3000))) for i in range(1, 61)}
        store.write_needles_bulk(3, [Needle(id=i, cookie=9, data=d)
                                     for i, d in want.items()])
        store.find_volume(3).sync()
        base = store.generate_ec_shards(3)
        store.delete_volume(3)
        for s in (0, 5):
            os.unlink(base + files.shard_ext(s))
        store.mount_ec_shards(3)
        before = stats.DEGRADED_EC_READS.value()
        counts = {}
        with cf.ThreadPoolExecutor(2) as pool:
            reader = make_shard_reader(store, 3, lambda sid, off, ln: None,
                                       pool, stats=counts)
            for nid, data in want.items():
                assert store.read_needle(3, nid, cookie=9,
                                         shard_reader=reader).data == data
        assert counts["reconstructs"] > 0
        assert stats.DEGRADED_EC_READS.value() - before == counts["reconstructs"]
    finally:
        store.close()
        shutil.rmtree(tmp_path / "a", ignore_errors=True)
