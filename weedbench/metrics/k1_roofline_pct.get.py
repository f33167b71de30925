"""Kernel K1's share of its roofline on the GETs' reconstructs: the least
time the reconstructs need at the card's memory bandwidth, over K1's
kernel time in the servers' traces (rs_gf_apply_kernel).

The bytes come from the reference's stripe map applied to the GETs the
window answered: every run of a needle's record on a lost shard reads
its d survivor intervals once and writes the rebuilt interval once,
however the program batches them."""

from weedbench import peaks, traces
from weedbench.kinds.paced_get import geometry
from weedbench.reference import needles, stripes


def read(run):
    rate = peaks.hbm_bytes_per_s(run.device_kind)
    k1_s = traces.kernel_time(run.traces, "rs_gf_apply")
    if rate is None or not k1_s:
        return None
    g = run.data["gets"]
    done = g["g"][(g["t1"] <= run.t_end) & (g["status"] == 200)]
    geo = geometry(run.cfg)
    lost = set(run.data["lost_shards"])
    vols, first = run.data["vols"], run.data["first"]
    import numpy as np
    offs = [v.offsets() for v in vols]
    need = 0
    for gi in done.tolist():
        vi = int(np.searchsorted(first, gi, side="right") - 1)
        v, k = vols[vi], gi - int(first[vi])
        rec = needles.record_size(int(v.sizes[k]))
        for shard, _, size in stripes.runs(geo, v.dat_size(),
                                           int(offs[vi][k]), rec):
            if shard in lost:
                need += (geo.d + 1) * size
    return 100.0 * need / rate / k1_s if need else None
