"""Per remote shard fetch, on the fetching server: milliseconds in
SeaweedFS_ec_shard_fetch_seconds (one a fetch that tried a holder, on the
calling thread, from the call to the last byte, failed holders included:
a degraded interval's survivors and a healthy interval's shard held
elsewhere), from the _sum and _count deltas of every live server's
/metrics across the window. The trace's range of it is `ec.fetch`."""

from weedbench import promstat

NAME = "SeaweedFS_ec_shard_fetch_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum")
        n += promstat.total(series, NAME + "_count")
    return s / n * 1e3 if n else None
