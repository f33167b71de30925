"""Per survivor fetch, on the fetching server: the calling thread's own
CPU milliseconds across the fetch, SeaweedFS_ec_shard_fetch_cpu_seconds
{role="survivor"} (time.thread_time()), from the _sum and _count deltas of
every live server's /metrics across the window. The fetch's wall time
less this is the time its thread waited: on the peer, the network, the
GIL or a CPU."""

from weedbench import promstat

NAME = "SeaweedFS_ec_shard_fetch_cpu_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", role="survivor")
        n += promstat.total(series, NAME + "_count", role="survivor")
    return s / n * 1e3 if n else None
