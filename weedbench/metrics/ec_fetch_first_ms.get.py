"""Per survivor fetch, on the fetching server: milliseconds in
SeaweedFS_ec_shard_fetch_phase_seconds{role="survivor", phase="first"}
(the call issued to the first response message in hand on the calling
thread; `rest`, the first message to the joined bytes, makes up the
fetch's SeaweedFS_ec_shard_fetch_seconds), from the _sum and _count
deltas of every live server's /metrics across the window. The trace's
range of it is `ec.fetch.first`."""

from weedbench import promstat

NAME = "SeaweedFS_ec_shard_fetch_phase_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", role="survivor",
                            phase="first")
        n += promstat.total(series, NAME + "_count", role="survivor",
                            phase="first")
    return s / n * 1e3 if n else None
