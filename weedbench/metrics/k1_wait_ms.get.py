"""Per degraded interval, the host blocked on K1's result: milliseconds
in SeaweedFS_ec_degraded_read_seconds{phase="wait"} (the wait on the D2H
copy's event), from the _sum and _count deltas of every live server's
/metrics across the window. The trace's range of it is `k1.wait`."""

from weedbench import promstat

NAME = "SeaweedFS_ec_degraded_read_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", phase="wait")
        n += promstat.total(series, NAME + "_count", phase="wait")
    return s / n * 1e3 if n else None
