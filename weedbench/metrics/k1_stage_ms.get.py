"""Per degraded interval, kernel K1's host side before the wait:
milliseconds in SeaweedFS_ec_degraded_read_seconds{phase="stage"} (the
host stack of the survivors into pageable memory, the H2D enqueue from
it, the K1 launch and the D2H enqueue), from the _sum and _count deltas
of every live server's /metrics across the window. The trace's range of
it is `k1.stage`."""

from weedbench import promstat

NAME = "SeaweedFS_ec_degraded_read_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", phase="stage")
        n += promstat.total(series, NAME + "_count", phase="stage")
    return s / n * 1e3 if n else None
