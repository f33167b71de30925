"""Per degraded interval, the survivor gather inside the store stage:
milliseconds in SeaweedFS_ec_degraded_read_seconds{phase="gather"} (from
the reconstruct's start to d survivors in hand: local reads, the remote
fetches and the ec_read pool's waits), from the _sum and _count deltas of
every live server's /metrics across the window. The trace's range of it
is `ec.gather`."""

from weedbench import promstat

NAME = "SeaweedFS_ec_degraded_read_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", phase="gather")
        n += promstat.total(series, NAME + "_count", phase="gather")
    return s / n * 1e3 if n else None
