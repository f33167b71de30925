"""Per GET, the volume servers' HTTP plane: milliseconds in every stage
of SeaweedFS_volumeServer_stage_seconds{type="get"} but `store` (recv and
parse, queue wait, admission, serialize and flush), from the _sum and
_count deltas of every live server's /metrics across the window."""

from weedbench import promstat

NAME = "SeaweedFS_volumeServer_stage_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", type="get", stage="!store")
        n += promstat.total(series, NAME + "_count", type="get",
                            stage="store")
    return s / n * 1e3 if n else None
