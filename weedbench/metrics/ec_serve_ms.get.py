"""Per shard range a peer answers: milliseconds in
SeaweedFS_ec_shard_serve_seconds{kind="range"} (VolumeEcShardRead on the
serving server, from entry to the stream's end: the preads and the gRPC
stream's flow control), from the _sum and _count deltas of every live
server's /metrics across the window. The trace's range of it is
`ec.serve`."""

from weedbench import promstat

NAME = "SeaweedFS_ec_shard_serve_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", kind="range")
        n += promstat.total(series, NAME + "_count", kind="range")
    return s / n * 1e3 if n else None
