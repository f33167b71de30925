"""Per gRPC call a volume server accepts, the wait for one of its
`grpc-worker` threads: milliseconds in
SeaweedFS_pool_queue_wait_seconds{pool="grpc"} (the submit on the gRPC
server's pool to the worker's start, before any handler's own timer such
as `ec.serve` starts), from the _sum and _count deltas of every live
server's /metrics across the window."""

from weedbench import promstat

NAME = "SeaweedFS_pool_queue_wait_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", pool="grpc")
        n += promstat.total(series, NAME + "_count", pool="grpc")
    return s / n * 1e3 if n else None
