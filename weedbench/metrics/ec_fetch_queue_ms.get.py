"""Per survivor fetch queued on the ec_read pool, on the fetching server:
milliseconds in SeaweedFS_pool_queue_wait_seconds{pool="ec_read"} (the
submit on the pool to the pool thread's start, before the fetch's own
timer starts), from the _sum and _count deltas of every live server's
/metrics across the window. In a plain RS gather the tasks on that pool
are the remote survivors' fetches, one each (local survivors are read
inline), and one for each other lost shard, which finds no holder and
ends at once: it waited for a thread as the fetches beside it did."""

from weedbench import promstat

NAME = "SeaweedFS_pool_queue_wait_seconds"


def read(run):
    s = n = 0.0
    for series in run.scrape_delta.values():
        s += promstat.total(series, NAME + "_sum", pool="ec_read")
        n += promstat.total(series, NAME + "_count", pool="ec_read")
    return s / n * 1e3 if n else None
