"""Per GET answered, the volume servers' CPU milliseconds in the HTTP
plane's threads: classes `event_loop` (the loop thread: receive, parse,
answer) and `read_pool` (the GET handlers, whose store stage runs a
needle read's local shard reads, the .ecx search and a lone remote run)
of SeaweedFS_process_thread_cpu_seconds_total (weedbench/thread_cpu.py)."""

from weedbench import thread_cpu


def read(run):
    return thread_cpu.per_get_ms(run, "event_loop", "read_pool")
