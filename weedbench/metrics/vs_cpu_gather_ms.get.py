"""Per GET answered, the volume servers' CPU milliseconds in the threads
of the degraded gather: classes `ec_read` (the ec_read pool's survivor
fetches) and `ec_run` (an EC needle read's per-read fan-out: the direct
fetches, the reconstruct's gather, K1's staging and wait), of
SeaweedFS_process_thread_cpu_seconds_total (weedbench/thread_cpu.py)."""

from weedbench import thread_cpu


def read(run):
    return thread_cpu.per_get_ms(run, "ec_read", "ec_run")
